"""The DGPE cost model (paper Sec. III-B, Eq. (4)-(9)).

All evaluation is vectorized numpy over an assignment vector
``assign[v] in [0, m)`` (the dense encoding of the binary layout x_vi).

    C   = C_U + C_P + C_T + C_M                                   (Eq. 9)
    C_U = sum_i sum_v  mu[v,i] x_vi                               (Eq. 4)
    C_P = sum_i sum_v  C_P(v,i) x_vi                              (Eq. 6)
          C_P(v,i) = sum_k alpha_i |N_v| s_{k-1}
                     + beta_i s_{k-1} s_k + gamma_i s_k           (Eq. 5)
    C_T = sum_ij sum_uv tau[i,j] e_uv w_ij x_vi x_uj              (Eq. 7)
    C_M = sum_i ( sum_v rho_i x_vi + eps_i )                      (Eq. 8)

The decomposition C = C0 + C1 + C2 (Thm 2: constant / linear / quadratic
pseudo-boolean terms) is exposed as ``unary`` (C1 coefficient matrix) and the
edge-wise quadratic evaluation — GLAD's auxiliary graphs are built directly
from these.

The port's copy of ``repro.core.cost``, with ``repro`` renamed ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from repro_torch.graphs.datagraph import DataGraph
from repro_torch.graphs.edgenet import EdgeNetwork


@dataclasses.dataclass
class Replication:
    """A set of read-only replica placements ON TOP of an assignment.

    ``by_part[p]`` holds the vertex ids replicated INTO partition p (sorted
    ascending, never including vertices homed on p — a replica of a resident
    is meaningless).  Replication is a *unary* overlay on a fixed cut: each
    (v -> p) decision trades the saved directed read traffic from v's home
    into p against a one-time sync + storage charge, independently of every
    other replica — so the greedy that accepts all positive-gain candidates
    is exact for the overlay subproblem (the cut itself is GLAD's job).
    """

    by_part: Dict[int, np.ndarray]
    gain: float                       # total objective improvement (>= 0)
    saved: float                      # read traffic no longer crossing links
    sync: float                       # sum sync_weight * tau[home, p]
    storage: float                    # count * storage_cost
    sync_weight: float
    storage_cost: float

    @property
    def count(self) -> int:
        return int(sum(len(v) for v in self.by_part.values()))

    def pairs(self) -> np.ndarray:
        """(k, 2) array of (vertex, part) placements, part-major sorted."""
        out = [np.stack([ids, np.full(len(ids), p, dtype=np.int64)], axis=1)
               for p, ids in sorted(self.by_part.items()) if len(ids)]
        return (np.concatenate(out, axis=0) if out
                else np.zeros((0, 2), dtype=np.int64))


@dataclasses.dataclass(frozen=True)
class GNNWorkload:
    """Feature-dim schedule of the served GNN: s = [s_0, .., s_K] (Sec. II-A).

    ``agg_ops / upd_ops / act_ops`` let different models (GCN/GAT/SAGE) scale
    the three Eq.-(5) terms: e.g. GAT's attention adds per-link work (folded
    into the aggregation coefficient), SAGE's concat doubles the update GEMM.
    """

    layer_dims: Sequence[int]          # [s_0, s_1, ..., s_K]
    agg_scale: float = 1.0
    upd_scale: float = 1.0
    act_scale: float = 1.0
    name: str = "gcn"

    @property
    def agg_units(self) -> float:
        # sum_k s_{k-1}: per-neighbor vector-add elements across layers.
        return self.agg_scale * float(sum(self.layer_dims[:-1]))

    @property
    def upd_units(self) -> float:
        # sum_k s_{k-1} * s_k: matvec MACs across layers.
        return self.upd_scale * float(
            sum(a * b for a, b in zip(self.layer_dims[:-1], self.layer_dims[1:]))
        )

    @property
    def act_units(self) -> float:
        # sum_k s_k: activation elements across layers.
        return self.act_scale * float(sum(self.layer_dims[1:]))


def workload_for(model: str, in_dim: int, hidden: int = 16, out_dim: int = 2,
                 layers: int = 2) -> GNNWorkload:
    """Paper Sec. VI-A model zoo: 2-layer GCN/GAT/GraphSAGE, hidden=16."""
    dims = [in_dim] + [hidden] * (layers - 1) + [out_dim]
    model = model.lower()
    if model == "gcn":
        return GNNWorkload(dims, 1.0, 1.0, 1.0, "gcn")
    if model == "gat":
        # attention: extra per-neighbor weighting + per-link score matvecs.
        return GNNWorkload(dims, 2.0, 1.25, 1.0, "gat")
    if model in ("sage", "graphsage"):
        # mean aggregation (divide folded into act), concat doubles update GEMM
        # but SAGE aggregates neighbors only (no self in sum) -> lighter agg.
        return GNNWorkload(dims, 0.75, 2.0, 1.0, "sage")
    raise ValueError(f"unknown GNN model {model!r}")


@dataclasses.dataclass
class ModelDiff:
    """What changed between two CostModels over the same fleet (m equal,
    graph grown or equal).  Consumed by ``PairCutEngine.rebind`` to bump
    per-vertex / per-server epochs so only genuinely-affected cache entries
    and warm-start residuals are invalidated across slots.

    ``unary_rows``      vertices whose unary row changed in a sparse set of
                        server columns (each needs a theta re-gather);
    ``servers``         servers whose whole unary column or tau row changed
                        (degrade / kill: every pair touching them rebuilds);
    ``tau_pairs``       (m, m) bool of CHANGED tau entries, or None — a tau
                        change alters internal arc capacities, which theta
                        patches never repair, so affected pairs must
                        reassemble from scratch;
    ``tau_cols``        servers j with sparse tau-column changes: vertices
                        assigned to j impose new arc prices on their
                        neighbors' pair problems;
    ``struct_vertices`` endpoints of inserted/deleted/reweighted links plus
                        brand-new vertices (membership arrays stale).
    """

    unary_rows: np.ndarray
    servers: np.ndarray
    tau_pairs: "np.ndarray | None"
    tau_cols: np.ndarray
    struct_vertices: np.ndarray


class CostModel:
    """Vectorized evaluator of the four cost factors for a (net, graph, gnn).

    Structural contract (Thm 2, relied on by ``repro_torch.core.multilevel``):
    every vertex-separable term of the objective lives in :attr:`unary`
    (mu + C_P + rho), the only pairwise term is the tau-weighted link sum,
    and the only data-independent term is :attr:`constant` (sum eps).  So
    ``total(a) == unary[arange(n), a].sum() + tau-link-sum + constant``,
    which is what makes the multilevel coarse models EXACT: summing unary
    rows per cluster into the coarse mu (alpha/beta/gamma/rho zeroed so
    nothing double counts) and summing parallel edge weights preserves the
    objective of every projected assignment, since intra-cluster links
    land on the tau diagonal (zero)."""

    def __init__(self, net: EdgeNetwork, graph: DataGraph, gnn: GNNWorkload,
                 traffic: "np.ndarray | None" = None):
        # Graph evolution can add clients the fleet has no upload entry for
        # yet (Sec. V-A): derive mu for them from coordinates when present,
        # else charge the fleet-average upload cost.  The padded mu lives on
        # a shallow copy — the caller's EdgeNetwork (often shared between
        # several CostModels over different graph snapshots) is never
        # mutated.
        if net.mu.shape[0] < graph.n:
            extra = graph.n - net.mu.shape[0]
            if graph.coords is not None and net.coords is not None:
                d = np.linalg.norm(
                    graph.coords[net.mu.shape[0]:, None, :]
                    - net.coords[None, :, :], axis=-1)
                new_mu = d * (net.mu.mean() / max(d.mean(), 1e-9))
            else:
                new_mu = np.tile(net.mu.mean(0, keepdims=True), (extra, 1))
            mu = np.concatenate([net.mu, new_mu], axis=0)
        else:
            # Own a copy regardless: the layout engine's caches (LayoutState
            # unary picks, AssemblyCache theta vectors) embed mu-derived
            # values, so a caller mutating its mu array after construction
            # must not be able to desynchronize them.
            mu = np.array(net.mu, dtype=np.float64)
        mu.setflags(write=False)
        self.net = dataclasses.replace(net, mu=mu)
        self.graph = graph
        self.gnn = gnn
        # Per-vertex request rate (requests/vertex, Sec. II-A's stream
        # workload): scales the vertex's COMPUTE row C_P(v, ·) — a vertex
        # serving r times as many requests costs r times the per-inference
        # work on whichever server hosts it.  Upload (one-time residency),
        # tau (per-link sync, already per-BSP-round) and maintenance are
        # NOT scaled.  None = traffic-blind (the repo's historical
        # behavior, bit-identical).  Normalize to mean 1 (see
        # ``repro_torch.gnn.serving.request_traffic``) to keep the C_P scale
        # comparable across traffic-aware and traffic-blind layouts.
        if traffic is not None:
            traffic = np.asarray(traffic, dtype=np.float64).copy()
            if traffic.shape != (graph.n,):
                if traffic.shape[0] < graph.n:
                    # Evolution can add vertices after the window the
                    # traffic histogram was measured on: neutral weight.
                    traffic = np.concatenate(
                        [traffic, np.ones(graph.n - traffic.shape[0])])
                else:
                    raise ValueError(
                        f"traffic shape {traffic.shape} != ({graph.n},)")
            if (traffic < 0).any():
                raise ValueError("traffic weights must be non-negative")
            traffic.setflags(write=False)
        self.traffic = traffic
        self._unary = None

    # ------------------------------------------------------------ components
    @property
    def cp_matrix(self) -> np.ndarray:
        """C_P(v, i) per Eq. (5): (n, m).  With :attr:`traffic` set, row v is
        scaled by the vertex's request rate (serving workload, Sec. II-A)."""
        deg = self.graph.degrees.astype(np.float64)  # |N_v|
        net, g = self.net, self.gnn
        out = (
            np.outer(deg, net.alpha) * g.agg_units
            + net.beta[None, :] * g.upd_units
            + net.gamma[None, :] * g.act_units
        )
        if self.traffic is not None:
            out *= self.traffic[:, None]
        return out

    @property
    def unary(self) -> np.ndarray:
        """C1 coefficients (Thm 2): unary[v,i] = mu + C_P(v,i) + rho_i.
        Frozen: every cached delta in the engine is derived from it, so
        in-place edits would silently corrupt them — copy to modify."""
        if self._unary is None:
            self._unary = self.net.mu + self.cp_matrix + self.net.rho[None, :]
            self._unary.setflags(write=False)
        return self._unary

    def release_unary(self) -> None:
        """Drop the cached :attr:`unary` matrix.  It is a deterministic
        elementwise function of (mu, degrees, gnn coefficients, traffic),
        so the next access rebuilds it bitwise identical — callers that
        copied values out (engine picks, assembly deltas) are untouched.
        The streamed coarsening build releases each level's unary once the
        level is contracted: a coarse model's unary duplicates its mu
        (compute/maintenance coefficients are zeroed), so the cache is
        pure resident redundancy across a retained hierarchy."""
        self._unary = None

    @property
    def constant(self) -> float:
        """C0 (Thm 2): data-independent maintenance sum_i eps_i."""
        return float(self.net.eps.sum())

    def tau_ref(self) -> float:
        """Mean inter-server transmission coefficient over CONNECTED pairs
        — the traffic scale one link unit can cost.  Used by the multilevel
        matcher's mu gate (a merge commits both endpoints to one server, so
        candidates whose unary disagreement exceeds what the merged link
        could save at this scale are pruned) and usable as a drift scale
        anywhere a single tau number is needed."""
        p = self.net.pairs
        if not len(p):
            return 0.0
        return float(self.net.tau[p[:, 0], p[:, 1]].mean())

    # ------------------------------------------------------------- evaluation
    def factors(self, assign: np.ndarray) -> Dict[str, float]:
        assign = np.asarray(assign, dtype=np.int64)
        n = self.graph.n
        net = self.net
        cu = float(net.mu[np.arange(n), assign].sum())
        cp = float(self.cp_matrix[np.arange(n), assign].sum())
        e = self.graph.edges
        if len(e):
            w = self.graph.weights_or_ones()
            ct = float((net.tau[assign[e[:, 0]], assign[e[:, 1]]] * w).sum())
        else:
            ct = 0.0
        cm = float(net.rho[assign].sum() + net.eps.sum())
        return {"C_U": cu, "C_P": cp, "C_T": ct, "C_M": cm,
                "total": cu + cp + ct + cm}

    def total(self, assign: np.ndarray) -> float:
        return self.factors(assign)["total"]

    def traffic_bytes(self, assign: np.ndarray, feat_bytes: int) -> float:
        """Physical bytes crossing servers under BSP (for runtime validation:
        cut links x per-layer feature bytes x layers)."""
        e = self.graph.edges
        if not len(e):
            return 0.0
        cut = assign[e[:, 0]] != assign[e[:, 1]]
        return float(cut.sum()) * 2 * feat_bytes * (len(self.gnn.layer_dims) - 1)

    # --------------------------------------------------- marginal quantities
    def marginal_all(
        self, placed: np.ndarray, assign: np.ndarray, v: int
    ) -> np.ndarray:
        """Incremental placement cost of vertex v at EVERY server, given the
        subset mask ``placed`` with layout ``assign``: (m,) vector.

        Vectorized over servers x placed neighbors — used by GLAD-E to seed
        newly-inserted vertices (argmin) and by GLAD-A's drift bound (max,
        Thm 8)."""
        out = self.unary[v].astype(np.float64).copy()
        nbrs = self.graph.neighbors(v)
        if len(nbrs):
            nbrs = nbrs[placed[nbrs]]
        if len(nbrs):
            out += self.net.tau[:, assign[nbrs]].sum(axis=1)
        return out

    def marginal(self, placed: np.ndarray, assign: np.ndarray, v: int, i: int) -> float:
        """Scalar view of :meth:`marginal_all` (kept for the Thm-8 tests)."""
        return float(self.marginal_all(placed, assign, v)[i])

    def layout_state(self, assign: np.ndarray) -> "LayoutState":
        """Cached per-assignment state for O(moved + incident) delta costs."""
        return LayoutState(self, assign)

    def rebind(self, old: "CostModel") -> ModelDiff:
        """Diff this model against the previous slot's: the minimal epoch
        bumps a persistent engine needs to adopt it (see ModelDiff).  Both
        models must price the same fleet; the graph may only grow (GLAD-E's
        evolution contract — deletions re-enter as weight-0 links)."""
        if self.net.m != old.net.m:
            raise ValueError(
                f"rebind across fleet sizes ({old.net.m} -> {self.net.m})")
        n_old, n_new = old.graph.n, self.graph.n
        if n_new < n_old:
            raise ValueError(f"rebind shrank the graph ({n_old} -> {n_new})")
        m = self.net.m

        # Unary: dense columns (degrade/kill/traffic-rescale hit every row
        # of a server) become server epochs; remaining sparse changes become
        # per-vertex rows.
        D = self.unary[:n_old] != old.unary
        colcnt = D.sum(axis=0)
        dense = colcnt * 2 > max(n_old, 1)
        servers = set(np.flatnonzero(dense).tolist())
        if dense.all():
            unary_rows = np.zeros(0, dtype=np.int64)
        else:
            unary_rows = np.flatnonzero(D[:, ~dense].any(axis=1))

        # Tau: any change poisons internal arc capacities of pairs reading
        # the changed entries.  Dense rows (a server's whole link pricing
        # moved) fold into server epochs; sparse leftover columns are
        # reported so the engine can bump the neighbors of vertices homed
        # on those servers.
        T = self.net.tau != old.net.tau
        if T.any():
            tau_pairs = T
            dense_r = T.sum(axis=1) * 2 > m
            servers.update(np.flatnonzero(dense_r).tolist())
            rest = T[~dense_r] if not dense_r.all() else np.zeros((0, m), bool)
            tau_cols = np.flatnonzero(rest.any(axis=0))
        else:
            tau_pairs = None
            tau_cols = np.zeros(0, dtype=np.int64)

        # Graph delta: symmetric difference of edge keys + weight changes on
        # common edges + brand-new vertices.
        if self.graph is old.graph:
            struct = np.zeros(0, dtype=np.int64)
        else:
            N = np.int64(max(n_new, 1))
            eo, en = old.graph.edges, self.graph.edges
            ko = (eo[:, 0].astype(np.int64) * N + eo[:, 1]
                  if len(eo) else np.zeros(0, np.int64))
            kn = (en[:, 0].astype(np.int64) * N + en[:, 1]
                  if len(en) else np.zeros(0, np.int64))
            only_o = ~np.isin(ko, kn)
            only_n = ~np.isin(kn, ko)
            touched = [eo[only_o].ravel(), en[only_n].ravel(),
                       np.arange(n_old, n_new, dtype=np.int64)]
            if (old.graph.edge_weights is not None
                    or self.graph.edge_weights is not None):
                wo = old.graph.weights_or_ones().astype(np.float64)
                wn = self.graph.weights_or_ones().astype(np.float64)
                so, sn = np.argsort(ko, kind="stable"), np.argsort(
                    kn, kind="stable")
                cko, ckn = ko[so], kn[sn]
                if len(cko) and len(ckn):
                    pos = np.minimum(np.searchsorted(cko, ckn), len(cko) - 1)
                    changed = (cko[pos] == ckn) & (wo[so][pos] != wn[sn])
                    touched.append(en[sn[changed]].ravel())
            struct = np.unique(np.concatenate(touched)).astype(np.int64)

        return ModelDiff(
            unary_rows=np.asarray(unary_rows, dtype=np.int64),
            servers=np.array(sorted(servers), dtype=np.int64),
            tau_pairs=tau_pairs,
            tau_cols=np.asarray(tau_cols, dtype=np.int64),
            struct_vertices=struct)

    def marginal_fp(self, subset: np.ndarray, v: int) -> float:
        """Paper's F_P(X, v) under auxiliary-graph accounting (Thm 3, Eq. 14):
        the *new* aggregation work is over N_v \\ A(X), where
        A(X) = X  ∪  (union of neighbors of X).  Submodular in X — the
        property test checks F_P(X,v) >= F_P(Y,v) for X ⊆ Y."""
        in_aux = subset.copy()
        for u in np.where(subset)[0]:
            in_aux[self.graph.neighbors(u)] = True
        new = [u for u in self.graph.neighbors(v) if not in_aux[u]]
        # Use mean C_P(u, ·) — server-independent comparison is what Thm 3 uses
        # (the newly added vertex goes to the *same* server for X and Y).
        return float(self.cp_matrix[new, 0].sum()) if new else 0.0

    # ------------------------------------------------------------ replication
    def _replica_savings(self, assign: np.ndarray):
        """Per-candidate saved read traffic, keyed ``v * m + p``.

        Directed-read split of C_T: each cut link's tau * w prices two
        directed reads (either endpoint's host pulling the other's row once
        per BSP round), half the link cost each.  Replicating v into a
        consumer part p serves p's reads of v locally, saving
        ``0.5 * tau[home_v, p] * W(v, p)`` where W(v, p) sums the weights of
        v's cut links into p.  Returns (keys sorted ascending, savings)."""
        e = self.graph.edges
        m = np.int64(self.net.m)
        if not len(e):
            return np.zeros(0, np.int64), np.zeros(0, np.float64)
        a_u, a_v = assign[e[:, 0]], assign[e[:, 1]]
        cut = a_u != a_v
        if not cut.any():
            return np.zeros(0, np.int64), np.zeros(0, np.float64)
        w = self.graph.weights_or_ones()[cut]
        u, v = e[cut, 0], e[cut, 1]
        au, av = a_u[cut], a_v[cut]
        half = 0.5 * self.net.tau[au, av] * w
        keys = np.concatenate([u * m + av, v * m + au])
        vals = np.concatenate([half, half])
        uniq, inv = np.unique(keys, return_inverse=True)
        saved = np.zeros(len(uniq), dtype=np.float64)
        np.add.at(saved, inv, vals)
        return uniq, saved

    def replicate_greedy(self, assign: np.ndarray, sync_weight: float = 0.5,
                         storage: float = 0.0,
                         budget: "int | None" = None) -> Replication:
        """Accept every replica placement with positive gain on top of the
        given cut (paper Sec. III-B extended with Fograph-style inference
        replication).

        Replicating v into consumer p is a unary decision given the cut:
        gain(v, p) = 0.5 * tau[home, p] * W(v, p)
                     - (sync_weight * tau[home, p] + storage).
        Candidates are independent, so accepting all positive gains is the
        exact optimum of the overlay; ``budget`` caps replicas per part
        (keep the top gains, vertex-id tie break — deterministic)."""
        assign = np.asarray(assign, dtype=np.int64)
        m = np.int64(self.net.m)
        keys, saved = self._replica_savings(assign)
        vs = (keys // m).astype(np.int64)
        ps = (keys % m).astype(np.int64)
        cost = sync_weight * self.net.tau[assign[vs], ps] + storage
        gain = saved - cost
        keep = gain > 1e-12
        vs, ps, gain = vs[keep], ps[keep], gain[keep]
        by_part: Dict[int, np.ndarray] = {}
        for p in np.unique(ps):
            sel = ps == p
            ids, g = vs[sel], gain[sel]
            if budget is not None and len(ids) > budget:
                top = np.lexsort((ids, -g))[:budget]
                ids, g = ids[top], g[top]
            by_part[int(p)] = np.sort(ids)
        repl = Replication(by_part=by_part, gain=0.0, saved=0.0, sync=0.0,
                           storage=0.0, sync_weight=float(sync_weight),
                           storage_cost=float(storage))
        acc = self.replication_cost(assign, repl)
        repl.saved, repl.sync = acc["saved"], acc["sync"]
        repl.storage, repl.gain = acc["storage"], -acc["net"]
        return repl

    def replication_cost(self, assign: np.ndarray,
                         repl: Replication) -> Dict[str, float]:
        """Exact accounting of a replication overlay on ``assign``:
        ``saved`` (read traffic served locally), ``sync``/``storage`` (the
        overlay's recurring charges), ``net`` = sync + storage - saved, and
        ``total`` = the layout objective with the overlay applied.  The
        greedy's own output always has ``net <= 0``."""
        assign = np.asarray(assign, dtype=np.int64)
        m = np.int64(self.net.m)
        keys, saved_all = self._replica_savings(assign)
        saved = sync = 0.0
        count = 0
        for p, ids in sorted(repl.by_part.items()):
            ids = np.asarray(ids, dtype=np.int64)
            ids = ids[assign[ids] != p]       # a home-resident needs no copy
            if not len(ids):
                continue
            k = ids * m + p
            if len(keys):
                pos = np.minimum(np.searchsorted(keys, k), len(keys) - 1)
                match = keys[pos] == k
                saved += float(saved_all[pos[match]].sum())
            sync += float(
                (repl.sync_weight * self.net.tau[assign[ids], p]).sum())
            count += len(ids)
        storage = repl.storage_cost * count
        net = sync + storage - saved
        return {"saved": saved, "sync": sync, "storage": storage,
                "net": net, "total": self.total(assign) + net}


class LayoutState:
    """Cached evaluation state of one assignment under one CostModel.

    Holds the per-vertex unary picks ``unary[v, assign[v]]`` and the
    per-edge quadratic contributions ``tau[a_u, a_v] * w_uv`` so that the
    cost change of moving a vertex subset is computable in
    O(|moved| + incident links) — the accept path of the layout engine
    never re-evaluates the full O(n+m) objective.

    Invariant: ``total == unary_pick.sum() + edge_ct.sum() + cm.constant``
    (Thm 2's C1 + C2 + C0), kept exact by routing every mutation through
    :meth:`commit`.

    ``on_commit`` (optional): callback ``(moved, old_servers)`` invoked
    after EVERY applied mutation, with the movers and the servers they
    left.  The layout engine registers its dirty/epoch bookkeeping here so
    that commits arriving through this API directly (fault-runtime warm
    restarts, externally-imposed churn) keep its assembly cache and
    warm-start residual state coherent — not just commits routed through
    the engine's own accept path.
    """

    def __init__(self, cm: CostModel, assign: np.ndarray):
        self.cm = cm
        self.on_commit = None
        self.assign = np.array(assign, dtype=np.int64)      # owned copy
        g = cm.graph
        if self.assign.shape != (g.n,):
            raise ValueError(
                f"assign shape {self.assign.shape} != ({g.n},)")
        idx = np.arange(g.n)
        self.unary_pick = cm.unary[idx, self.assign].astype(np.float64)
        e = g.edges
        self._w = g.weights_or_ones().astype(np.float64)
        if len(e):
            self.edge_ct = (
                cm.net.tau[self.assign[e[:, 0]], self.assign[e[:, 1]]]
                * self._w)
        else:
            self.edge_ct = np.zeros(0, dtype=np.float64)
        self.total = float(
            self.unary_pick.sum() + self.edge_ct.sum() + cm.constant)
        # Proposal overlay: kept identical to ``assign`` between calls so
        # delta() can evaluate incident edges against the proposed layout
        # without copying the full vector.
        self._overlay = self.assign.copy()
        self._pending = None

    # ------------------------------------------------------------- delta API
    def _delta_parts(self, moved: np.ndarray, new_servers: np.ndarray):
        cm, g = self.cm, self.cm.graph
        du = float(
            cm.unary[moved, new_servers].sum()
            - self.unary_pick[moved].sum())
        eids = g.incident_edge_ids(moved)
        if len(eids) == 0:
            return du, eids, np.zeros(0, dtype=np.float64)
        overlay = self._overlay
        overlay[moved] = new_servers
        e = g.edges
        new_ct = (
            cm.net.tau[overlay[e[eids, 0]], overlay[e[eids, 1]]]
            * self._w[eids])
        overlay[moved] = self.assign[moved]                  # restore
        return du + float(new_ct.sum() - self.edge_ct[eids].sum()), eids, new_ct

    def delta(self, moved: np.ndarray, new_servers: np.ndarray) -> float:
        """Exact cost change of re-assigning ``moved[k] -> new_servers[k]``
        (everything else fixed), in O(|moved| + incident links)."""
        moved = np.asarray(moved, dtype=np.int64)
        new_servers = np.asarray(new_servers, dtype=np.int64)
        d, _, _ = self._delta_parts(moved, new_servers)
        return d

    def commit(self, moved: np.ndarray, new_servers: np.ndarray) -> float:
        """Apply the move, updating all caches incrementally; returns the
        (exact) delta that was applied."""
        moved = np.asarray(moved, dtype=np.int64)
        new_servers = np.asarray(new_servers, dtype=np.int64)
        return self._apply(moved, new_servers,
                           self._delta_parts(moved, new_servers))

    def propose(self, moved: np.ndarray, new_servers: np.ndarray) -> float:
        """Like :meth:`delta`, but keeps the computed parts so an immediate
        :meth:`commit_pending` applies them without re-evaluation (the
        engine's accept path: one delta pass per accepted move)."""
        moved = np.asarray(moved, dtype=np.int64)
        new_servers = np.asarray(new_servers, dtype=np.int64)
        parts = self._delta_parts(moved, new_servers)
        self._pending = (moved, new_servers, parts)
        return parts[0]

    def commit_pending(self) -> float:
        if self._pending is None:
            raise RuntimeError("no pending proposal: call propose() first")
        moved, new_servers, parts = self._pending
        return self._apply(moved, new_servers, parts)

    def discard_pending(self) -> None:
        """Drop a rejected proposal so a later commit_pending() cannot
        apply stale parts."""
        self._pending = None

    def _apply(self, moved, new_servers, parts) -> float:
        # Any commit invalidates an outstanding proposal (its cached edge
        # contributions were computed against the pre-commit layout).
        self._pending = None
        d, eids, new_ct = parts
        old_servers = self.assign[moved].copy()
        self.assign[moved] = new_servers
        self._overlay[moved] = new_servers
        self.unary_pick[moved] = self.cm.unary[moved, new_servers]
        if len(eids):
            self.edge_ct[eids] = new_ct
        self.total += d
        if self.on_commit is not None:
            self.on_commit(moved, old_servers)
        return d

    def factors(self) -> Dict[str, float]:
        """Full factor breakdown of the current assignment (O(n+m); for
        reporting — never on the per-iteration accept path)."""
        return self.cm.factors(self.assign)
