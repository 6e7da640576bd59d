"""Multilevel GLAD: a METIS-style V-cycle over the pairwise min-cut engine.

Flat GLAD sweeps pay O(n) member volume per round from the very first
iteration, so million-vertex layouts spend almost all their wall time on
first-pass cuts whose decisions are dominated by coarse cluster structure.
The V-cycle factors that structure out:

  coarsen   iterative heavy-edge matching (vectorized over the DataGraph
            CSR, decided in the quantized integer weight domain) contracts
            matched pairs into coarse vertices until ``coarsen_to`` is
            reached.  Each coarse level is a real ``DataGraph`` +
            ``CostModel`` pair: coarse edge weights are the summed fine
            weights, and the coarse unary matrix is the row-sum of the fine
            one (folded into the coarse network's ``mu``; compute and
            per-vertex maintenance coefficients are zeroed so nothing is
            double counted).  Because intra-cluster links cost tau[i,i] = 0
            under any projection, the coarse objective of a coarse
            assignment EQUALS the fine objective of its projection — the
            hierarchy restricts the search space, never distorts the cost
            (pinned by a hypothesis property test).
  solve     the coarsest level is solved by the EXISTING engine
            (:func:`repro_torch.core.glad_s.glad_s`, batched disjoint-pair
            rounds) — no new optimizer code at any level.
  refine    each assignment is projected one level down
            (``assign[cluster_of]``) and the same engine re-runs with the
            projection as warm init and a boundary-active mask (endpoints
            of cut links + ``refine_hops`` neighborhood rings).  The active
            mask is exactly the regime the engine's 'auto' policies enable
            the AssemblyCache and warm-start (ResidualCut) for, so
            cross-round caching, persistency peeling and warm re-solves
            compose per level unchanged.  ``cache_bytes``/``chunk_nodes``
            are scaled to each level's vertex count, so coarse levels never
            reserve the finest level's budgets.

The finest refinement is literally a flat ``glad_s`` call on the original
cost model — its trajectory is bit-identical to running the flat engine
from the same projected init and mask (golden-fixture pinned).

Matching is capacity-aware (cluster fine-vertex counts are capped at
``MAX_CLUSTER_FACTOR * n / coarsen_to`` so no coarse vertex grows beyond
what a balanced layout could place) and mu-aware: a merge commits both
endpoints to one server, so candidates whose unary preference disagreement
provably exceeds the traffic the merge can save are gated out
(``MU_GATE_SLACK``).

The port's copy of ``repro.core.multilevel``, with ``repro`` renamed ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import List, Optional

import numpy as np

from repro_torch.core.cost import CostModel
from repro_torch.core.engine import AUTO_CHUNK_NODES
from repro_torch.graphs.datagraph import DataGraph, contract_graph, csr_multirange
from repro_torch.graphs.edgenet import EdgeNetwork

#: ``multilevel='auto'`` turns the V-cycle on from this vertex count.
MULTILEVEL_AUTO_MIN_N = 200_000
#: Default coarsest-level size (the level the full-R solve runs at).
#: Chosen so the coarsest exhaustive-patience solve stays a small share of
#: the V-cycle wall clock at n=50k/m=32 while final cost tracks the flat
#: engine within 1e-3 (BENCH_layout multilevel cells).
COARSEN_TO = 1024
#: Matching proposal rounds per coarsening level.
MATCH_ROUNDS = 4
#: Stop coarsening when a level shrinks by less than this factor.
STAGNATION_FRAC = 0.95
#: Cluster fine-vertex cap = this factor x (n / coarsen_to).
MAX_CLUSTER_FACTOR = 1.5
#: mu gate: allow a merge only while the unary disagreement lower bound
#: stays under SLACK x tau_ref x link weight (the traffic scale the merge
#: can save).  Permissive on purpose — it prunes egregious merges only.
MU_GATE_SLACK = 4.0
#: Integer domain for matching decisions (mirrors maxflow's quantization).
_WQ_SCALE = 10 ** 7
#: Floor for a level's scaled AssemblyCache budget.
_MIN_LEVEL_CACHE = 8 << 20


@dataclasses.dataclass
class Level:
    """One rung of the coarsening hierarchy.

    ``cluster_of`` maps the NEXT-FINER level's vertices onto this level's
    (``None`` at the finest level).  ``vertex_w`` counts the fine vertices
    each coarse vertex carries (the capacity weight the matcher caps).
    """

    cm: CostModel
    cluster_of: Optional[np.ndarray]
    vertex_w: np.ndarray


#: Largest float64 magnitude a quantized weight may round to and still fit
#: int64.  Anything past this would WRAP silently under ``.astype(int64)``
#: (numpy does not raise) and corrupt every downstream matching decision.
_INT64_LIMIT_F = float(2 ** 63 - 1024)


def _quantize_scaled(vals: np.ndarray, scale: float) -> np.ndarray:
    """Elementwise quantization at a fixed scale, with a loud int64-domain
    guard: weights whose scaled magnitude leaves the int64 range (huge
    negatives, inf/nan from upstream weight sums) raise instead of
    wrapping.  Shared by the in-core and streamed coarsening paths so
    both make bit-identical decisions chunk by chunk."""
    scaled = np.rint(vals * scale)
    bad = ~(np.abs(scaled) <= _INT64_LIMIT_F)     # catches nan/inf too
    if bad.any():
        k = int(np.flatnonzero(bad)[0])
        raise ValueError(
            f"quantized edge weight overflows the int64 matching domain "
            f"(weight {vals[k]!r} at scale {scale!r}); summed parallel "
            f"edge weights saturated — refuse to wrap silently")
    return scaled.astype(np.int64)


def quantize_weights(w: np.ndarray) -> np.ndarray:
    """Edge weights -> the integer domain matching decisions are made in
    (scale-invariant, deterministic ties).  Raises on weights that do not
    fit the int64 domain after scaling (silent wraparound would corrupt
    matchings at n>=2M where contracted parallel-edge sums grow large)."""
    if len(w) and not np.isfinite(w).all():
        raise ValueError("non-finite edge weight entering quantization "
                         "(overflowed parallel-edge weight sum?)")
    mx = float(w.max()) if len(w) else 0.0
    if mx <= 0.0:
        return np.zeros(len(w), dtype=np.int64)
    return _quantize_scaled(w, _WQ_SCALE / mx)


def _mix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Deterministic per-(vertex, neighbor) hash for tie-breaking.

    Equal-weight candidates (the whole finest level, when links are unit
    weight) must not all prefer the same smallest-id neighbor — that herds
    every proposal onto a few hubs and each handshake round matches only
    one tail per hub.  A splitmix-style hash spreads the ties uniformly
    while staying a pure function of the ids (coarsening stays
    deterministic, no RNG)."""
    x = (a.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         ^ (b.astype(np.uint64) + np.uint64(0xBF58476D1CE4E5B9)))
    x ^= x >> np.uint64(31)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(29)
    return x


def matching_gate(
    graph: DataGraph,
    unary: np.ndarray,
    tau_ref: float,
    lo: int = 0,
    hi: Optional[int] = None,
    pref: Optional[np.ndarray] = None,
    base: Optional[np.ndarray] = None,
) -> np.ndarray:
    """mu-gate bits for every CSR entry of vertices in ``[lo, hi)``.

    Entry k (vertex v -> neighbor nbr) is True when the merge is allowed:
    the unary-disagreement lower bound stays under ``MU_GATE_SLACK x
    tau_ref x link weight``.  A pure elementwise function of
    (unary, tau_ref, weights), so computing it for the full CSR, for a
    vertex window (the streamed matcher), or for a round's candidate
    subset (the original in-line form) yields bit-identical bits — and
    comparing bits across cost models is an EXACT test for whether a
    level's matching is unchanged (the LevelStack reuse criterion)."""
    if hi is None:
        hi = graph.n
    indptr = graph.indptr
    s, e = int(indptr[lo]), int(indptr[hi])
    if s == e:
        return np.zeros(0, dtype=bool)
    counts = np.diff(indptr[lo:hi + 1])
    v = np.repeat(np.arange(lo, hi, dtype=np.int64), counts)
    nbr = graph.indices[s:e]
    if pref is None:
        pref = np.argmin(unary, axis=1).astype(np.int64)
        base = unary[np.arange(graph.n), pref]
    if graph.edge_weights is None:
        w_e = np.ones(e - s, dtype=np.float64)
    else:
        w_e = graph.edge_weights[graph.edge_ids[s:e]].astype(np.float64)
    d_lb = np.minimum(unary[v, pref[nbr]] - base[v],
                      unary[nbr, pref[v]] - base[nbr])
    return MU_GATE_SLACK * tau_ref * w_e >= d_lb


def heavy_edge_matching(
    graph: DataGraph,
    vertex_w: np.ndarray,
    max_w: int,
    unary: Optional[np.ndarray] = None,
    tau_ref: float = 0.0,
    rounds: int = MATCH_ROUNDS,
    gate: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Iterative HEM over the CSR: ``match[v]`` = partner (or v itself).

    Per round: every unmatched vertex PROPOSES to its heaviest eligible
    unmatched neighbor (integer-quantized weight; ties broken by the
    deterministic :func:`_mix` hash so equal-weight levels don't herd onto
    hubs).  Every proposed-to vertex then ACCEPTS its heaviest incoming
    proposer, overriding its own outgoing proposal — the incoming-aware
    handshake is what lets a hub pair up every round instead of chasing a
    neighbor that never looks back.  Vertices whose accept/propose
    pointers agree (``c[c[v]] == v``) match.  Eligibility = the merged
    capacity weight fits ``max_w`` and, when ``unary`` is given, the mu
    gate holds.  Fully deterministic — no RNG anywhere, so coarsening is a
    pure function of the cost model (the determinism the smoke bench
    pins).
    """
    n = graph.n
    match = np.arange(n, dtype=np.int64)
    if graph.num_edges == 0:
        return match
    indptr, indices, eids = graph.indptr, graph.indices, graph.edge_ids
    w = graph.weights_or_ones().astype(np.float64)
    wq = quantize_weights(w)
    matched = np.zeros(n, dtype=bool)
    if gate is None and unary is not None and tau_ref > 0.0:
        # One elementwise pass over the full CSR replaces the original
        # per-round candidate-subset computation — same bits (the gate is
        # a pure function of each entry), one gather instead of four per
        # round, and the LevelStack caches exactly this array.
        gate = matching_gate(graph, unary, tau_ref)
    for _ in range(rounds):
        un = np.flatnonzero(~matched)
        flat, rep = csr_multirange(indptr, un)
        if len(flat) == 0:
            break
        v = un[rep]
        nbr = indices[flat]
        ew = eids[flat]
        ok = ~matched[nbr]
        ok &= vertex_w[v] + vertex_w[nbr] <= max_w
        if gate is not None:
            # Lower bound on the unary penalty of co-locating v and nbr:
            # one of them must leave its preferred server (see
            # :func:`matching_gate`).
            ok &= gate[flat]
        if not ok.any():
            break
        v, nbr, cw = v[ok], nbr[ok], wq[ew[ok]]
        h = _mix(v, nbr)
        # Proposal: per proposer v, heaviest neighbor, hash tie-break.
        order = np.lexsort((h, -cw, v))
        vs_, nb_, cw_, h_ = v[order], nbr[order], cw[order], h[order]
        head = np.ones(len(order), dtype=bool)
        head[1:] = vs_[1:] != vs_[:-1]
        pv, pt = vs_[head], nb_[head]            # proposer -> target
        pw, ph = cw_[head], h_[head]
        # Acceptance: per target, heaviest incoming proposer (hash, then
        # proposer id, break residual ties deterministically).
        order2 = np.lexsort((pv, ph, -pw, pt))
        t2, p2 = pt[order2], pv[order2]
        head2 = np.ones(len(order2), dtype=bool)
        head2[1:] = t2[1:] != t2[:-1]
        c = np.full(n, -1, dtype=np.int64)
        c[pv] = pt                               # own outgoing proposal
        c[t2[head2]] = p2[head2]                 # incoming winner overrides
        cand = np.flatnonzero(c >= 0)
        partner = c[cand]
        mutual = (c[partner] == cand) & (cand < partner)
        a, b = cand[mutual], partner[mutual]
        if len(a) == 0:
            break
        match[a] = b
        match[b] = a
        matched[a] = True
        matched[b] = True
    return match


def clusters_from_matching(match: np.ndarray):
    """Matching -> (cluster_of, num_clusters); coarse ids ordered by each
    cluster's smallest member id (deterministic)."""
    rep = np.minimum(np.arange(len(match), dtype=np.int64), match)
    uniq, cluster_of = np.unique(rep, return_inverse=True)
    return cluster_of.astype(np.int64), int(len(uniq))


def coarse_cost_model(
    cm: CostModel, graph_c: DataGraph, cluster_of: np.ndarray, nc: int
) -> CostModel:
    """Exact coarse model: coarse ``mu`` rows are the summed fine ``unary``
    rows; compute/per-vertex-maintenance coefficients are zeroed (already
    inside the fine unary), ``tau``/``w``/``eps`` carry over.  The coarse
    ``unary`` therefore equals the summed fine unary and, with summed edge
    weights and tau[i,i] = 0, the coarse total of any coarse assignment
    equals the fine total of its projection (up to float summation order).
    """
    net = cm.net
    order = np.argsort(cluster_of, kind="stable")
    starts = np.searchsorted(cluster_of[order], np.arange(nc))
    mu_c = np.add.reduceat(cm.unary[order], starts, axis=0)
    zeros = np.zeros(net.m, dtype=np.float64)
    net_c = EdgeNetwork(
        m=net.m, w=net.w, tau=net.tau, alpha=zeros, beta=zeros, gamma=zeros,
        rho=zeros, eps=net.eps, mu=mu_c, sku=net.sku, coords=net.coords,
    )
    return CostModel(net_c, graph_c, cm.gnn)


def build_levels(
    cm: CostModel,
    coarsen_to: int = COARSEN_TO,
    max_levels: Optional[int] = None,
    mu_gate: bool = True,
    chunk_vertices: "int | str | None" = None,
) -> List[Level]:
    """Coarsening hierarchy, finest first.  Stops at ``coarsen_to``
    vertices, at ``max_levels`` rungs, or when matching stagnates.

    ``chunk_vertices`` routes the build through the streamed coarsening
    path (:mod:`repro_torch.core.multilevel_stream`): matching and contraction
    walk the CSR in bounded vertex windows of that size ('auto' picks the
    default window), so peak transient memory is a knob instead of
    O(n + m) per level.  The streamed levels are BIT-IDENTICAL to the
    in-core ones for any window size (property-pinned)."""
    if chunk_vertices is not None:
        from repro_torch.core.multilevel_stream import build_levels_streamed
        return build_levels_streamed(
            cm, coarsen_to=coarsen_to, max_levels=max_levels,
            mu_gate=mu_gate, chunk_vertices=chunk_vertices)
    levels = [Level(cm=cm, cluster_of=None,
                    vertex_w=np.ones(cm.graph.n, dtype=np.int64))]
    tau_ref = cm.tau_ref() if mu_gate else 0.0
    cap = max(2, int(np.ceil(
        MAX_CLUSTER_FACTOR * cm.graph.n / max(coarsen_to, 1))))
    while True:
        cur = levels[-1]
        g = cur.cm.graph
        if g.n <= coarsen_to or g.num_edges == 0:
            break
        if max_levels is not None and len(levels) >= max_levels:
            break
        match = heavy_edge_matching(
            g, cur.vertex_w, cap,
            unary=cur.cm.unary if mu_gate else None, tau_ref=tau_ref)
        cluster_of, nc = clusters_from_matching(match)
        if nc >= STAGNATION_FRAC * g.n:
            break
        g_c = contract_graph(g, cluster_of, nc)
        cm_c = coarse_cost_model(cur.cm, g_c, cluster_of, nc)
        vw_c = np.bincount(cluster_of, weights=cur.vertex_w,
                           minlength=nc).astype(np.int64)
        levels.append(Level(cm=cm_c, cluster_of=cluster_of, vertex_w=vw_c))
    return levels


def _gate_equal(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> bool:
    """Exact equality of two mu-gate bit vectors (None = ungated level)."""
    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and bool(np.array_equal(a, b))


class LevelStack:
    """Persistent coarsening hierarchy reused across relayouts.

    ``build_levels`` is a pure function of (graph structure, edge weights,
    mu-gate bits, capacity cap) — it never reads the current assignment.
    A fault-loop relayout (degrade / straggler / revive) churns the
    ASSIGNMENT of most vertices but leaves the data graph untouched and
    usually leaves the gate bits untouched too, so the expensive parts of
    the V-cycle (matching + contraction per level) can be reused verbatim
    and only the cheap coarse cost models (unary row-sums under the new
    network) rebuilt.  :meth:`acquire` returns a level stack BIT-IDENTICAL
    to a fresh ``build_levels(cm)`` call:

      * per level, the cached gate bits are compared against freshly
        computed bits under the new cost model.  Gate bits are an EXACT
        certificate — matching is a pure function of (structure, quantized
        weights, vertex_w, cap, gate bits), all of which are equal when the
        bits are — so equality proves the cached matching is what a fresh
        build would recompute.
      * bits differ -> the level is re-matched for real; if the new
        matching still equals the cached one, structure reuse continues
        below.  A genuinely diverged matching forces a fresh rebuild from
        that level down (coarse ids are renumbered by
        ``clusters_from_matching`` and the ``_mix`` tie-break hashes key on
        them, so nothing beneath a divergence is salvageable).
      * a stagnation-terminated stack caches the terminal gate + attempted
        matching so termination itself is re-verified exactly; when the
        new model no longer stagnates, the stack simply EXTENDS with fresh
        levels.

    A graph change (GLAD-E evolution) invalidates the whole stack —
    :meth:`valid_for` checks the finest graph by identity, falling back to
    a structural compare.  Owned by
    :class:`repro_torch.core.engine.LayoutSession` (one stack per V-cycle
    configuration), which is how the stack survives across GLAD-E
    escalations and fault relayouts.
    """

    def __init__(self, coarsen_to: int = COARSEN_TO,
                 max_levels: Optional[int] = None, mu_gate: bool = True):
        self.coarsen_to = int(coarsen_to)
        self.max_levels = max_levels
        self.mu_gate = bool(mu_gate)
        self._levels: Optional[List[Level]] = None
        self._gates: List[Optional[np.ndarray]] = []
        self._matches: List[np.ndarray] = []
        # (reason, gate, match): how the cached build stopped.  'size' and
        # 'depth' are pure functions of structure; 'stagnation' keeps the
        # terminal gate bits + attempted matching for exact re-verification.
        self._term: Optional[tuple] = None
        self.builds = 0              # acquisitions that rebuilt from scratch
        self.refreshes = 0           # acquisitions served off the cache
        self.levels_reused = 0       # cumulative matchings reused verbatim
        self.levels_rebuilt = 0      # cumulative matchings recomputed
        self.last_stats: dict = {}

    # ------------------------------------------------------------ validity
    def valid_for(self, cm: CostModel) -> bool:
        """Is the cached stack built over this cost model's graph?  Object
        identity first (the fault runtime keeps one DataGraph across
        events), structural equality as the fallback."""
        if self._levels is None:
            return False
        g0 = self._levels[0].cm.graph
        g = cm.graph
        if g is g0:
            return True
        if g.n != g0.n or g.num_edges != g0.num_edges:
            return False
        if not np.array_equal(g.edges, g0.edges):
            return False
        w0, w1 = g0.edge_weights, g.edge_weights
        if (w0 is None) != (w1 is None):
            return False
        return w0 is None or bool(np.array_equal(w0, w1))

    def invalidate(self) -> None:
        self._levels = None
        self._gates = []
        self._matches = []
        self._term = None

    # ------------------------------------------------------------- helpers
    def _cap(self, n: int) -> int:
        return max(2, int(np.ceil(
            MAX_CLUSTER_FACTOR * n / max(self.coarsen_to, 1))))

    def _gate_for(self, g: DataGraph, unary: np.ndarray, tau_ref: float,
                  chunk) -> Optional[np.ndarray]:
        if not self.mu_gate or tau_ref <= 0.0:
            return None
        if chunk is not None:
            from repro_torch.core.multilevel_stream import matching_gate_streamed
            return matching_gate_streamed(g, unary, tau_ref,
                                          chunk_vertices=chunk)
        return matching_gate(g, unary, tau_ref)

    def _match_with(self, g: DataGraph, vertex_w: np.ndarray, cap: int,
                    gate: Optional[np.ndarray], chunk) -> np.ndarray:
        if chunk is not None:
            from repro_torch.core.multilevel_stream import (
                heavy_edge_matching_streamed)
            return heavy_edge_matching_streamed(
                g, vertex_w, cap, gate=gate, chunk_vertices=chunk)
        return heavy_edge_matching(g, vertex_w, cap, gate=gate)

    def _coarse_cm(self, cm_f: CostModel, g_c: DataGraph,
                   cluster_of: np.ndarray, nc: int, chunk) -> CostModel:
        if chunk is not None:
            from repro_torch.core.multilevel_stream import (
                coarse_cost_model_streamed)
            return coarse_cost_model_streamed(cm_f, g_c, cluster_of, nc,
                                              chunk_vertices=chunk)
        return coarse_cost_model(cm_f, g_c, cluster_of, nc)

    def _grow(self, levels: List[Level], gates: list, matches: list,
              tau_ref: float, cap: int, chunk, pending=None) -> None:
        """Extend ``levels`` with freshly built rungs until termination;
        ``pending`` hands over an already-computed (gate, match) for the
        current finest-unprocessed level (the divergence hand-off — its
        size/depth preconditions held for the cached build of the same
        structure, so they are not re-checked)."""
        while True:
            cur = levels[-1]
            g = cur.cm.graph
            if pending is None:
                if g.n <= self.coarsen_to or g.num_edges == 0:
                    self._term = ("size", None, None)
                    return
                if (self.max_levels is not None
                        and len(levels) >= self.max_levels):
                    self._term = ("depth", None, None)
                    return
                gate = self._gate_for(g, cur.cm.unary, tau_ref, chunk)
                match = self._match_with(g, cur.vertex_w, cap, gate, chunk)
            else:
                gate, match = pending
                pending = None
            cluster_of, nc = clusters_from_matching(match)
            if nc >= STAGNATION_FRAC * g.n:
                self._term = ("stagnation", gate, match)
                return
            gates.append(gate)
            matches.append(match)
            if chunk is not None:
                from repro_torch.core.multilevel_stream import (
                    coarse_vertex_w_streamed, contract_graph_streamed)
                g_c = contract_graph_streamed(g, cluster_of, nc,
                                              chunk_vertices=chunk)
                vw_c = coarse_vertex_w_streamed(cluster_of, cur.vertex_w,
                                                nc, chunk_vertices=chunk)
            else:
                g_c = contract_graph(g, cluster_of, nc)
                vw_c = np.bincount(cluster_of, weights=cur.vertex_w,
                                   minlength=nc).astype(np.int64)
            cm_c = self._coarse_cm(cur.cm, g_c, cluster_of, nc, chunk)
            levels.append(Level(cm=cm_c, cluster_of=cluster_of,
                                vertex_w=vw_c))

    # ------------------------------------------------------------- acquire
    def acquire(self, cm: CostModel,
                chunk_vertices: "int | str | None" = None) -> List[Level]:
        """Level stack for ``cm``, bit-identical to a fresh
        ``build_levels(cm, ...)`` — built from scratch when the graph
        changed, refreshed off the cache otherwise (reused matchings +
        rebuilt coarse cost models)."""
        chunk = chunk_vertices
        tau_ref = cm.tau_ref() if self.mu_gate else 0.0
        cap = self._cap(cm.graph.n)
        if not self.valid_for(cm):
            levels = [Level(cm=cm, cluster_of=None,
                            vertex_w=np.ones(cm.graph.n, dtype=np.int64))]
            gates: list = []
            matches: list = []
            self._grow(levels, gates, matches, tau_ref, cap, chunk)
            self._levels, self._gates, self._matches = (
                levels, gates, matches)
            self.builds += 1
            self.levels_rebuilt += len(matches)
            self.last_stats = dict(mode="build", levels=len(levels),
                                   reused=0, rebuilt=len(matches),
                                   rematch=0)
            return levels

        self.refreshes += 1
        old_levels, old_matches = self._levels, self._matches
        old_gates, old_term = self._gates, self._term
        levels = [Level(cm=cm, cluster_of=None,
                        vertex_w=old_levels[0].vertex_w)]
        gates, matches = [], []
        reused = rematch = 0
        pending = None               # diverged (gate, match) hand-off
        for k in range(len(old_matches)):
            cur = levels[-1]
            gate = self._gate_for(cur.cm.graph, cur.cm.unary, tau_ref,
                                  chunk)
            if _gate_equal(gate, old_gates[k]):
                match = old_matches[k]
            else:
                match = self._match_with(cur.cm.graph, cur.vertex_w, cap,
                                         gate, chunk)
                if not np.array_equal(match, old_matches[k]):
                    pending = (gate, match)
                    break
                rematch += 1
            reused += 1
            gates.append(gate)
            matches.append(match)
            old = old_levels[k + 1]
            nc = old.cm.graph.n
            cm_c = self._coarse_cm(cur.cm, old.cm.graph, old.cluster_of,
                                   nc, chunk)
            levels.append(Level(cm=cm_c, cluster_of=old.cluster_of,
                                vertex_w=old.vertex_w))
        if pending is not None:
            self._grow(levels, gates, matches, tau_ref, cap, chunk,
                       pending=pending)
        else:
            cur = levels[-1]
            g = cur.cm.graph
            if g.n <= self.coarsen_to or g.num_edges == 0:
                self._term = ("size", None, None)
            elif (self.max_levels is not None
                    and len(levels) >= self.max_levels):
                self._term = ("depth", None, None)
            else:
                # The cached build stagnated here; re-verify exactly.
                _, tgate, tmatch = old_term
                gate = self._gate_for(g, cur.cm.unary, tau_ref, chunk)
                if _gate_equal(gate, tgate):
                    self._term = ("stagnation", gate, tmatch)
                else:
                    match = self._match_with(g, cur.vertex_w, cap, gate,
                                             chunk)
                    cluster_of, nc = clusters_from_matching(match)
                    if nc >= STAGNATION_FRAC * g.n:
                        self._term = ("stagnation", gate, match)
                    else:
                        # Termination no longer reproduces: the stack
                        # extends with fresh rungs from here down.
                        self._grow(levels, gates, matches, tau_ref, cap,
                                   chunk, pending=(gate, match))
        self._levels, self._gates, self._matches = levels, gates, matches
        rebuilt = len(matches) - reused
        self.levels_reused += reused
        self.levels_rebuilt += rebuilt
        self.last_stats = dict(mode="refresh", levels=len(levels),
                               reused=reused, rebuilt=rebuilt,
                               rematch=rematch)
        return levels


def _slim_level_stats(stats: dict) -> dict:
    """``record_levels=False`` telemetry: the O(n) replay arrays
    (projected init / active mask) and the per-iteration history collapse
    to checksums + sizes, so scale cells stop retaining O(levels x n)
    memory for bookkeeping nobody replays."""
    out = dict(stats)
    for key in ("init", "active"):
        arr = out.get(key)
        if arr is None:
            out[key + "_crc32"] = None
            out[key + "_size"] = 0
        else:
            arr = np.ascontiguousarray(arr)
            out[key + "_crc32"] = int(zlib.crc32(arr.tobytes()))
            out[key + "_size"] = int(arr.size)
        out[key] = None
    hist = out.get("history") or []
    out["history_crc32"] = (
        int(zlib.crc32(np.asarray(hist, dtype=np.float64).tobytes()))
        if len(hist) else None)
    out["history_len"] = len(hist)
    out["history"] = []
    return out


def restrict_assign(cluster_of: np.ndarray, nc: int, assign: np.ndarray,
                    m: int) -> np.ndarray:
    """Fine -> coarse restriction of a warm init: member-weighted majority
    vote per cluster, ties to the smallest server id."""
    cnt = np.bincount(cluster_of * m + assign, minlength=nc * m)
    return cnt.reshape(nc, m).argmax(axis=1).astype(np.int64)


def boundary_active(graph: DataGraph, assign: np.ndarray,
                    hops: int = 1) -> np.ndarray:
    """Refinement mask: endpoints of cut links, expanded ``hops`` rings."""
    act = np.zeros(graph.n, dtype=bool)
    e = graph.edges
    if len(e) == 0:
        return act
    cut = assign[e[:, 0]] != assign[e[:, 1]]
    act[e[cut, 0]] = True
    act[e[cut, 1]] = True
    for _ in range(int(hops)):
        src = np.flatnonzero(act)
        flat, _ = csr_multirange(graph.indptr, src)
        if len(flat):
            act[graph.indices[flat]] = True
    return act


def _level_knobs(n_level: int, n_finest: int, cache_bytes: int,
                 chunk_nodes) -> tuple:
    """Scale the engine budgets to a level's size: the AssemblyCache budget
    shrinks with the vertex count (a coarse level's pair assemblies are
    proportionally small) and the glued-union chunk never exceeds the
    level itself."""
    frac = n_level / max(n_finest, 1)
    cb = min(int(cache_bytes),
             max(_MIN_LEVEL_CACHE, int(cache_bytes * frac)))
    if chunk_nodes == "auto":
        cn = min(AUTO_CHUNK_NODES, max(1024, n_level))
    else:
        cn = chunk_nodes
    return cb, cn


def glad_multilevel(
    cm: CostModel,
    R: Optional[int] = None,
    init: Optional[np.ndarray] = None,
    seed: int = 0,
    backend: str = "auto",
    coarsen_to: int = COARSEN_TO,
    levels: Optional[int] = None,
    refine_R: Optional[int] = None,
    refine_hops: int = 1,
    round_solver: str = "auto",
    workers: int = 0,
    worker_mode: str = "thread",
    cache: "bool | str" = "auto",
    cache_bytes: int = 256 << 20,
    chunk_nodes: "int | str" = "auto",
    warm: "bool | str" = "auto",
    mu_gate: bool = True,
    max_iterations: int = 100_000,
    on_iteration=None,
    chunk_vertices: "int | str | None" = None,
    record_levels: bool = True,
    session=None,
):
    """The V-cycle driver: coarsen, solve the coarsest level with ``R``
    patience, then project + refine each level with ``refine_R`` patience
    (default ``max(3, m)`` — the GLAD-E incremental setting) under a
    boundary-active mask.  Every solve is a plain :func:`glad_s` call
    (batched sweep), so all engine knobs compose per level.

    ``chunk_vertices`` streams the coarsening (bounded vertex windows, see
    :func:`build_levels`).  ``session`` — a
    :class:`repro_torch.core.engine.LayoutSession` — supplies a persistent
    :class:`LevelStack` for this V-cycle configuration (reused matchings
    across relayouts of the same graph) and is adopted by the FINEST
    refinement solve (same graph as the session's flat engine; coarse
    levels always run fresh per-level engines).  ``record_levels=False``
    slims the per-level telemetry to checksums + sizes
    (:func:`_slim_level_stats`) so scale runs don't retain O(levels x n)
    replay arrays.  None of the three knobs changes the trajectory — the
    assign/cost/history stream is bit-identical with any combination.

    Returns a ``GladResult`` whose ``history``/``iterations``/``accepted``
    concatenate the per-level solves and whose ``levels`` field holds one
    stats dict per solve — including each refinement's projected ``init``
    and ``active`` mask (under ``record_levels=True``), so callers can
    replay any level on the flat engine bit-for-bit (the golden-fixture
    contract).  ``result.coarsen`` reports the LevelStack's reuse stats
    when a session was supplied.
    """
    from repro_torch.core.glad_s import GladResult, glad_s   # lazy: import cycle

    t0 = time.perf_counter()
    coarsen_stats = None
    if session is not None:
        lstack = session.level_stack(coarsen_to=coarsen_to,
                                     max_levels=levels, mu_gate=mu_gate)
        stack = lstack.acquire(cm, chunk_vertices=chunk_vertices)
        coarsen_stats = dict(lstack.last_stats, builds=lstack.builds,
                             refreshes=lstack.refreshes)
    else:
        stack = build_levels(cm, coarsen_to=coarsen_to, max_levels=levels,
                             mu_gate=mu_gate, chunk_vertices=chunk_vertices)
    flat_kw = dict(backend=backend, sweep="batched",
                   round_solver=round_solver, workers=workers,
                   worker_mode=worker_mode, cache=cache, warm=warm,
                   max_iterations=max_iterations,
                   on_iteration=on_iteration, multilevel=False)
    n0 = cm.graph.n
    if len(stack) == 1:
        # Nothing to coarsen (tiny graph / no links): flat solve, annotated.
        res = glad_s(cm, R=R, init=init, seed=seed, cache_bytes=cache_bytes,
                     chunk_nodes=chunk_nodes, session=session, **flat_kw)
        stats = dict(level=0, role="coarsest", n=n0,
                     edges=cm.graph.num_edges, init=init, active=None,
                     R=R, cost=res.cost, iterations=res.iterations,
                     accepted=res.accepted, history=list(res.history),
                     wall_time_s=res.wall_time_s)
        res.levels = [stats if record_levels else _slim_level_stats(stats)]
        res.coarsen = coarsen_stats
        return res

    # Restrict a provided warm init down the stack (majority vote per rung).
    coarse_init = None
    if init is not None:
        coarse_init = np.asarray(init, dtype=np.int64)
        for lvl in stack[1:]:
            coarse_init = restrict_assign(
                lvl.cluster_of, lvl.cm.graph.n, coarse_init, cm.net.m)

    level_stats: List[dict] = []
    top = stack[-1]
    cb, cn = _level_knobs(top.cm.graph.n, n0, cache_bytes, chunk_nodes)
    res = glad_s(top.cm, R=R, init=coarse_init, seed=seed, cache_bytes=cb,
                 chunk_nodes=cn, **flat_kw)
    assign = res.assign
    history = list(res.history)
    iters, accepted = res.iterations, res.accepted
    stats = dict(
        level=len(stack) - 1, role="coarsest", n=top.cm.graph.n,
        edges=top.cm.graph.num_edges, init=coarse_init, active=None, R=R,
        cost=res.cost, iterations=res.iterations, accepted=res.accepted,
        history=list(res.history), wall_time_s=res.wall_time_s)
    level_stats.append(stats if record_levels else _slim_level_stats(stats))

    if refine_R is None:
        refine_R = max(3, cm.net.m)
    # Streamed session-free V-cycles own their coarse levels outright, so
    # the descent can release each level's derived caches (CSR views +
    # unary — lazily rebuilt, bitwise identical) the moment its assignment
    # has been projected down: at most two adjacent levels stay cached,
    # keeping refinement's peak RSS on the same bounded footing as the
    # streamed build.  A session's LevelStack keeps its caches — that is
    # its memory-for-refresh-speed trade.
    release_coarse = chunk_vertices is not None and session is None
    for k in range(len(stack) - 2, -1, -1):
        lvl = stack[k]
        proj = assign[stack[k + 1].cluster_of]
        act = boundary_active(lvl.cm.graph, proj, hops=refine_hops)
        stats = dict(level=k, role="refine", n=lvl.cm.graph.n,
                     edges=lvl.cm.graph.num_edges, init=proj, active=act,
                     R=refine_R)
        if not act.any():
            # Projection has no cut links at this level: nothing to refine.
            assign = proj
            stats.update(cost=float(lvl.cm.total(proj)), iterations=0,
                         accepted=0, history=[], wall_time_s=0.0)
            level_stats.append(stats if record_levels
                               else _slim_level_stats(stats))
            if release_coarse:
                from repro_torch.core.multilevel_stream import release_level_views
                release_level_views(stack[k + 1])
            continue
        cb, cn = _level_knobs(lvl.cm.graph.n, n0, cache_bytes, chunk_nodes)
        # Only the finest refinement shares the session's graph, so only
        # it adopts the persistent engine; coarse levels run fresh
        # per-level engines (a rebind across level sizes cannot exist).
        r = glad_s(lvl.cm, R=refine_R, init=proj, active=act, seed=seed,
                   cache_bytes=cb, chunk_nodes=cn,
                   session=session if k == 0 else None, **flat_kw)
        assign = r.assign
        history.extend(r.history)
        iters += r.iterations
        accepted += r.accepted
        stats.update(cost=r.cost, iterations=r.iterations,
                     accepted=r.accepted, history=list(r.history),
                     wall_time_s=r.wall_time_s)
        level_stats.append(stats if record_levels
                           else _slim_level_stats(stats))
        if release_coarse:
            from repro_torch.core.multilevel_stream import release_level_views
            release_level_views(stack[k + 1])

    f = cm.factors(assign)
    moved = (np.flatnonzero(assign != np.asarray(init, dtype=np.int64))
             if init is not None else np.arange(n0, dtype=np.int64))
    return GladResult(
        assign=assign, cost=f["total"], history=history, iterations=iters,
        accepted=accepted, wall_time_s=time.perf_counter() - t0, factors=f,
        moved=moved, levels=level_stats, coarsen=coarsen_stats,
    )
