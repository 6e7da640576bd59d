"""Request-driven GNN serving over the live ShardPlan (paper Sec. II-A).

The torch counterpart of ``repro.gnn.serving``.  The paper's target
workload is a resident service answering streams of per-user requests, each
touching only the small k-hop ego subgraph of its target vertex:

  * :func:`extract_ego` / :func:`extract_ego_batch` — batched k-hop
    ego-subgraph extraction with node/arc counts padded to power-of-2
    buckets; copied line for line from the reference.
  * :func:`make_ego_forward` — the batched ego inference on the device,
    running the port's unmodified layer functions over the flattened union
    graph with the deterministic :func:`segment_sum`.  With full fanout the
    target rows reproduce the whole-graph forward.
  * :class:`FeatureCache` — per-server cache of remote feature rows with
    TinyLFU-lite admission; copied from the reference.
  * :class:`GNNServeEngine` — queue -> batch -> extract -> forward ticks
    over the LIVE plan (homes from ``plan.assign`` at tick time, caches
    re-seeded when ``plan.version`` moves), with the same locality ledger as
    the reference and p50/p99 latency.
  * :func:`serving_cost` / :func:`replicate_for_stream` — the analytic
    per-request serving cost of a layout under distributed ego execution,
    and the stream-weighted move-vs-replicate greedy that feeds
    ``set_replication``; host code copied from the reference.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.gnn.models import _LAYERS, GNNConfig, segment_sum
from repro_torch.gnn.plan import ShardPlan
from repro_torch.graphs.datagraph import DataGraph, csr_multirange


def _pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


# ------------------------------------------------------------ request streams
def zipf_requests(n: int, num_requests: int, s: float = 1.1,
                  seed: int = 0) -> np.ndarray:
    """Zipf-skewed request targets: vertex popularity follows rank^-s over
    a seeded random rank permutation (the hot set is not id-correlated)."""
    rng = np.random.default_rng(seed)
    ranks = rng.permutation(n)
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    p = np.empty(n, dtype=np.float64)
    p[ranks] = w / w.sum()
    return rng.choice(n, size=num_requests, p=p).astype(np.int64)


def request_traffic(n: int, targets: np.ndarray, smooth: float = 0.0,
                    graph: Optional[DataGraph] = None,
                    hops: int = 0) -> np.ndarray:
    """Traffic weights for ``CostModel(traffic=...)``, normalized to MEAN 1.

    With ``graph``/``hops``, each request's count propagates to every
    vertex of its ``hops``-ego — the number of request egos that TOUCH a
    vertex, which is exactly the weight its compute row carries under
    distributed ego execution (see :func:`serving_cost`).  Without, it is
    the plain requests/target histogram.  Mean-1 normalization keeps the
    traffic-aware C_P on the same scale as the blind one, so aware and
    blind layout costs stay comparable.  ``smooth`` adds a uniform floor
    (cold vertices keep a nonzero compute row)."""
    targets = np.asarray(targets, dtype=np.int64)
    if graph is not None and hops > 0:
        counts = np.zeros(n, dtype=np.float64)
        uniq, cnt = np.unique(targets, return_counts=True)
        for v, c in zip(uniq, cnt):
            nodes, _, _ = extract_ego(graph, int(v), hops)
            counts[nodes] += float(c)
    else:
        counts = np.bincount(targets, minlength=n).astype(np.float64)
    counts += float(smooth)
    mean = counts.mean()
    return counts / mean if mean > 0 else np.ones(n)


def link_traffic(graph: DataGraph, targets: np.ndarray, hops: int,
                 fanout: Optional[int] = None,
                 smooth: float = 0.0) -> np.ndarray:
    """Per-LINK ego-crossing histogram, mean-1 normalized — the edge-weight
    side of a traffic-aware layout.

    A request's remote ego rows are fetched across the links its ego
    spans, so the number of request egos containing a link is the weight
    its cut cost carries under serving.  Feed the product
    ``graph.weights_or_ones() * link_traffic(...)`` into a graph copy
    (``dataclasses.replace(graph, edge_weights=...)``) and GLAD's pairwise
    C_T term prices exactly that: hot neighborhoods get pulled onto one
    server, which is what the fetch term of :func:`serving_cost` rewards.
    (The unary side is :func:`request_traffic`; the serving bench composes
    both.)"""
    e = graph.edges
    counts = np.zeros(len(e), dtype=np.float64)
    if len(e):
        keys = e[:, 0] * graph.n + e[:, 1]            # canonical lo < hi
        order = np.argsort(keys)
        skeys = keys[order]
        uniq, cnt = np.unique(np.asarray(targets, dtype=np.int64),
                              return_counts=True)
        for v, c in zip(uniq, cnt):
            _, arcs, _ = extract_ego(graph, int(v), hops, fanout)
            if not len(arcs):
                continue
            k = arcs.min(axis=1) * graph.n + arcs.max(axis=1)
            eids = np.unique(order[np.searchsorted(skeys, k)])
            counts[eids] += float(c)
    counts += float(smooth)
    mean = counts.mean()
    return counts / mean if mean > 0 else np.ones(len(e))


# ------------------------------------------------------------- ego extraction
def extract_ego(graph: DataGraph, target: int, hops: int,
                fanout: Optional[int] = None):
    """k-hop ego subgraph of ``target``: (nodes, arcs, depth).

    ``nodes`` (global ids, ``nodes[0] == target``) are the vertices within
    ``hops``; ``arcs`` (global (src, dst)) are ALL incoming arcs of every
    node at depth < hops — exactly what a ``hops``-layer GNN needs to
    reproduce the whole-graph output at the target (depth-``hops`` nodes
    contribute raw features only, so they carry no arcs).  Per-destination
    arcs are contiguous in ascending src order — the same summation order
    as the full-graph ``directed_edges`` path, which is what makes the ego
    forward bit-match the oracle.  ``fanout`` truncates each node's
    neighbor list to its first ``fanout`` entries (ascending-id prefix —
    deterministic sampling; ``None`` / >= max degree is exact)."""
    indptr, indices = graph.indptr, graph.indices
    visited = np.zeros(graph.n, dtype=bool)
    visited[target] = True
    nodes = [np.array([target], dtype=np.int64)]
    depths = [np.zeros(1, dtype=np.int64)]
    srcs, dsts = [], []
    frontier = np.array([target], dtype=np.int64)
    for d in range(hops):
        if not len(frontier):
            break
        flat, rep = csr_multirange(indptr, frontier)
        nbrs = indices[flat]
        if fanout is not None and len(nbrs):
            counts = indptr[frontier + 1] - indptr[frontier]
            within = (np.arange(len(flat))
                      - np.repeat(np.cumsum(counts) - counts, counts))
            keep = within < fanout
            nbrs, rep = nbrs[keep], rep[keep]
        srcs.append(nbrs.astype(np.int64))
        dsts.append(frontier[rep])
        new = np.unique(nbrs[~visited[nbrs]])
        if len(new):
            visited[new] = True
            nodes.append(new.astype(np.int64))
            depths.append(np.full(len(new), d + 1, dtype=np.int64))
        frontier = new.astype(np.int64)
    all_nodes = np.concatenate(nodes)
    all_depth = np.concatenate(depths)
    if srcs:
        arcs = np.stack([np.concatenate(srcs), np.concatenate(dsts)], axis=1)
    else:
        arcs = np.zeros((0, 2), dtype=np.int64)
    return all_nodes, arcs, all_depth


@dataclasses.dataclass
class EgoBatch:
    """Flattened disjoint union of B ego subgraphs, bucket-padded.

    Local flat id of request b's i-th node is ``b * node_cap + i`` (target
    always slot 0); ``arcs`` pads point at the ``dummy`` row, whose
    aggregation lands in a segment the forward slices off."""

    nodes: np.ndarray        # (B, node_cap) global ids, -1 pad
    arcs: np.ndarray         # (arc_cap, 2) int32 LOCAL flat (src, dst)
    targets: np.ndarray      # (B,) global ids, -1 = empty slot
    num_nodes: np.ndarray    # (B,) real nodes per request
    num_arcs: int            # real arcs (before bucket padding)
    hops: int
    fanout: Optional[int]

    @property
    def batch(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def node_cap(self) -> int:
        return int(self.nodes.shape[1])

    @property
    def dummy(self) -> int:
        return self.batch * self.node_cap


def extract_ego_batch(graph: DataGraph, targets: np.ndarray, hops: int,
                      fanout: Optional[int] = None,
                      batch: Optional[int] = None) -> EgoBatch:
    """Batched extraction with bucketed shapes: ``node_cap`` (per-request
    node slots) and the arc count are padded to power-of-2 buckets, and the
    batch dimension to ``batch`` (short final batches pad with empty
    requests, target -1)."""
    targets = np.asarray(targets, dtype=np.int64)
    B = int(batch) if batch is not None else len(targets)
    if len(targets) > B:
        raise ValueError(f"{len(targets)} targets > batch {B}")
    egos = [extract_ego(graph, int(t), hops, fanout) for t in targets]
    node_cap = _pow2(max((len(nd) for nd, _, _ in egos), default=1))
    arc_cap = _pow2(max(sum(len(a) for _, a, _ in egos), 1))
    nodes = np.full((B, node_cap), -1, dtype=np.int64)
    num_nodes = np.zeros(B, dtype=np.int64)
    dummy = B * node_cap
    arcs = np.full((arc_cap, 2), dummy, dtype=np.int32)
    tgt = np.full(B, -1, dtype=np.int64)
    at = 0
    for b, (nd, ac, _) in enumerate(egos):
        nodes[b, : len(nd)] = nd
        num_nodes[b] = len(nd)
        tgt[b] = targets[b]
        if len(ac):
            # global -> local slot within this request (nd rows are unique).
            order = np.argsort(nd, kind="stable")
            pos = order[np.searchsorted(nd[order], ac)]
            arcs[at: at + len(ac)] = (b * node_cap + pos).astype(np.int32)
            at += len(ac)
    return EgoBatch(nodes=nodes, arcs=arcs, targets=tgt,
                    num_nodes=num_nodes, num_arcs=at, hops=hops,
                    fanout=fanout)


def ego_tables(ego: EgoBatch, features: np.ndarray, degrees: np.ndarray):
    """Device-ready arrays for an EgoBatch: the flattened feature table
    (dummy zero row last), FULL-GRAPH degree per slot (GCN/SAGE normalize
    by true degree, never by the sampled arc count), and the target rows
    (slot 0 of every request)."""
    d = features.shape[1]
    flat = np.zeros((ego.dummy + 1, d), dtype=features.dtype)
    valid = ego.nodes >= 0
    vflat = valid.reshape(-1)
    flat[: ego.dummy][vflat] = features[ego.nodes[valid]]
    deg = np.zeros(ego.dummy + 1, dtype=np.float32)
    deg[: ego.dummy][vflat] = degrees[ego.nodes[valid]]
    tgt_rows = (np.arange(ego.batch) * ego.node_cap).astype(np.int32)
    return flat, deg, tgt_rows


# -------------------------------------------------------------- ego inference
def make_ego_forward(cfg: GNNConfig, params, device: DeviceLike = "cuda"):
    """Batched ego forward on ``device``: (feats (dummy+1, s_0), arcs, deg,
    tgt_rows) -> (B, s_K) embeddings at the targets.

    Runs the UNMODIFIED layer functions of :mod:`repro_torch.gnn.models`
    over the flattened union graph with :func:`segment_sum`, so semantics
    match the whole-graph forward at the target rows.  Inputs may be numpy
    arrays or tensors; ``params`` must already live on ``device``.

    ``fwd.stats['traces']`` counts the distinct (shape, dtype) signatures
    of the four inputs the forward has seen: what the reference's jitted
    forward counts as traces over the same batches, and the number of
    shapes a captured (CUDA-graph) forward would need.  Bucketed shapes
    bound it by O(log) per dimension."""
    dev = resolve_device(device)
    layer_fn = _LAYERS[cfg.model]
    K = cfg.num_layers
    state = {"traces": 0}
    seen = set()

    def fwd(feats, arcs, deg, tgt_rows):
        args = [torch.as_tensor(a, device=dev)
                for a in (feats, arcs, deg, tgt_rows)]
        sig = tuple((tuple(a.shape), a.dtype) for a in args)
        if sig not in seen:
            seen.add(sig)
            state["traces"] += 1
        feats, arcs, deg, tgt_rows = args
        arcs, tgt_rows = arcs.long(), tgt_rows.long()
        n = feats.shape[0]
        h = feats.to(cfg.dtype)
        for k, p in enumerate(params):
            h = layer_fn(p, h, arcs, deg, n, k == K - 1, segment_sum)
        return h[tgt_rows]

    fwd.stats = state
    return fwd


# ---------------------------------------------------------------- feature DB
class FeatureCache:
    """Per-server cache of REMOTE feature rows under a byte budget.

    Admission/eviction mirror the layout engine's AssemblyCache exactly
    (TinyLFU-lite + LRU): under budget pressure a fetched row is admitted
    only when it has been touched at least twice AND strictly more often
    than the LRU victim plus one (the engine's anti-thrash margin); rows
    seeded resident (the plan's halo — they ARE the server's read set)
    bypass admission like the engine's proven-hot rebuilds."""

    def __init__(self, row_bytes: int, cache_bytes: int):
        self.row_bytes = max(int(row_bytes), 1)
        self.cache_bytes = int(cache_bytes)
        self._rows: "OrderedDict[int, None]" = OrderedDict()
        self._touches: Dict[int, int] = {}
        self._used = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rejected = 0

    @property
    def resident(self) -> int:
        return len(self._rows)

    def seed(self, ids: np.ndarray) -> None:
        """Install rows as resident (halo seeding) — bypasses admission."""
        for v in np.asarray(ids, dtype=np.int64):
            v = int(v)
            if v not in self._rows:
                self._rows[v] = None
                self._used += self.row_bytes
        self._evict()

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """Touch every id; True where resident (hit refreshes LRU)."""
        hit = np.zeros(len(ids), dtype=bool)
        for k, v in enumerate(np.asarray(ids, dtype=np.int64)):
            v = int(v)
            self._touches[v] = self._touches.get(v, 0) + 1
            if v in self._rows:
                self._rows.move_to_end(v)
                hit[k] = True
        nh = int(hit.sum())
        self.hits += nh
        self.misses += len(ids) - nh
        return hit

    def admit(self, ids: np.ndarray) -> None:
        """Offer fetched rows for residency (call after a lookup miss)."""
        for v in np.asarray(ids, dtype=np.int64):
            v = int(v)
            if v in self._rows:
                continue
            if self._admit(self._touches.get(v, 0)):
                self._rows[v] = None
                self._used += self.row_bytes
                self._evict()
            else:
                self.rejected += 1

    def _admit(self, touches: int) -> bool:
        if not self._rows or self._used + self.row_bytes <= self.cache_bytes:
            return True
        if touches < 2:
            return False
        victim = next(iter(self._rows))
        return touches > self._touches.get(victim, 0) + 1

    def _evict(self) -> None:
        while self._used > self.cache_bytes and len(self._rows) > 1:
            self._rows.popitem(last=False)
            self._used -= self.row_bytes
            self.evictions += 1


# ------------------------------------------------------------- serving engine
@dataclasses.dataclass
class ServeStats:
    requests: int = 0
    batches: int = 0
    wall_time_s: float = 0.0
    local_rows: int = 0          # ego rows owned by the home server
    replica_hit_rows: int = 0    # remote rows resident as plan replicas
    cache_hit_rows: int = 0      # remote rows served from the home's cache
    fetched_rows: int = 0        # remote rows pulled cross-server
    fetch_cost: float = 0.0      # sum tau[home, owner] over fetched rows
    plan_refreshes: int = 0      # cache re-seeds after plan.version moved

    @property
    def throughput_rps(self) -> float:
        return (self.requests / self.wall_time_s
                if self.wall_time_s > 0 else 0.0)


class GNNServeEngine:
    """Resident request service over the live partitioned graph.

    Each tick pops up to ``batch`` queued targets, extracts their ego
    subgraphs, accounts feature locality against the CURRENT
    ``plan.assign`` (home = the target's server; remote rows consult the
    plan's REPLICA table first — a replica-resident row is served from the
    home's persistent copy at zero fetch — then the home's
    :class:`FeatureCache`; misses charge ``tau[home, owner]``), and runs
    the batched ego forward on ``device``.  The plan is read live: when
    ``plan.version`` moves (a fault-runtime ``patch_plan``), caches and
    replica masks re-seed and serving continues — no rebuild of the
    engine.  Re-seeds also SNAPSHOT the per-epoch counters: ``stats``
    stays cumulative across the engine's whole life, ``epoch_stats`` /
    ``latency_percentiles(window='epoch')`` cover only the current plan
    version (throughput/p99 after a patch must not be diluted by the old
    plan's rows — the ledger before this snapshot silently mixed plans),
    and ``epoch_history`` keeps the closed epochs.  ``hops`` defaults to
    the model depth (exact receptive field); ``fanout`` bounds per-hop
    neighbors (None = exact)."""

    def __init__(self, cfg: GNNConfig, params, graph: DataGraph,
                 plan: ShardPlan, features: Optional[np.ndarray] = None,
                 hops: Optional[int] = None, fanout: Optional[int] = None,
                 batch: int = 8, cache_bytes: int = 1 << 20, net=None,
                 device: DeviceLike = "cuda"):
        self.cfg, self.params = cfg, params
        self.device = resolve_device(device)
        self.graph = graph
        self.plan = plan
        feats = features if features is not None else graph.features
        if feats is None:
            raise ValueError("serving needs vertex features")
        self.features = np.asarray(feats)
        self.hops = int(hops) if hops is not None else cfg.num_layers
        self.fanout = fanout
        self.batch = int(batch)
        self.cache_bytes = int(cache_bytes)
        self.net = net                      # optional: prices fetch_cost
        self.queue: deque = deque()         # (target, t_submit)
        self.stats = ServeStats()
        self.latencies: List[float] = []
        # Per-plan-version window: reset on every cache re-seed so the
        # post-patch report covers the new plan only.
        self.epoch_stats = ServeStats()
        self.epoch_latencies: List[float] = []
        self.epoch_history: List[dict] = []
        self.fwd = make_ego_forward(cfg, params, self.device)
        self._degrees = graph.degrees.astype(np.float32)
        self._caches: Dict[int, FeatureCache] = {}
        self._replica_mask: Dict[int, np.ndarray] = {}
        self._plan_version = -1
        self._refresh_caches()

    # ------------------------------------------------------------------ admin
    def _refresh_caches(self) -> None:
        if self._plan_version >= 0:
            self._close_epoch()
        row_bytes = self.features.shape[1] * self.features.dtype.itemsize
        self._caches = {}
        for p in range(self.plan.num_parts):
            c = FeatureCache(row_bytes, self.cache_bytes)
            halo = self.plan.halo[p]
            c.seed(halo[halo >= 0])
            self._caches[p] = c
        # Replica tier: rows the plan keeps PERSISTENTLY resident on each
        # server (read-only copies synced once per epoch, not cached
        # fetches) — consulted before the cache, never evicted.
        self._replica_mask = {}
        if getattr(self.plan, "has_replicas", False):
            for p in range(self.plan.num_parts):
                ids = self.plan.replica[p]
                m = np.zeros(self.graph.n, dtype=bool)
                m[ids[ids >= 0]] = True
                self._replica_mask[p] = m
        self._plan_version = self.plan.version

    def _close_epoch(self) -> None:
        """Archive the finished plan-version window and start a fresh one."""
        self.epoch_history.append({
            "plan_version": self._plan_version,
            "stats": self.epoch_stats,
            "latency": self.latency_percentiles(window="epoch"),
        })
        self.epoch_stats = ServeStats()
        self.epoch_latencies = []

    def cache_stats(self) -> Dict[str, int]:
        out = {"hits": 0, "misses": 0, "evictions": 0, "rejected": 0,
               "resident": 0}
        for c in self._caches.values():
            out["hits"] += c.hits
            out["misses"] += c.misses
            out["evictions"] += c.evictions
            out["rejected"] += c.rejected
            out["resident"] += c.resident
        return out

    def submit(self, targets) -> None:
        now = time.perf_counter()
        for t in np.atleast_1d(np.asarray(targets, dtype=np.int64)):
            self.queue.append((int(t), now))

    # ------------------------------------------------------------------ serve
    def _account(self, ego: EgoBatch, targets: np.ndarray) -> None:
        assign = self.plan.assign
        tau = self.net.tau if self.net is not None else None
        ledgers = (self.stats, self.epoch_stats)
        for b in range(len(targets)):
            home = int(assign[targets[b]])
            row = ego.nodes[b]
            ns = row[row >= 0]
            owners = assign[ns]
            local = owners == home
            for st in ledgers:
                st.local_rows += int(local.sum())
            remote = ns[~local]
            if not len(remote):
                continue
            rmask = self._replica_mask.get(home)
            if rmask is not None:
                rhit = rmask[remote]
                for st in ledgers:
                    st.replica_hit_rows += int(rhit.sum())
                remote = remote[~rhit]
                if not len(remote):
                    continue
            cache = self._caches[home]
            hit = cache.lookup(remote)
            for st in ledgers:
                st.cache_hit_rows += int(hit.sum())
            missed = remote[~hit]
            fc = (float(tau[home, assign[missed]].sum())
                  if tau is not None and len(missed) else 0.0)
            for st in ledgers:
                st.fetched_rows += len(missed)
                st.fetch_cost += fc
            cache.admit(missed)

    def tick(self) -> Optional[np.ndarray]:
        """Serve one batch off the queue; returns (served, s_K) embeddings
        in pop order, or None when idle."""
        if not self.queue:
            return None
        if self._plan_version != self.plan.version:
            self._refresh_caches()
            self.stats.plan_refreshes += 1
        t0 = time.perf_counter()
        take = min(self.batch, len(self.queue))
        items = [self.queue.popleft() for _ in range(take)]
        targets = np.array([t for t, _ in items], dtype=np.int64)
        ego = extract_ego_batch(self.graph, targets, self.hops, self.fanout,
                                batch=self.batch)
        self._account(ego, targets)
        feats, deg, tgt_rows = ego_tables(ego, self.features, self._degrees)
        out = self.fwd(feats, ego.arcs, deg, tgt_rows).cpu().numpy()
        now = time.perf_counter()
        for st in (self.stats, self.epoch_stats):
            st.wall_time_s += now - t0
            st.batches += 1
            st.requests += take
        for _, ts in items:
            self.latencies.append(now - ts)
            self.epoch_latencies.append(now - ts)
        return out[:take]

    def run(self, max_batches: int = 10 ** 9) -> ServeStats:
        while self.queue and self.stats.batches < max_batches:
            self.tick()
        return self.stats

    def serve(self, targets) -> np.ndarray:
        """Submit + drain synchronously; returns (len(targets), s_K)."""
        self.submit(targets)
        outs = []
        while self.queue:
            outs.append(self.tick())
        return (np.concatenate(outs, axis=0) if outs
                else np.zeros((0, self.cfg.layer_dims[-1]), np.float32))

    def latency_percentiles(self, window: str = "all") -> Dict[str, float]:
        """``window='all'``: engine lifetime; ``'epoch'``: current plan
        version only (the post-patch report)."""
        lats = self.latencies if window == "all" else self.epoch_latencies
        if not lats:
            return {"p50": 0.0, "p99": 0.0}
        arr = np.asarray(lats)
        return {"p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99))}


# ---------------------------------------------------------------- evaluation
def _replication_masks(replication, assign: np.ndarray, num_parts: int,
                       n: int):
    """(num_parts, n) bool of MATERIALIZED replicas (request minus homed)
    from a Replication / plain dict / replicated ShardPlan's request."""
    by_part = getattr(replication, "by_part", None)
    if by_part is None:
        by_part = getattr(replication, "replication", replication)
    mask = np.zeros((num_parts, n), dtype=bool)
    for p, ids in (by_part or {}).items():
        ids = np.asarray(ids, dtype=np.int64)
        ids = ids[(ids >= 0) & (ids < n)]
        mask[int(p), ids[assign[ids] != int(p)]] = True
    return mask


def serving_cost(cm, assign: np.ndarray, targets: np.ndarray, hops: int,
                 fanout: Optional[int] = None, replication=None,
                 sync_weight: float = 0.5, storage: float = 0.0) -> float:
    """Analytic serving cost of a layout under a request stream, under the
    paper's DISTRIBUTED execution model: each ego vertex aggregates at its
    own host (the BSP forward restricted to the ego — C_P of node ``u`` at
    ``assign[u]``), and every remotely-owned row ships its result to the
    target's home once, at ``tau[home, owner]``.  Summed over the stream,
    the compute term is exactly the ego-propagated
    :func:`request_traffic`-weighted unary compute row — the quantity a
    traffic-aware ``CostModel`` hands GLAD.

    ``replication`` (a ``core.Replication``, a ``{part: ids}`` dict, or a
    replicated ShardPlan) prices replica-resident rows at ZERO fetch —
    the copy already lives at the home, so only the one-time sync
    (``sync_weight * tau[owner, p]`` per materialized replica, the same
    rule as ``CostModel.replicate_greedy``) plus ``storage`` is charged,
    once per replica, independent of how many requests read it.  Compute
    stays at the owner — replication moves bytes, not FLOPs.

    Pass a traffic-BLIND CostModel: the stream itself carries the request
    weighting here, so a traffic-scaled ``cp_matrix`` would double count.
    This is the metric the serving bench uses to compare traffic-aware vs
    traffic-blind (and replicated vs move-only) layouts in the same
    window."""
    if cm.traffic is not None:
        raise ValueError("pass a traffic-blind CostModel (traffic=None)")
    assign = np.asarray(assign, dtype=np.int64)
    uniq, cnt = np.unique(np.asarray(targets, dtype=np.int64),
                          return_counts=True)
    cp, tau = cm.cp_matrix, cm.net.tau
    rmask = None
    total = 0.0
    if replication is not None:
        rmask = _replication_masks(replication, assign, cm.net.m,
                                   cm.graph.n)
        ps, vs = np.nonzero(rmask)
        total += float((sync_weight * tau[assign[vs], ps]).sum())
        total += storage * len(vs)
    for v, c in zip(uniq, cnt):
        nodes, _, _ = extract_ego(cm.graph, int(v), hops, fanout)
        h = int(assign[v])
        owners = assign[nodes]
        cost = float(cp[nodes, owners].sum())
        rn = nodes[owners != h]
        if rmask is not None and len(rn):
            rn = rn[~rmask[h, rn]]
        if len(rn):
            cost += float(tau[h, assign[rn]].sum())
        total += float(c) * cost
    return total


def replicate_for_stream(cm, assign: np.ndarray, targets: np.ndarray,
                         hops: int, fanout: Optional[int] = None,
                         sync_weight: float = 0.5, storage: float = 0.0,
                         budget: Optional[int] = None):
    """Serving-side move-vs-replicate greedy: pick the replica set that
    minimizes :func:`serving_cost` for THIS stream.

    ``CostModel.replicate_greedy`` weighs replicas against the layout's
    recurring halo traffic; under request serving the right weight is the
    stream itself — ``w(v, h)`` = requests homed at ``h`` whose ego
    contains remote row ``v``, each saving one ``tau[h, owner]`` fetch.
    Replicating v into h is again a unary decision given the layout:
    ``gain = w(v, h) * tau[h, owner] - (sync_weight * tau[owner, h] +
    storage)``; all positive-gain pairs are accepted (they are independent,
    so the greedy is exact for this overlay), ``budget`` caps replicas per
    part (highest gain first, id tie-break).  Returns a
    ``core.Replication`` ready for ``serving_cost(replication=...)`` /
    ``set_replication``."""
    from repro_torch.core.cost import Replication

    if cm.traffic is not None:
        raise ValueError("pass a traffic-blind CostModel (traffic=None)")
    assign = np.asarray(assign, dtype=np.int64)
    m, n = cm.net.m, cm.graph.n
    tau = cm.net.tau
    w = np.zeros((m, n), dtype=np.float64)      # fetch multiplicity (h, v)
    uniq, cnt = np.unique(np.asarray(targets, dtype=np.int64),
                          return_counts=True)
    for v, c in zip(uniq, cnt):
        nodes, _, _ = extract_ego(cm.graph, int(v), hops, fanout)
        h = int(assign[v])
        rn = nodes[assign[nodes] != h]
        w[h, rn] += float(c)
    owner = np.broadcast_to(assign, (m, n))
    hcol = np.arange(m)[:, None]
    gain = w * tau[hcol, owner] - (sync_weight * tau[owner, hcol] + storage)
    gain = np.where(w > 0, gain, -np.inf)
    by_part, saved_t, sync_t = {}, 0.0, 0.0
    for p in range(m):
        ids = np.flatnonzero(gain[p] > 1e-12)
        if budget is not None and len(ids) > budget:
            ids = ids[np.lexsort((ids, -gain[p, ids]))[:budget]]
            ids = np.sort(ids)
        if len(ids):
            by_part[p] = ids.astype(np.int64)
            saved_t += float((w[p, ids] * tau[p, assign[ids]]).sum())
            sync_t += float((sync_weight * tau[assign[ids], p]).sum())
    count = sum(len(v) for v in by_part.values())
    stor_t = storage * count
    return Replication(by_part=by_part,
                       gain=saved_t - sync_t - stor_t, saved=saved_t,
                       sync=sync_t, storage=stor_t,
                       sync_weight=sync_weight, storage_cost=storage)
