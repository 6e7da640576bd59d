"""Out-of-core multilevel coarsening: streamed matching + contraction.

The in-core coarsening materializes O(n + m) transient arrays per
round per level — the gathered CSR candidate view alone is ~10 arrays of
2m entries, which is what capped the V-cycle at n=500k / ~3GB RSS on the
reference box.  This module walks the DataGraph CSR in bounded vertex
windows (``chunk_vertices``) instead, in the style of the chunked
dispatch/shuffle pipelines used by distributed-partitioning tooling:

  matching     each round gathers one window's candidate edges at a
               time, reduces them to at most one proposal per proposer
               (the per-window reduction equals the global one because a
               proposer's whole CSR row lives in its window), and SPILLS
               the surviving proposals — 4 arrays bounded by the
               unmatched count, i.e. O(n), never O(m).  Acceptance and
               the mutual handshake then run over the spilled proposals
               exactly as in core.
  contraction  edge chunks map endpoints to clusters and spill compact
               (coarse-key, weight) pairs into key-range buckets; each
               bucket is reduced independently.  Per-key weight sums are
               bit-identical to the in-core path because a ``reduceat``
               segment sum is a pure function of the segment slice (the
               buckets only re-partition the identically-ordered key
               sequence).
  coarse model the summed-unary fold runs per cluster range, so the
               O(n x servers) permuted-unary copy never materializes.

Every function here is BIT-IDENTICAL to its in-core counterpart in
``repro_torch.core.multilevel`` for ANY window size (hypothesis-pinned,
including windows that split matched pairs): the streamed matcher
reproduces the exact proposal/acceptance winners because the in-core
lexsort reductions decompose by proposer, and all integer quantization /
mu-gate arithmetic is elementwise.  Peak transient memory becomes a knob
instead of a function of the graph.

The port's copy of ``repro.core.multilevel_stream``, with ``repro`` renamed ``repro_torch``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core.cost import CostModel
from repro_torch.core.multilevel import (
    COARSEN_TO, MATCH_ROUNDS, MAX_CLUSTER_FACTOR, STAGNATION_FRAC,
    _WQ_SCALE, Level, _mix, _quantize_scaled, clusters_from_matching,
    matching_gate,
)
from repro_torch.graphs.datagraph import (
    DataGraph, _check_cluster_key_domain, csr_multirange,
)
from repro_torch.graphs.edgenet import EdgeNetwork

#: Default streaming window (vertices per window; ``chunk_vertices='auto'``).
#: At the SIoT edge density (~4.2 links/vertex) a window's gathered
#: candidate view stays under ~50MB — small enough that per-level peak
#: RSS is dominated by the graph itself, large enough that the per-window
#: Python overhead is noise at n=2M (BENCH_layout streamed cells).
AUTO_CHUNK_VERTICES = 65536


def _resolve_chunk(chunk_vertices: "int | str | None") -> int:
    if chunk_vertices in (None, "auto"):
        return AUTO_CHUNK_VERTICES
    c = int(chunk_vertices)
    if c <= 0:
        raise ValueError(f"chunk_vertices must be positive, got {c}")
    return c


def _edge_weight_scale(graph: DataGraph) -> float:
    """Global quantization scale (``_WQ_SCALE / max weight``) without
    materializing the O(m) float copy the in-core path makes.  Mirrors
    :func:`repro_torch.core.multilevel.quantize_weights` exactly, including the
    loud non-finite/overflow refusal."""
    if graph.num_edges == 0:
        return 0.0
    if graph.edge_weights is None:
        return float(_WQ_SCALE)          # unit weights: max == 1.0
    mx = float(graph.edge_weights.max())     # nan propagates
    mn = float(graph.edge_weights.min())
    if not (np.isfinite(mx) and np.isfinite(mn)):
        # Same refusal the in-core quantize_weights makes up front, so
        # corrupt weights fail identically whether or not the bad edge
        # ever becomes a matching candidate.
        raise ValueError("non-finite edge weight entering quantization "
                         "(overflowed parallel-edge weight sum?)")
    if mx <= 0.0:
        return 0.0
    return _WQ_SCALE / mx


def matching_gate_streamed(
    graph: DataGraph,
    unary: np.ndarray,
    tau_ref: float,
    chunk_vertices: "int | str | None" = None,
) -> np.ndarray:
    """Full-CSR mu-gate bits assembled window by window.

    The output array is 1 byte per CSR entry (bools are the cheap part);
    what streaming avoids is the per-entry int64/float64 gather
    temporaries, which now peak at one window's worth."""
    chunk = _resolve_chunk(chunk_vertices)
    n = graph.n
    gate = np.empty(len(graph.indices), dtype=bool)
    pref = np.argmin(unary, axis=1).astype(np.int64)
    base = unary[np.arange(n), pref]
    indptr = graph.indptr
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        gate[indptr[a]:indptr[b]] = matching_gate(
            graph, unary, tau_ref, lo=a, hi=b, pref=pref, base=base)
    return gate


def heavy_edge_matching_streamed(
    graph: DataGraph,
    vertex_w: np.ndarray,
    max_w: int,
    unary: Optional[np.ndarray] = None,
    tau_ref: float = 0.0,
    rounds: int = MATCH_ROUNDS,
    gate: Optional[np.ndarray] = None,
    chunk_vertices: "int | str | None" = None,
) -> np.ndarray:
    """Windowed HEM, bit-identical to
    :func:`repro_torch.core.multilevel.heavy_edge_matching`.

    Why the decomposition is exact: the in-core per-round reduction
    ``lexsort((h, -cw, v))`` + head-mask picks, per PROPOSER v, the
    heaviest eligible neighbor — and every candidate of v lives in v's
    CSR row, which is wholly contained in v's window.  So per-window
    reductions produce the identical proposal list (windows ascending ==
    the in-core v-sorted order), and the acceptance pass — a pure
    function of the full proposal list — runs unchanged over the spilled
    proposals.  Spill size is bounded by the unmatched-vertex count."""
    chunk = _resolve_chunk(chunk_vertices)
    n = graph.n
    match = np.arange(n, dtype=np.int64)
    if graph.num_edges == 0:
        return match
    indptr, indices, eids = graph.indptr, graph.indices, graph.edge_ids
    scale = _edge_weight_scale(graph)
    weights = graph.edge_weights
    matched = np.zeros(n, dtype=bool)
    if gate is None and unary is not None and tau_ref > 0.0:
        gate = matching_gate_streamed(graph, unary, tau_ref,
                                      chunk_vertices=chunk)
    for _ in range(rounds):
        spill_v: List[np.ndarray] = []      # proposer
        spill_t: List[np.ndarray] = []      # target
        spill_w: List[np.ndarray] = []      # quantized link weight
        spill_h: List[np.ndarray] = []      # tie-break hash
        any_candidates = False
        any_ok = False
        for a in range(0, n, chunk):
            b = min(a + chunk, n)
            un = a + np.flatnonzero(~matched[a:b])
            if len(un) == 0:
                continue
            flat, rep = csr_multirange(indptr, un)
            if len(flat) == 0:
                continue
            any_candidates = True
            v = un[rep]
            nbr = indices[flat]
            ok = ~matched[nbr]
            ok &= vertex_w[v] + vertex_w[nbr] <= max_w
            if gate is not None:
                ok &= gate[flat]
            if not ok.any():
                continue
            any_ok = True
            v, nbr = v[ok], nbr[ok]
            if scale == 0.0:
                cw = np.zeros(len(v), dtype=np.int64)
            elif weights is None:
                cw = np.full(len(v), _WQ_SCALE, dtype=np.int64)
            else:
                cw = _quantize_scaled(
                    weights[eids[flat[ok]]].astype(np.float64), scale)
            h = _mix(v, nbr)
            # Per-proposer best candidate (heaviest, hash tie-break) —
            # exact within the window because proposers are window-local.
            order = np.lexsort((h, -cw, v))
            vs_, nb_, cw_, h_ = v[order], nbr[order], cw[order], h[order]
            head = np.ones(len(order), dtype=bool)
            head[1:] = vs_[1:] != vs_[:-1]
            spill_v.append(vs_[head])
            spill_t.append(nb_[head])
            spill_w.append(cw_[head])
            spill_h.append(h_[head])
        if not any_candidates or not any_ok:
            break
        pv = np.concatenate(spill_v)
        pt = np.concatenate(spill_t)
        pw = np.concatenate(spill_w)
        ph = np.concatenate(spill_h)
        # Acceptance: per target, heaviest incoming proposer — identical
        # to the in-core pass (the spill concatenation IS the in-core
        # proposal list: windows ascend, so pv is globally sorted).
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
        a_, b_ = cand[mutual], partner[mutual]
        if len(a_) == 0:
            break
        match[a_] = b_
        match[b_] = a_
        matched[a_] = True
        matched[b_] = True
    return match


def contract_graph_streamed(
    graph: DataGraph,
    cluster_of: np.ndarray,
    num_clusters: int,
    chunk_vertices: "int | str | None" = None,
) -> DataGraph:
    """Chunked cluster-quotient graph, bit-identical to
    :func:`repro_torch.graphs.datagraph.contract_graph`.

    Edge chunks spill compact (coarse key, weight) pairs into key-range
    buckets (split on the coarse ``lo`` endpoint); each bucket sorts and
    segment-sums independently.  Bucket outputs concatenate into the
    globally key-sorted merged edge list, and each per-key ``reduceat``
    segment holds the same weights in the same (fine edge list) order as
    the in-core global sort — so the float sums match bit for bit.  The
    O(~100B/edge) in-core transient (endpoint maps, keep mask, sort
    permutation, sorted copies) shrinks to 16B/edge of spill + one
    chunk's working set."""
    _check_cluster_key_domain(num_clusters)
    cluster_of = np.asarray(cluster_of, dtype=np.int64)
    e = graph.edges
    if len(e) == 0:
        return DataGraph(n=num_clusters, edges=np.zeros((0, 2), np.int64))
    chunk = _resolve_chunk(chunk_vertices)
    chunk_e = max(4 * chunk, 1024)
    weights = graph.edge_weights
    n_buckets = max(1, -(-len(e) // chunk_e))
    # Bucket j holds coarse keys with lo in [j*nc/B, (j+1)*nc/B).
    lo_bounds = (np.arange(1, n_buckets, dtype=np.int64)
                 * num_clusters // n_buckets)
    spill_k: List[List[np.ndarray]] = [[] for _ in range(n_buckets)]
    spill_w: List[List[np.ndarray]] = [[] for _ in range(n_buckets)]
    for s in range(0, len(e), chunk_e):
        t = min(s + chunk_e, len(e))
        cu = cluster_of[e[s:t, 0]]
        cv = cluster_of[e[s:t, 1]]
        keep = cu != cv
        if not keep.any():
            continue
        lo = np.minimum(cu[keep], cv[keep])
        hi = np.maximum(cu[keep], cv[keep])
        key = lo * num_clusters + hi
        if weights is None:
            ws = np.ones(len(key), dtype=np.float64)
        else:
            ws = weights[s:t][keep].astype(np.float64)
        if n_buckets == 1:
            spill_k[0].append(key)
            spill_w[0].append(ws)
            continue
        bucket = np.searchsorted(lo_bounds, lo, side="right")
        order = np.argsort(bucket, kind="stable")   # edge order kept per bucket
        bs = bucket[order]
        key, ws = key[order], ws[order]
        cuts = np.searchsorted(bs, np.arange(n_buckets + 1))
        for j in range(n_buckets):
            if cuts[j] < cuts[j + 1]:
                spill_k[j].append(key[cuts[j]:cuts[j + 1]])
                spill_w[j].append(ws[cuts[j]:cuts[j + 1]])
    out_edges: List[np.ndarray] = []
    out_w: List[np.ndarray] = []
    for j in range(n_buckets):
        if not spill_k[j]:
            continue
        ks_j = np.concatenate(spill_k[j])
        ws_j = np.concatenate(spill_w[j])
        spill_k[j], spill_w[j] = [], []          # release as we go
        order = np.argsort(ks_j, kind="stable")
        ks_j, ws_j = ks_j[order], ws_j[order]
        uniq, start = np.unique(ks_j, return_index=True)
        wsum = np.add.reduceat(ws_j, start)
        if not np.isfinite(wsum).all():
            raise ValueError(
                "contracted edge weight sum overflowed to non-finite; "
                "parallel-edge weights saturated the float64 domain")
        out_edges.append(
            np.stack([uniq // num_clusters, uniq % num_clusters], axis=1))
        out_w.append(wsum)
    if not out_edges:
        return DataGraph(n=num_clusters, edges=np.zeros((0, 2), np.int64))
    g = DataGraph(n=num_clusters, edges=np.concatenate(out_edges))
    g.edge_weights = np.concatenate(out_w)
    return g


def coarse_cost_model_streamed(
    cm: CostModel,
    graph_c: DataGraph,
    cluster_of: np.ndarray,
    nc: int,
    chunk_vertices: "int | str | None" = None,
) -> CostModel:
    """Chunked summed-unary fold, bit-identical to
    :func:`repro_torch.core.multilevel.coarse_cost_model`: the per-cluster
    ``reduceat`` segments see the same unary rows in the same (stable
    fine-id) order; only the O(n x servers) permuted copy is replaced by
    per-cluster-range slices."""
    chunk = _resolve_chunk(chunk_vertices)
    net = cm.net
    n = cm.graph.n
    order = np.argsort(cluster_of, kind="stable")
    starts = np.searchsorted(cluster_of[order], np.arange(nc))
    mu_c = np.empty((nc, net.m), dtype=np.float64)
    # Cluster ranges covering ~chunk members each (a range never splits a
    # cluster, so reduceat segments stay whole).
    cut_members = np.arange(chunk, n, chunk, dtype=np.int64)
    cuts = np.unique(np.concatenate([
        np.zeros(1, np.int64), np.searchsorted(starts, cut_members),
        np.asarray([nc], np.int64)]))
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        m0 = int(starts[c0])
        m1 = int(starts[c1]) if c1 < nc else n
        rows = cm.unary[order[m0:m1]]
        mu_c[c0:c1] = np.add.reduceat(rows, starts[c0:c1] - m0, axis=0)
    zeros = np.zeros(net.m, dtype=np.float64)
    net_c = EdgeNetwork(
        m=net.m, w=net.w, tau=net.tau, alpha=zeros, beta=zeros, gamma=zeros,
        rho=zeros, eps=net.eps, mu=mu_c, sku=net.sku, coords=net.coords,
    )
    return CostModel(net_c, graph_c, cm.gnn)


def coarse_vertex_w_streamed(
    cluster_of: np.ndarray,
    vertex_w: np.ndarray,
    nc: int,
    chunk_vertices: "int | str | None" = None,
) -> np.ndarray:
    """Chunked fine-vertex-count fold.  Counts are integers well inside
    float64's exact range, so partial-sum order cannot matter — the
    result equals the in-core single ``bincount`` exactly."""
    chunk = _resolve_chunk(chunk_vertices)
    acc = np.zeros(nc, dtype=np.float64)
    for a in range(0, len(cluster_of), chunk):
        b = min(a + chunk, len(cluster_of))
        acc += np.bincount(cluster_of[a:b], weights=vertex_w[a:b],
                           minlength=nc)
    return acc.astype(np.int64)


def release_level_views(level: Level) -> None:
    """Release a finished level's derived caches: the graph's CSR views and
    the cost model's unary matrix.  Both are pure deterministic functions
    of the level's primary data (edges, weights, mu) and rebuild bitwise
    identical on the next property access, so the level's CONTENT is
    untouched — only its resident footprint shrinks (CSR + unary are well
    over half a retained level at SIoT density)."""
    level.cm.graph.release_views()
    level.cm.release_unary()


def build_levels_streamed(
    cm: CostModel,
    coarsen_to: int = COARSEN_TO,
    max_levels: Optional[int] = None,
    mu_gate: bool = True,
    chunk_vertices: "int | str | None" = None,
    release_views: bool = True,
) -> List[Level]:
    """Streamed coarsening hierarchy — same levels as
    :func:`repro_torch.core.multilevel.build_levels`, bounded working set.

    ``release_views`` (default on) drops each level's derived caches (CSR
    views + unary matrix) as soon as the next-coarser level exists.  The
    hierarchy's EDGE count shrinks far slower than its vertex count (SIoT
    contraction mostly merges parallel edges late), so a fully-cached
    hierarchy retains ~40B/edge of CSR plus an ``nc x m`` unary duplicate
    of mu PER RUNG — at n=500k that is most of the build's peak RSS, and
    no amount of transient streaming can get under it.  Released views
    rebuild lazily (and bitwise identically) wherever refinement or a
    later stack refresh touches the level, so trajectories are unchanged;
    only the coarsest level keeps its caches (the V-cycle solves it
    immediately after the build).  The finest level is the CALLER's cost
    model: its caches are released too (the refine phase is the next
    consumer and rebuilds them once), which is safe for the same reason —
    engines copy values out of ``unary``, never hold the array itself.
    """
    chunk = _resolve_chunk(chunk_vertices)
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
        gate = (matching_gate_streamed(g, cur.cm.unary, tau_ref, chunk)
                if mu_gate and tau_ref > 0.0 else None)
        match = heavy_edge_matching_streamed(
            g, cur.vertex_w, cap, gate=gate, chunk_vertices=chunk)
        cluster_of, nc = clusters_from_matching(match)
        if nc >= STAGNATION_FRAC * g.n:
            break
        g_c = contract_graph_streamed(g, cluster_of, nc, chunk)
        cm_c = coarse_cost_model_streamed(cur.cm, g_c, cluster_of, nc, chunk)
        vw_c = coarse_vertex_w_streamed(cluster_of, cur.vertex_w, nc, chunk)
        levels.append(Level(cm=cm_c, cluster_of=cluster_of, vertex_w=vw_c))
        if release_views:
            release_level_views(cur)
    return levels
