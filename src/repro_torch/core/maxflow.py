"""Minimum s-t cut solvers.

GLAD-S settles each server pair by a min s-t cut on an auxiliary graph
(paper Sec. IV-B; solver reference [101] Orlin O(nm)).  Two backends:

  * 'scipy'  — scipy.sparse.csgraph.maximum_flow (C implementation of
               Dinic/BFS).  scipy requires integer capacities, so float
               weights are scaled to int64 with a fixed resolution; the cut
               *partition* is exact as long as weight gaps exceed 1/SCALE.
  * 'dinic'  — pure-python Dinic with float capacities (exact, slower);
               used as fallback and as the oracle in tests.

Both return the source-side membership mask, from which GLAD's Eq. (15)
mapping derives the layout.

Round-level solving: a round-robin round of GLAD's batched sweep yields a
set of vertex-disjoint auxiliary graphs (one per disjoint server pair).
:func:`min_st_cut_csr_blocks` solves them all in ONE flow pass by gluing
the blocks at a shared source/sink — the union network decomposes into
per-block flows (every s-t path stays inside one block), so the residual
reachability from the shared source restricted to block b is exactly
block b's minimal min cut.  The scipy BFS/DFS therefore never crosses a
block boundary, and no super-arc capacity bounds (which would cost integer
resolution) are needed.  Without scipy the blocks fall back to independent
pure-python Dinic solves, optionally fanned out over a thread/process pool
(:func:`min_st_cut_many`).

The port's copy of ``repro.core.maxflow``, with ``repro`` renamed ``repro_torch``.
"""
from __future__ import annotations

from collections import deque
from typing import List, Sequence, Tuple

import numpy as np

try:
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_flow as _scipy_maxflow

    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False

_SCALE = 10 ** 7  # float -> int64 capacity resolution for the scipy backend


def _pow2_at_least(size: int) -> int:
    return 1 << int(np.ceil(np.log2(max(size, 1))))


class CutArena:
    """Reusable scratch buffers for repeated min-cut solves.

    The layout engine solves tens of thousands of small cuts per sweep; the
    per-call assembly of the merged directed edge list is served from one
    geometrically-grown arena instead of four fresh allocations per call.
    Pass the same instance to every :func:`min_st_cut` of a sweep.

    Capacity growth is MONOTONE: a request smaller than an earlier one
    returns views of the existing buffers, and a regrowth never allocates
    below the current capacity — rounds of differing dirty-pair counts
    (large round, small round, large round again) reuse one allocation.
    """

    def __init__(self):
        self._cap = 0
        self._u = self._v = self._c = self._ci = None
        # Flow-CSR scratch (block-diagonal round assembly): row pointers +
        # column/capacity arrays, grown independently of the edge buffers.
        self._rows_cap = 0
        self._nnz_cap = 0
        self._indptr = self._cols = self._caps = None

    def edge_buffers(self, size: int):
        """(u, v, c, ci) views of length ``size`` (int64/int64/f64/int64)."""
        if self._u is None or size > self._cap:
            cap = max(256, self._cap, _pow2_at_least(size))
            self._u = np.empty(cap, dtype=np.int64)
            self._v = np.empty(cap, dtype=np.int64)
            self._c = np.empty(cap, dtype=np.float64)
            self._ci = np.empty(cap, dtype=np.int64)
            self._cap = cap
        return (self._u[:size], self._v[:size], self._c[:size],
                self._ci[:size])

    def flow_csr_buffers(self, n_rows: int, nnz: int):
        """(indptr, cols, caps) views for a flow CSR with ``n_rows`` row
        pointers and ``nnz`` entries (int32/int32/f64).  Contents are
        uninitialized; ``caps`` may be clobbered by the solver."""
        if self._indptr is None or n_rows > self._rows_cap:
            self._rows_cap = max(256, self._rows_cap, _pow2_at_least(n_rows))
            self._indptr = np.empty(self._rows_cap, dtype=np.int32)
        if self._cols is None or nnz > self._nnz_cap:
            self._nnz_cap = max(1024, self._nnz_cap, _pow2_at_least(nnz))
            self._cols = np.empty(self._nnz_cap, dtype=np.int32)
            self._caps = np.empty(self._nnz_cap, dtype=np.float64)
        return (self._indptr[:n_rows], self._cols[:nnz], self._caps[:nnz])


class Dinic:
    """Textbook Dinic max-flow with adjacency arrays (float capacities)."""

    def __init__(self, n: int):
        self.n = n
        self.to: list[int] = []
        self.cap: list[float] = []
        self.head: list[list[int]] = [[] for _ in range(n)]

    def add_edge(self, u: int, v: int, cap_uv: float, cap_vu: float = 0.0):
        self.head[u].append(len(self.to))
        self.to.append(v)
        self.cap.append(cap_uv)
        self.head[v].append(len(self.to))
        self.to.append(u)
        self.cap.append(cap_vu)

    def _bfs(self, s: int, t: int) -> bool:
        self.level = [-1] * self.n
        self.level[s] = 0
        q = deque([s])
        while q:
            u = q.popleft()
            for eid in self.head[u]:
                v = self.to[eid]
                if self.cap[eid] > 1e-12 and self.level[v] < 0:
                    self.level[v] = self.level[u] + 1
                    q.append(v)
        return self.level[t] >= 0

    def _dfs(self, u: int, t: int, f: float, it: list[int]) -> float:
        if u == t:
            return f
        while it[u] < len(self.head[u]):
            eid = self.head[u][it[u]]
            v = self.to[eid]
            if self.cap[eid] > 1e-12 and self.level[v] == self.level[u] + 1:
                d = self._dfs(v, t, min(f, self.cap[eid]), it)
                if d > 1e-12:
                    self.cap[eid] -= d
                    self.cap[eid ^ 1] += d
                    return d
            it[u] += 1
        return 0.0

    def max_flow(self, s: int, t: int) -> float:
        flow = 0.0
        while self._bfs(s, t):
            it = [0] * self.n
            while True:
                f = self._dfs(s, t, float("inf"), it)
                if f <= 1e-12:
                    break
                flow += f
        return flow

    def min_cut_side(self, s: int) -> np.ndarray:
        """Source-side reachability in the residual graph (call after max_flow)."""
        side = np.zeros(self.n, dtype=bool)
        side[s] = True
        q = deque([s])
        while q:
            u = q.popleft()
            for eid in self.head[u]:
                v = self.to[eid]
                if self.cap[eid] > 1e-12 and not side[v]:
                    side[v] = True
                    q.append(v)
        return side


def _bfs_source_side(indptr, indices, data, n: int, s: int) -> np.ndarray:
    """Reachability from s over strictly-positive entries of a CSR graph.

    Frontier-vectorized BFS on raw CSR arrays: each level is one ragged
    multi-range gather, so the Python-loop count is the BFS depth
    (typically 2-4 for GLAD's auxiliary graphs), not the entry count.
    """
    from repro_torch.graphs.datagraph import csr_multirange

    side = np.zeros(n, dtype=bool)
    side[s] = True
    frontier = np.array([s], dtype=np.int64)
    while len(frontier):
        flat, _ = csr_multirange(indptr, frontier)
        if len(flat) == 0:
            break
        nxt = indices[flat][data[flat] > 0]
        nxt = nxt[~side[nxt]]
        if len(nxt) == 0:
            break
        nxt = np.unique(nxt)
        side[nxt] = True
        frontier = nxt
    return side


def _residual_source_side(mat, flow, n: int, s: int) -> np.ndarray:
    """Source-side reachability of the min cut, via the residual graph."""
    residual = mat - flow
    return _bfs_source_side(residual.indptr, residual.indices,
                            residual.data, n, s)


def min_st_cut_csr(
    n: int,
    s: int,
    t: int,
    indptr: np.ndarray,
    indices: np.ndarray,
    caps: np.ndarray,
    prescaled: bool = False,
) -> Tuple[float, np.ndarray]:
    """Min s-t cut on a caller-built CSR capacity structure (scipy backend).

    Fast path for the layout engine: the auxiliary graph's CSR arrays are
    assembled directly (int32 indices, canonical order, no duplicates),
    skipping the COO round-trip, dtype upcasting and duplicate merging of
    the generic :func:`min_st_cut`.  When the structure is *symmetric*
    (every arc's reverse is present, zero-capacity reverse arcs included —
    the engine builds it this way), scipy's flow matrix shares the input's
    sparsity exactly, so the residual is a plain elementwise array
    difference — no sparse subtraction, no format conversions.

    ``caps`` is float64; capacities are scaled to int32 with relative
    resolution 1/_SCALE exactly like the generic path.  ``caps`` is
    clobbered (scaled in place) — pass a scratch array.  With
    ``prescaled=True`` the caps already hold exact integer values (the
    persistency-peel path quantizes before reducing) and are used verbatim.
    """
    if prescaled:
        scale = 1.0
    else:
        cmax = float(caps.max()) if len(caps) else 1.0
        scale = _SCALE / max(cmax, 1e-30)
        np.multiply(caps, scale, out=caps)
        np.rint(caps, out=caps)
        np.maximum(caps, 0, out=caps)
    data = caps.astype(np.int32)
    try:
        # The engine guarantees well-formed arrays; skip csr validation
        # (check_format + index-dtype sniffing are ~20% of small solves).
        mat = csr_matrix.__new__(csr_matrix)
        mat.data = data
        mat.indices = indices
        mat.indptr = indptr
        mat._shape = (n, n)
    except Exception:  # pragma: no cover - scipy internals drift
        mat = csr_matrix((data, indices, indptr), shape=(n, n))
    res = _scipy_maxflow(mat, s, t)
    flow = res.flow
    if (np.array_equal(flow.indptr, mat.indptr)
            and np.array_equal(flow.indices, mat.indices)):
        side = _bfs_source_side(mat.indptr, mat.indices,
                                mat.data - flow.data, n, s)
    else:  # pragma: no cover - asymmetric structure / scipy internals drift
        side = _residual_source_side(mat, flow, n, s)
    return res.flow_value / scale, side


def assemble_symmetric_flow_csr(
    k: int,
    int_a: np.ndarray,
    int_b: np.ndarray,
    int_w: np.ndarray,
    theta_i: np.ndarray,
    theta_j: np.ndarray,
    arena: "CutArena | None" = None,
    presorted: bool = False,
):
    """Build the symmetric-structure flow CSR of a GLAD auxiliary network.

    Nodes 0..k-1 are the (core) members, S=k, T=k+1.  ``int_a/int_b/int_w``
    hold the internal arcs with BOTH directions present (the CSR member
    gather emits each undirected link twice).  T-links: cap(S->v)=theta_j[v]
    (cut => v lands on the sink server), cap(v->T)=theta_i[v]; the reverse
    arcs (v->S, T->v) are materialized with zero capacity so every arc's
    transpose slot exists — scipy's flow matrix then shares this sparsity
    exactly and :func:`min_st_cut_csr`'s residual is a plain array
    difference.  The structure must also be CANONICAL (sorted column
    indices, no duplicates): internal arcs are lexsorted by (row, col), and
    each member row ends with ->S(=k), ->T(=k+1), which exceed every member
    column.  Works identically for a block-diagonal union of disjoint
    auxiliary graphs glued at the shared S/T: rows of different blocks never
    reference each other's columns, so per-block sorted order is global
    sorted order.

    ``presorted=True`` skips the canonicalizing lexsort: the layout engine
    guarantees it by construction (DataGraph rows are (src, dst)-sorted and
    member-local ids are rank-monotone, so gathered arcs arrive row-grouped
    with ascending columns).

    Returns ``(n, s, t, indptr, cols, caps)`` ready for
    :func:`min_st_cut_csr`.  With ``arena``, the output arrays are views of
    reused scratch (``caps`` is clobbered by the solve).
    """
    n_int = len(int_a)
    if n_int and not presorted:
        order = np.lexsort((int_b, int_a))
        int_a = int_a[order]
        int_b = int_b[order]
        int_w = np.asarray(int_w)[order]
    int_counts = np.bincount(int_a, minlength=k)
    nnz = n_int + 4 * k
    if arena is not None:
        aux_indptr, cols, caps = arena.flow_csr_buffers(k + 3, nnz)
    else:
        aux_indptr = np.empty(k + 3, dtype=np.int32)
        cols = np.empty(nnz, dtype=np.int32)
        caps = np.empty(nnz, dtype=np.float64)
    aux_indptr[0] = 0
    np.cumsum(int_counts + 2, out=aux_indptr[1:k + 1])
    aux_indptr[k + 1] = aux_indptr[k] + k        # S row
    aux_indptr[k + 2] = aux_indptr[k + 1] + k    # T row
    S, T = k, k + 1
    ar = np.arange(k)
    row_start = aux_indptr[:k].astype(np.int64)  # of member rows
    if n_int:
        # Within-row offsets of the (already grouped) internal arcs.
        excl = np.cumsum(int_counts) - int_counts
        pos = np.arange(n_int) - np.repeat(excl, int_counts) \
            + row_start[int_a]
        cols[pos] = int_b
        caps[pos] = int_w
    t_pos = row_start + int_counts
    cols[t_pos] = S
    caps[t_pos] = 0.0
    cols[t_pos + 1] = T
    caps[t_pos + 1] = theta_i
    cols[n_int + 2 * k:n_int + 3 * k] = ar
    caps[n_int + 2 * k:n_int + 3 * k] = theta_j
    cols[n_int + 3 * k:] = ar
    caps[n_int + 3 * k:] = 0.0
    return k + 2, S, T, aux_indptr, cols, caps


def concat_flow_blocks(blocks: Sequence[tuple]):
    """Concatenate per-block auxiliary problems into one block-diagonal one.

    ``blocks``: sequence of ``(k, int_a, int_b, int_w, theta_i, theta_j)``
    with block-local node ids (internal arcs both directions).  Returns
    ``(block_ptr, int_a, int_b, int_w, theta_i, theta_j)`` with GLOBAL node
    ids, where block b's nodes occupy ``block_ptr[b]:block_ptr[b+1]`` —
    the input format of :func:`min_st_cut_csr_blocks`.
    """
    sizes = np.array([b[0] for b in blocks], dtype=np.int64)
    block_ptr = np.zeros(len(blocks) + 1, dtype=np.int64)
    np.cumsum(sizes, out=block_ptr[1:])
    int_a = [np.asarray(b[1], np.int64) + off
             for b, off in zip(blocks, block_ptr[:-1])]
    int_b = [np.asarray(b[2], np.int64) + off
             for b, off in zip(blocks, block_ptr[:-1])]
    cat = lambda xs, dt: (np.concatenate(xs) if xs else np.zeros(0, dt))  # noqa: E731
    return (
        block_ptr,
        cat(int_a, np.int64),
        cat(int_b, np.int64),
        np.concatenate([np.broadcast_to(np.asarray(b[3], np.float64),
                                        (len(b[1]),)) for b in blocks])
        if blocks else np.zeros(0, np.float64),
        cat([np.asarray(b[4], np.float64) for b in blocks], np.float64),
        cat([np.asarray(b[5], np.float64) for b in blocks], np.float64),
    )


def peel_forced(
    k: int,
    int_a: np.ndarray,
    int_b: np.ndarray,
    w_int: np.ndarray,
    th_i: np.ndarray,
    th_j: np.ndarray,
    max_rounds: int = 100_000,
):
    """Persistency reduction of a (quantized) auxiliary cut problem.

    A node whose t-link gap strictly exceeds the total capacity of its live
    internal arcs takes its cheaper side in EVERY min cut (flipping it to
    the expensive side changes any cut by ``gap - capsum > 0``), so it can
    be settled before the flow solve and its arcs absorbed into the
    neighbors' t-links (an arc to a node fixed on the source side is paid
    exactly when the neighbor lands on the sink side, and vice versa) —
    the same argument iterated until a fixed point.  This is the
    singleton reduction's generalization (``capsum = 0``) and the standard
    roof-duality/QPBO persistency for s-t cuts; on GLAD auxiliary graphs
    (t-links carry unary + boundary mass, n-links only tau_ij) it retires
    the large majority of the connected core, which is what keeps the
    scipy input — and its O(nnz) per-call conversions — small.

    All arithmetic is integer (int64 via exact float64 bincounts), applied
    AFTER the 1/_SCALE quantization, so the surviving problem's min cuts
    are exactly the full quantized problem's min cuts restricted to the
    survivors; the minimal source side (what the residual BFS returns) is
    the reduced one union the nodes forced to the source.  Stopping early
    (``max_rounds``) only peels less — every prefix of the cascade is
    exact, because each forcing step's justification is invariant under
    the later ones (monotone closure: absorbing mass only ever grows
    t-link gaps relative to live capacity).  Mutates ``th_i/th_j`` in
    place.  ``int_a`` must be sorted (arcs row-grouped by tail — the
    canonical presorted order the callers already guarantee).

    Returns ``(alive, src)``: the survivor mask and the forced-to-source
    mask (disjoint; forced-to-sink is ``~alive & ~src``).
    """
    from repro_torch.graphs.datagraph import csr_multirange

    alive = np.ones(k, dtype=bool)
    src = np.zeros(k, dtype=bool)
    # Arcs arrive row-grouped by tail (the canonical presorted order), so a
    # bincount + cumsum gives per-node arc slices; capsum is maintained
    # incrementally — the whole peel is O(k + arcs) total, frontier rounds
    # only touch the neighbors of freshly forced nodes.
    counts = np.bincount(int_a, minlength=k)
    aptr = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(counts, out=aptr[1:])
    capsum = np.bincount(int_a, weights=w_int, minlength=k).astype(np.int64)
    gap = th_j - th_i
    f_src = gap > capsum
    f_snk = -gap > capsum
    forced = np.flatnonzero(f_src | f_snk)
    src[forced] = f_src[forced]
    for _ in range(max_rounds):
        if len(forced) == 0:
            break
        alive[forced] = False
        # Absorb each dying node's arcs into its still-live neighbors: the
        # arc is cut exactly when the neighbor lands opposite the fixed
        # side.  Each undirected link has both directed copies, but only
        # the copy whose tail is the forced node is gathered here (the
        # reverse copy's tail is live), so it counts once.
        flat, _ = csr_multirange(aptr, forced)
        if len(flat) == 0:
            break
        head = int_b[flat]
        live = alive[head]
        if not live.any():
            break
        head = head[live]
        w = w_int[flat[live]]
        tail_src = src[int_a[flat[live]]]
        np.add.at(th_j, head[tail_src], w[tail_src])
        np.add.at(th_i, head[~tail_src], w[~tail_src])
        np.subtract.at(capsum, head, w)
        cand = np.unique(head)
        gap = th_j[cand] - th_i[cand]
        cs = capsum[cand]
        newly_src = gap > cs
        newly = newly_src | (-gap > cs)
        forced = cand[newly]
        src[forced] = newly_src[newly]
    return alive, src


#: Adaptive persistency-gate threshold: skip the peel when the initial
#: forced fraction of a (sub)problem falls below this — near convergence
#: almost everything survives and the peel's quantize/compact passes are
#: pure overhead.  Shared by the block solver and the warm-start router so
#: both make the same peel-vs-direct decision for the same problem.
PEEL_GATE_FRAC = 0.25


def peel_gate_fraction(k: int, int_a: np.ndarray, int_w: np.ndarray,
                       theta_i: np.ndarray, theta_j: np.ndarray) -> float:
    """Fraction of nodes the persistency peel would force IMMEDIATELY (one
    cheap float capsum pass — the first peel round, no cascade).  This is
    the adaptive gate's estimate: below :data:`PEEL_GATE_FRAC` the peel is
    skipped and the problem solved directly.  Scale-invariant per block
    (gap > capsum is preserved by any positive per-block rescaling)."""
    if k == 0:
        return 0.0
    capf = np.bincount(int_a, weights=int_w, minlength=k)
    gapf = np.abs(np.asarray(theta_j, np.float64)
                  - np.asarray(theta_i, np.float64))
    return float(np.count_nonzero(gapf > capf)) / k


class ResidualCut:
    """Warm-startable min s-t cut state over one fixed symmetric flow CSR.

    Retains the integer capacities and a maximum flow of the LAST solve of
    one auxiliary problem (fixed structure: same node count, same internal
    arcs — the engine's membership-intact regime).  A re-solve with
    perturbed capacities repairs the retained flow instead of pushing the
    whole flow again from zero:

      1. **re-quantize** the new float capacities exactly like
         :func:`min_st_cut_csr` (same cmax/scale/rint/clip op order), so the
         integer problem is the one the cold path would solve;
      2. **drain** over-saturated arcs: flow above the new capacity is
         cancelled along its own source->u and v->sink flow-carrying paths
         (integer arithmetic; the flow stays feasible and conservative, and
         flow cycles encountered on a walk are cancelled outright);
      3. **augment**: one scipy max-flow pass over the RESIDUAL network
         tops the repaired flow back up to maximal.  Near convergence the
         repaired flow is already maximal and the pass degenerates to a
         single BFS — this is where the warm start wins over re-pushing
         the full flow value.

    Exactness: the minimal source side of a min cut is UNIQUE for a given
    integer capacity vector (it is the residual reachability of ANY maximum
    flow — the lattice-minimum cut), so the warm mask is bit-identical to
    the cold path's for every perturbation sequence.  The differential fuzz
    harness (tests/test_warm_start.py) pins this against both the cold
    scipy path and the pure-python Dinic oracle.
    """

    __slots__ = ("k", "n", "s", "t", "indptr", "cols", "cap", "flow")

    #: Warm-repair gate: beyond this touched-entry fraction the drain +
    #: delta-augment repair stops beating a cold re-push, so ``resolve``
    #: resets the flow and re-solves from zero (same structure, no
    #: re-assembly) instead.
    WARM_GATE_FRAC = 0.25

    def __init__(self, k, n, s, t, indptr, cols, cap):
        self.k = int(k)
        self.n = int(n)
        self.s = int(s)
        self.t = int(t)
        self.indptr = np.ascontiguousarray(indptr)
        self.cols = np.ascontiguousarray(cols)
        self.cap = cap
        self.flow = np.zeros(len(cap), dtype=np.int64)

    @property
    def nbytes(self) -> int:
        return (self.indptr.nbytes + self.cols.nbytes
                + self.cap.nbytes + self.flow.nbytes)

    def _row_of(self, e: int) -> int:
        return int(np.searchsorted(self.indptr, e, side="right")) - 1

    def _rev_of(self, e: int, row_of_e: int) -> int:
        """Index of entry (v, u) given entry ``e`` = (u, v).  The structure
        is symmetric and canonical (columns ascending within each row), so
        the reverse entry is one binary search in row v — O(log deg) per
        LOOKED-UP arc, instead of an O(nnz log nnz) transpose permutation
        built eagerly at prime time (the drain only ever touches the
        handful of arcs on its cancellation paths)."""
        v = int(self.cols[e])
        lo, hi = int(self.indptr[v]), int(self.indptr[v + 1])
        return lo + int(np.searchsorted(self.cols[lo:hi], row_of_e))

    # -------------------------------------------------------------- internals
    @staticmethod
    def _quantize(caps: np.ndarray) -> np.ndarray:
        """Integer capacities with :func:`min_st_cut_csr`'s exact op order
        (multiply / rint / clip / int32 cast), widened for flow arithmetic.
        Clobbers ``caps``."""
        cmax = float(caps.max()) if len(caps) else 1.0
        scale = _SCALE / max(cmax, 1e-30)
        np.multiply(caps, scale, out=caps)
        np.rint(caps, out=caps)
        np.maximum(caps, 0, out=caps)
        return caps.astype(np.int32).astype(np.int64)

    @classmethod
    def prime(cls, k, int_a, int_b, int_w, theta_i, theta_j,
              prescaled: bool = False):
        """Cold solve that RETAINS its flow: assemble the symmetric CSR,
        quantize, push the max flow once, and return ``(side, state)``.
        ``side`` is bit-identical to the cold :func:`min_st_cut_csr` mask.
        Returns ``(side, None)`` if scipy's flow matrix stops sharing the
        input sparsity (internals drift) — the caller then stays cold.
        ``prescaled=True``: the inputs are already exact integers (the
        persistency-peel path quantizes before reducing) — use verbatim,
        exactly like :func:`min_st_cut_csr`'s prescaled path."""
        n, s, t, indptr, cols, caps = assemble_symmetric_flow_csr(
            k, int_a, int_b, int_w, theta_i, theta_j, presorted=True)
        cap = (caps.astype(np.int32).astype(np.int64) if prescaled
               else cls._quantize(caps))
        rc = cls(k, n, s, t, indptr.copy(), cols.copy(), cap)
        side = rc._augment_and_mask()
        if side is None:                       # pragma: no cover - drift
            n2, s2, t2, ip, co, ca = assemble_symmetric_flow_csr(
                k, int_a, int_b, int_w, theta_i, theta_j, presorted=True)
            _, full = min_st_cut_csr(n2, s2, t2, ip, co, ca,
                                     prescaled=prescaled)
            return full[:k], None
        return side, rc

    def resolve(self, int_a, int_b, int_w, theta_i, theta_j,
                prescaled: bool = False):
        """Warm re-solve with perturbed capacities on the SAME structure.

        Returns ``(side, mode)`` where mode is ``'hit'`` (integer caps
        unchanged — mask-only), ``'warm'`` (drain + delta augment) or
        ``'cold'`` (touched fraction beyond :data:`WARM_GATE_FRAC` — flow
        reset and re-pushed, still without re-building the structure).
        ``side`` is bit-identical to a cold solve in every mode."""
        k = len(np.asarray(theta_i))
        n, s, t, indptr, cols, caps = assemble_symmetric_flow_csr(
            k, int_a, int_b, int_w, theta_i, theta_j, presorted=True)
        # Full adjacency comparison, not just sizes: a same-degree member
        # swap preserves n and nnz but reorders columns, and applying the
        # new caps against the retained structure would return a silently
        # wrong mask.  O(nnz) — noise next to the assembly just done.
        if (n != self.n or len(cols) != len(self.cols)
                or not np.array_equal(cols, self.cols)
                or not np.array_equal(indptr, self.indptr)):
            raise ValueError("ResidualCut.resolve: structure changed — "
                             "re-prime instead")
        new_cap = (caps.astype(np.int32).astype(np.int64) if prescaled
                   else self._quantize(caps))
        touched = int(np.count_nonzero(new_cap != self.cap))
        self.cap = new_cap
        if touched == 0:
            # The retained flow is still a maximum flow of the identical
            # integer problem; only the mask BFS is needed.
            side = _bfs_source_side(self.indptr, self.cols,
                                    self.cap - self.flow, self.n, self.s)
            return side[:self.k], "hit"
        if touched > self.WARM_GATE_FRAC * len(new_cap):
            self.flow[:] = 0
            mode = "cold"
        else:
            self._drain()
            mode = "warm"
        side = self._augment_and_mask()
        if side is None:                       # pragma: no cover - drift
            raise RuntimeError("scipy flow sparsity drifted mid-resolve")
        return side, mode

    def _augment_and_mask(self):
        """Top the retained (feasible) flow up to maximal via one scipy
        pass over the residual network, then return the minimal-source-side
        mask over the first ``k`` nodes.  Residual capacities fit int32 by
        construction (cap <= _SCALE, |flow| <= _SCALE)."""
        res_caps = (self.cap - self.flow).astype(np.int32)
        try:
            mat = csr_matrix.__new__(csr_matrix)
            mat.data = res_caps
            mat.indices = self.cols
            mat.indptr = self.indptr
            mat._shape = (self.n, self.n)
        except Exception:  # pragma: no cover - scipy internals drift
            mat = csr_matrix((res_caps, self.cols, self.indptr),
                             shape=(self.n, self.n))
        res = _scipy_maxflow(mat, self.s, self.t)
        flow = res.flow
        if not (np.array_equal(flow.indptr, self.indptr)
                and np.array_equal(flow.indices, self.cols)):
            return None                        # pragma: no cover - drift
        self.flow += flow.data
        side = _bfs_source_side(self.indptr, self.cols,
                                self.cap - self.flow, self.n, self.s)
        return side[:self.k]

    def _drain(self):
        """Restore feasibility after capacity decreases: for every entry
        whose retained flow exceeds its new capacity, cancel the excess
        along the flow's own source->tail and head->sink paths (each
        reduction keeps the flow conservative and nonnegative; flow cycles
        met on a walk are cancelled outright, which only removes
        circulation)."""
        over = np.flatnonzero(self.flow > self.cap)
        for e in over:
            e = int(e)
            u, v = self._row_of(e), int(self.cols[e])
            while self.flow[e] > self.cap[e]:
                # The backward walk may run into v (a flow cycle through e
                # itself): seed it with v so that case cancels THROUGH e.
                back = self._flow_walk(u, self.s, incoming=True,
                                       e_entry=(e, u), cross=({v: 0}, []))
                if back is None:
                    continue                   # cancelled a cycle; retry
                carriers, nodes = back
                # The forward walk must not touch any backward-path node:
                # a shared node (hence any shared arc) closes a cycle
                # through e — cancel it instead of double-reducing the
                # shared arc below (which would drive its flow negative).
                fwd = self._flow_walk(v, self.t, incoming=False,
                                      e_entry=(e, u),
                                      cross=(nodes, carriers))
                if fwd is None:
                    continue
                fcarriers, _ = fwd
                # back + e + fwd is now a SIMPLE path (node-disjoint walks,
                # so every arc appears exactly once) — the uniform
                # reduction below keeps the flow conservative and >= 0.
                m = int(self.flow[e] - self.cap[e])
                for p, _ in carriers:
                    m = min(m, int(self.flow[p]))
                for p, _ in fcarriers:
                    m = min(m, int(self.flow[p]))
                for p, r in carriers + [(e, u)] + fcarriers:
                    self.flow[p] -= m
                    self.flow[self._rev_of(p, r)] += m

    def _cancel_cycle(self, cyc) -> None:
        """Cancel a directed flow cycle (pure circulation: removing it
        changes neither feasibility nor the flow value; when the cycle
        runs through the over-saturated entry it also reduces its
        excess).  Every cycle arc carries flow >= 1, so each cancellation
        zeroes at least one entry and retries terminate."""
        m = min(int(self.flow[p]) for p, _ in cyc)
        for p, r in cyc:
            self.flow[p] -= m
            self.flow[self._rev_of(p, r)] += m

    def _flow_walk(self, start: int, target: int, incoming: bool,
                   e_entry, cross):
        """Walk flow-carrying arcs from ``start`` to ``target`` (backward
        toward the source when ``incoming``, forward toward the sink
        otherwise).  Returns ``(carriers, nodes)``: the path's
        flow-carrying forward-direction entries as ``(entry, entry_row)``
        pairs plus the visited-node -> walk-index map; or None after
        cancelling a flow cycle found on the way (the caller retries).

        ``cross = (other_nodes, other_carriers)`` is the companion walk's
        node map and carrier prefix: stepping onto one of its nodes closes
        a directed cycle THROUGH the over-saturated entry ``e_entry``
        (other-prefix -> e -> own-path), which is cancelled outright —
        this is what keeps the final back + e + fwd composition a SIMPLE
        path in which no arc is reduced twice."""
        flow, cols, indptr = self.flow, self.cols, self.indptr
        path: list = []
        nodes = {start: 0}
        x = start
        while x != target:
            lo, hi = int(indptr[x]), int(indptr[x + 1])
            seg = flow[lo:hi]
            cand = np.flatnonzero(seg < 0 if incoming else seg > 0)
            # Conservation guarantees a flow-carrying arc exists at every
            # intermediate node of a flow path (start included: it carries
            # the over-saturated entry's flow).
            e2 = lo + int(cand[0])
            nxt = int(cols[e2])
            # The forward-direction entry actually carrying the flow: for
            # a backward step it is (nxt -> x), i.e. e2's reverse.
            carrier = (self._rev_of(e2, x), nxt) if incoming else (e2, x)
            if nxt in nodes:
                self._cancel_cycle(path[nodes[nxt]:] + [carrier])
                return None
            other_nodes, other_carriers = cross
            if nxt in other_nodes:
                self._cancel_cycle(other_carriers[:other_nodes[nxt]]
                                   + [e_entry] + path + [carrier])
                return None
            nodes[nxt] = len(path) + 1
            path.append(carrier)
            x = nxt
        return path, nodes


def peel_warm_solve(
    k: int,
    int_a: np.ndarray,
    int_b: np.ndarray,
    int_w: np.ndarray,
    theta_i: np.ndarray,
    theta_j: np.ndarray,
    residual: "ResidualCut | None" = None,
    residual_key: "np.ndarray | None" = None,
    allow_prime: bool = True,
):
    """Peel-composed warm start: quantize + persistency-peel one auxiliary
    problem exactly like the cold single-block path of
    :func:`min_st_cut_csr_blocks`, then warm-start the SURVIVOR flow solve
    from a :class:`ResidualCut` keyed by the forced set.

    The peel's forced set is a pure function of the quantized capacities,
    so when two successive solves of the same pair force the same nodes
    (the converged-but-peel-gated regime: theta perturbations small enough
    not to flip any persistency decision), the reduced problems share one
    structure and the retained residual repairs instead of re-pushing.
    ``residual_key`` is the alive mask the retained state was primed under;
    a mismatch re-primes (or solves cold when ``allow_prime`` is False).

    Returns ``(side, residual, residual_key, mode)`` with mode in
    ``'hit' | 'warm' | 'cold'``; ``side`` is bit-identical to the cold peel
    path for every input (minimal source side is unique per integer
    problem, and the peel composition is exact).
    """
    int_w = np.asarray(int_w, dtype=np.float64)
    cmax = max(float(theta_i.max()), float(theta_j.max()))
    if len(int_w):
        cmax = max(cmax, float(int_w.max()))
    scale = _SCALE / max(cmax, 1e-30)
    ti = np.maximum(np.rint(theta_i * scale), 0).astype(np.int64)
    tj = np.maximum(np.rint(theta_j * scale), 0).astype(np.int64)
    iw = np.maximum(np.rint(int_w * scale), 0).astype(np.int64)
    alive, src = peel_forced(k, int_a, int_b, iw, ti, tj)
    na = int(alive.sum())
    if na == 0:                                # peel settled every node
        return src, residual, residual_key, "cold"

    peak = max(int(ti[alive].max()), int(tj[alive].max()))
    if peak >= np.iinfo(np.int32).max:         # pragma: no cover
        # Absorbed t-links outgrew int32: solve the full quantized problem
        # (caps all <= _SCALE by construction); retained state unusable
        # this round but may match again once the spike passes.
        fti = np.maximum(np.rint(theta_i * scale), 0)
        ftj = np.maximum(np.rint(theta_j * scale), 0)
        fiw = np.maximum(np.rint(int_w * scale), 0)
        n, s, t, indptr, cols, caps = assemble_symmetric_flow_csr(
            k, int_a, int_b, fiw, fti, ftj, presorted=True)
        _, side = min_st_cut_csr(n, s, t, indptr, cols, caps,
                                 prescaled=True)
        return side[:k], residual, residual_key, "cold"

    # Compact the survivors (order-preserving — canonical arc order holds).
    new_id = np.cumsum(alive, dtype=np.int64) - 1
    keep = alive[int_a] & alive[int_b]
    ria = new_id[int_a[keep]]
    rib = new_id[int_b[keep]]
    riw = iw[keep].astype(np.float64)
    rti = ti[alive].astype(np.float64)
    rtj = tj[alive].astype(np.float64)
    if (residual is not None and residual_key is not None
            and np.array_equal(residual_key, alive)):
        try:
            rside, mode = residual.resolve(ria, rib, riw, rti, rtj,
                                           prescaled=True)
        except ValueError:
            # Same forced set but the survivor structure drifted (internal
            # arcs changed under an unchanged peel) — fall through to
            # re-prime / cold below.
            residual, residual_key = None, None
        else:
            side = src.copy()
            side[alive] = rside
            return side, residual, residual_key, mode
    if not allow_prime:
        n, s, t, indptr, cols, caps = assemble_symmetric_flow_csr(
            na, ria, rib, riw, rti, rtj, presorted=True)
        _, full_side = min_st_cut_csr(n, s, t, indptr, cols, caps,
                                      prescaled=True)
        side = src.copy()
        side[alive] = full_side[:na]
        return side, None, None, "cold"
    rside, rc = ResidualCut.prime(na, ria, rib, riw, rti, rtj,
                                  prescaled=True)
    side = src.copy()
    side[alive] = rside
    return side, rc, (alive.copy() if rc is not None else None), "cold"


def _chunk_block_spans(block_ptr: np.ndarray, chunk_nodes: int):
    """Greedily group consecutive blocks into chunks of <= ``chunk_nodes``
    nodes (a single block larger than the budget gets its own chunk).
    Returns a list of (block_lo, block_hi) index pairs into ``block_ptr``."""
    spans = []
    nb = len(block_ptr) - 1
    lo = 0
    while lo < nb:
        hi = lo + 1
        while (hi < nb
               and block_ptr[hi + 1] - block_ptr[lo] <= chunk_nodes):
            hi += 1
        spans.append((lo, hi))
        lo = hi
    return spans


def min_st_cut_csr_blocks(
    block_ptr: np.ndarray,
    int_a: np.ndarray,
    int_b: np.ndarray,
    int_w: np.ndarray,
    theta_i: np.ndarray,
    theta_j: np.ndarray,
    arena: "CutArena | None" = None,
    backend: str = "auto",
    workers: int = 0,
    worker_mode: str = "thread",
    presorted: bool = False,
    chunk_nodes: int = 0,
    peel_frac: "float | None" = None,
) -> np.ndarray:
    """Solve all blocks of a block-diagonal auxiliary flow problem at once.

    ``peel_frac``: the caller's precomputed :func:`peel_gate_fraction` for
    THESE inputs (single-block callers that already ran the gate pass it
    down so it is not recomputed).  The fraction is scale-invariant per
    block, so pre-normalization values are valid.

    Block b's nodes are the global ids ``block_ptr[b]:block_ptr[b+1]``;
    ``int_a/int_b/int_w`` are its internal arcs in global ids (both
    directions present), ``theta_i/theta_j`` the t-link capacities per node.
    Blocks share no arcs (vertex-disjoint server pairs), so the union glued
    at one shared source/sink decomposes exactly: one scipy max-flow pass
    solves every block, and the residual BFS from the shared source never
    crosses a block boundary.  Returns the concatenated source-side mask
    over all ``block_ptr[-1]`` nodes (True = source server of the node's
    own block).

    ``chunk_nodes > 0`` bounds the glued-union working set: consecutive
    blocks are grouped into chunks of at most that many nodes and each chunk
    is glued + solved separately (per-block integer quantization is
    unchanged, so the cut masks are bit-identical to the single glued
    pass).  This is what keeps large rounds cache-resident — one 50k-node
    union outgrows L2 and loses to per-pair solving, bounded chunks do not.
    With ``workers > 1`` the chunk solves are fanned out over a
    thread/process pool (:func:`min_st_cut_csr_many`); note scipy's
    ``maximum_flow`` holds the GIL, so thread mode only overlaps the numpy
    assembly work and process mode pays pickling — measure before enabling.

    Without scipy (or ``backend='dinic'``) the blocks are solved
    independently by the pure-python Dinic, fanned out over ``workers``
    threads/processes when ``workers > 1`` (:func:`min_st_cut_many`).
    """
    nc = int(block_ptr[-1])
    if nc == 0:
        return np.zeros(0, dtype=bool)
    if backend == "auto":
        backend = "scipy" if _HAVE_SCIPY else "dinic"
    if backend == "scipy":
        nb = len(block_ptr) - 1
        if nb > 1:
            # Normalize every block to its own capacity maximum before the
            # shared integer scaling: blocks are arc-disjoint, so a
            # per-block constant factor cannot change a block's cut
            # partition, but it keeps each block's full 1/_SCALE relative
            # resolution when magnitudes differ across the round (a block
            # 1e6x cheaper than the round's max would otherwise quantize
            # to noise).  This reproduces the per-pair path's quantization
            # exactly: caps become round(cap / cmax_block * _SCALE).
            node_blk = np.repeat(np.arange(nb), np.diff(block_ptr))
            bmax = np.zeros(nb, dtype=np.float64)
            np.maximum.at(bmax, node_blk, theta_i)
            np.maximum.at(bmax, node_blk, theta_j)
            arc_blk = None
            if len(int_a):
                arc_blk = node_blk[int_a]
                np.maximum.at(bmax, arc_blk, int_w)
            inv = 1.0 / np.maximum(bmax, 1e-30)
            theta_i = theta_i * inv[node_blk]
            theta_j = theta_j * inv[node_blk]
            if len(int_a):
                int_w = np.asarray(int_w) * inv[arc_blk]
        int_w = np.asarray(int_w, dtype=np.float64)
        if not presorted and len(int_a):
            order = np.lexsort((int_b, int_a))
            int_a, int_b = int_a[order], int_b[order]
            int_w = int_w[order]

        # Adaptive persistency gate: one cheap float capsum pass estimates
        # how much of the union the peel would retire.  Near convergence
        # almost everything survives (boundary mass shrinks relative to
        # internal arcs) and the peel's quantize/compact passes are pure
        # overhead — take the direct float path, which solves the exact
        # same integer problem.  Early rounds force the large majority and
        # the peel pays for itself many times over.
        frac = (peel_frac if peel_frac is not None else
                peel_gate_fraction(nc, int_a, int_w, theta_i, theta_j))
        if frac < PEEL_GATE_FRAC:
            n, s, t, indptr, cols, caps = assemble_symmetric_flow_csr(
                nc, int_a, int_b, int_w, theta_i, theta_j, arena=arena,
                presorted=True)
            _, side = min_st_cut_csr(n, s, t, indptr, cols, caps)
            return side[:nc]

        # Quantize to the shared integer resolution exactly as
        # min_st_cut_csr would (same multiply/rint/clip op order), then run
        # the persistency peel in the integer domain: the surviving
        # problem's min cuts are the full quantized problem's min cuts
        # conditioned on the forced nodes, so the composed mask is
        # bit-identical to the unpeeled solve.
        cmax = max(float(theta_i.max()), float(theta_j.max()))
        if len(int_w):
            cmax = max(cmax, float(int_w.max()))
        scale = _SCALE / max(cmax, 1e-30)
        ti = np.maximum(np.rint(theta_i * scale), 0).astype(np.int64)
        tj = np.maximum(np.rint(theta_j * scale), 0).astype(np.int64)
        iw = np.maximum(np.rint(int_w * scale), 0).astype(np.int64)
        alive, src = peel_forced(nc, int_a, int_b, iw, ti, tj)
        na = int(alive.sum())
        if na == 0:                            # peel settled every node
            return src

        peak = max(int(ti[alive].max()), int(tj[alive].max()))
        if peak >= np.iinfo(np.int32).max:     # pragma: no cover
            # Absorbed t-links outgrew int32: solve the full quantized
            # problem instead (its caps are all <= _SCALE by construction).
            fti = np.maximum(np.rint(theta_i * scale), 0)
            ftj = np.maximum(np.rint(theta_j * scale), 0)
            fiw = np.maximum(np.rint(int_w * scale), 0)
            n, s, t, indptr, cols, caps = assemble_symmetric_flow_csr(
                nc, int_a, int_b, fiw, fti, ftj, arena=arena,
                presorted=True)
            _, side = min_st_cut_csr(n, s, t, indptr, cols, caps,
                                     prescaled=True)
            return side[:nc]

        # Compact the survivors (order-preserving, so the canonical arc
        # ordering carries over) and solve — chunked when the reduced union
        # still exceeds the working-set budget.
        new_id = np.cumsum(alive, dtype=np.int64) - 1
        keep = alive[int_a] & alive[int_b]
        ria = new_id[int_a[keep]]
        rib = new_id[int_b[keep]]
        riw = iw[keep].astype(np.float64)
        rti = ti[alive].astype(np.float64)
        rtj = tj[alive].astype(np.float64)
        if nb > 1:
            counts = np.bincount(node_blk[alive], minlength=nb)
            rptr = np.zeros(nb + 1, dtype=np.int64)
            np.cumsum(counts, out=rptr[1:])
        else:
            rptr = np.array([0, na], dtype=np.int64)
        rside = np.empty(na, dtype=bool)
        if chunk_nodes and nb > 1 and na > chunk_nodes:
            spans = _chunk_block_spans(rptr, int(chunk_nodes))
            arc_bounds = np.searchsorted(ria, rptr)
            if workers and workers > 1 and len(spans) > 1:
                problems = []
                for blo, bhi in spans:
                    lo, hi = int(rptr[blo]), int(rptr[bhi])
                    alo, ahi = arc_bounds[blo], arc_bounds[bhi]
                    problems.append(assemble_symmetric_flow_csr(
                        hi - lo, ria[alo:ahi] - lo, rib[alo:ahi] - lo,
                        riw[alo:ahi], rti[lo:hi], rtj[lo:hi],
                        presorted=True) + (True,))
                results = min_st_cut_csr_many(
                    problems, workers=workers, worker_mode=worker_mode)
                for (blo, bhi), (_, cside) in zip(spans, results):
                    lo, hi = int(rptr[blo]), int(rptr[bhi])
                    rside[lo:hi] = cside[:hi - lo]
            else:
                for blo, bhi in spans:
                    lo, hi = int(rptr[blo]), int(rptr[bhi])
                    alo, ahi = arc_bounds[blo], arc_bounds[bhi]
                    n, s, t, indptr, cols, caps = \
                        assemble_symmetric_flow_csr(
                            hi - lo, ria[alo:ahi] - lo,
                            rib[alo:ahi] - lo, riw[alo:ahi],
                            rti[lo:hi], rtj[lo:hi], arena=arena,
                            presorted=True)
                    _, cside = min_st_cut_csr(n, s, t, indptr, cols, caps,
                                              prescaled=True)
                    rside[lo:hi] = cside[:hi - lo]
        else:
            n, s, t, indptr, cols, caps = assemble_symmetric_flow_csr(
                na, ria, rib, riw, rti, rtj, arena=arena, presorted=True)
            _, full_side = min_st_cut_csr(n, s, t, indptr, cols, caps,
                                          prescaled=True)
            rside = full_side[:na]
        side = src.copy()
        side[alive] = rside
        return side

    # Pure-python fallback: split the arcs back per block (arcs sorted by
    # row are block-grouped — rows of block b lie in [ptr[b], ptr[b+1])).
    if presorted:
        ia, ib, iw = int_a, int_b, np.asarray(int_w)
    else:
        order = np.argsort(int_a, kind="stable")
        ia, ib = int_a[order], int_b[order]
        iw = np.asarray(int_w)[order]
    bounds = np.searchsorted(ia, block_ptr)
    problems = []
    spans = []
    for b in range(len(block_ptr) - 1):
        lo, hi = int(block_ptr[b]), int(block_ptr[b + 1])
        k = hi - lo
        if k == 0:
            continue
        alo, ahi = bounds[b], bounds[b + 1]
        n_int = ahi - alo
        S, T = k, k + 1
        us = np.empty(2 * k + n_int, dtype=np.int64)
        vs = np.empty(2 * k + n_int, dtype=np.int64)
        caps_uv = np.empty(2 * k + n_int, dtype=np.float64)
        caps_vu = np.zeros(2 * k + n_int, dtype=np.float64)
        us[:k] = S
        vs[:k] = np.arange(k)
        caps_uv[:k] = theta_j[lo:hi]
        us[k:2 * k] = np.arange(k)
        vs[k:2 * k] = T
        caps_uv[k:2 * k] = theta_i[lo:hi]
        us[2 * k:] = ia[alo:ahi] - lo
        vs[2 * k:] = ib[alo:ahi] - lo
        caps_uv[2 * k:] = iw[alo:ahi]
        problems.append((k + 2, S, T, us, vs, caps_uv, caps_vu))
        spans.append((lo, hi, k))
    results = min_st_cut_many(problems, backend="dinic", workers=workers,
                              worker_mode=worker_mode)
    side = np.zeros(nc, dtype=bool)
    for (lo, hi, k), (_, blk_side) in zip(spans, results):
        side[lo:hi] = blk_side[:k]
    return side


def _solve_one_cut(problem: tuple, backend: str = "dinic"):
    """Top-level (picklable) worker for :func:`min_st_cut_many`."""
    n, s, t, us, vs, caps_uv, caps_vu = problem
    return min_st_cut(n, s, t, us, vs, caps_uv, caps_vu, backend=backend)


def _solve_one_cut_csr(problem: tuple):
    """Top-level (picklable) worker for :func:`min_st_cut_csr_many`."""
    n, s, t, indptr, cols, caps = problem[:6]
    prescaled = bool(problem[6]) if len(problem) > 6 else False
    return min_st_cut_csr(n, s, t, indptr, cols, caps, prescaled=prescaled)


def _pool_map(fn, problems: Sequence[tuple], workers: int,
              worker_mode: str) -> list:
    import concurrent.futures as cf
    pool_cls = (cf.ProcessPoolExecutor if worker_mode == "process"
                else cf.ThreadPoolExecutor)
    with pool_cls(max_workers=int(workers)) as pool:
        return list(pool.map(fn, problems))


def min_st_cut_csr_many(
    problems: Sequence[tuple],
    workers: int = 0,
    worker_mode: str = "thread",
) -> List[Tuple[float, np.ndarray]]:
    """Solve independent pre-assembled CSR cut problems ``(n, s, t, indptr,
    cols, caps)`` (the scipy fast path), optionally over a ``workers``
    thread/process pool — the CSR counterpart of :func:`min_st_cut_many`,
    used by the chunked block solver's fan-out.  ``caps`` arrays are
    clobbered; results are returned in input order.

    The problems must be INDEPENDENTLY OWNED: arena-backed assembly views
    share one scratch buffer, so accumulating several
    :func:`assemble_symmetric_flow_csr` results built on the same arena
    silently turns every problem into the last one (and the in-place
    capacity scaling clobbers across problems).  That aliasing is detected
    here and raised loudly — in any worker mode, since serial execution
    corrupts the same way, just one solve later."""
    caps = [np.asarray(p[5]) for p in problems]
    for a in range(len(caps)):
        for b in range(a + 1, len(caps)):
            # bounds-based check: exact for the contiguous slices the
            # assembly produces, and cheap enough to run unconditionally
            if np.may_share_memory(caps[a], caps[b]):
                raise ValueError(
                    "min_st_cut_csr_many: problems share capacity memory "
                    f"(problems {a} and {b}) — assemble each problem into "
                    "owned arrays (no shared arena) before batching")
    if workers and workers > 1 and len(problems) > 1:
        return _pool_map(_solve_one_cut_csr, problems, workers, worker_mode)
    return [_solve_one_cut_csr(p) for p in problems]


def min_st_cut_many(
    problems: Sequence[tuple],
    backend: str = "dinic",
    workers: int = 0,
    worker_mode: str = "thread",
) -> List[Tuple[float, np.ndarray]]:
    """Solve independent cut problems ``(n, s, t, us, vs, caps_uv,
    caps_vu)``, optionally in a pool of ``workers`` threads or processes
    (``worker_mode``) — the fan-out primitive behind a round's disjoint
    blocks.  ``backend`` may be ``'dinic'`` (pure python, the no-scipy
    fallback) or ``'scipy'``.  Results are returned in input order."""
    if workers and workers > 1 and len(problems) > 1:
        import functools
        return _pool_map(functools.partial(_solve_one_cut, backend=backend),
                         problems, workers, worker_mode)
    return [_solve_one_cut(p, backend=backend) for p in problems]


def min_st_cut(
    n: int,
    s: int,
    t: int,
    edges_u: np.ndarray,
    edges_v: np.ndarray,
    caps_uv: np.ndarray,
    caps_vu: np.ndarray,
    backend: str = "auto",
    arena: CutArena | None = None,
) -> Tuple[float, np.ndarray]:
    """Solve min s-t cut on a directed-capacity graph.

    Args:
      n: node count (s, t included).
      edges_u/v: endpoints; caps_uv/vu: directed capacities per edge row.
      backend: 'scipy' | 'dinic' | 'auto'.
      arena: optional reusable scratch (see :class:`CutArena`) for callers
        that solve many cuts in a loop.

    Returns:
      (cut_value, source_side_mask) with mask[s]=True, mask[t]=False.
    """
    edges_u = np.asarray(edges_u, dtype=np.int64)
    edges_v = np.asarray(edges_v, dtype=np.int64)
    caps_uv = np.asarray(caps_uv, dtype=np.float64)
    caps_vu = np.asarray(caps_vu, dtype=np.float64)
    if backend == "auto":
        backend = "scipy" if _HAVE_SCIPY else "dinic"

    if backend == "scipy":
        # Merge parallel directed edges; scale to int64.  The scale adapts
        # to the largest capacity so huge costs (e.g. congestion-priced
        # layouts) cannot overflow: resolution is relative, and the cut
        # PARTITION is exact as long as gaps exceed max_cap/_SCALE.
        E = len(edges_u)
        if arena is not None:
            u, v, c, ci = arena.edge_buffers(2 * E)
            u[:E], u[E:] = edges_u, edges_v
            v[:E], v[E:] = edges_v, edges_u
            c[:E], c[E:] = caps_uv, caps_vu
        else:
            u = np.concatenate([edges_u, edges_v])
            v = np.concatenate([edges_v, edges_u])
            c = np.concatenate([caps_uv, caps_vu])
            ci = np.empty_like(u)
        cmax = float(c.max()) if len(c) else 1.0
        scale = _SCALE / max(cmax, 1e-30)
        np.multiply(c, scale, out=c)
        np.rint(c, out=c)
        np.maximum(c, 0, out=c)
        ci[:] = c
        keep = ci > 0
        mat = csr_matrix((ci[keep], (u[keep], v[keep])), shape=(n, n))
        mat.sum_duplicates()
        res = _scipy_maxflow(mat, s, t)
        side = _residual_source_side(mat, res.flow, n, s)
        return res.flow_value / scale, side

    dinic = Dinic(n)
    for u, v, cuv, cvu in zip(edges_u, edges_v, caps_uv, caps_vu):
        dinic.add_edge(int(u), int(v), float(cuv), float(cvu))
    val = dinic.max_flow(s, t)
    return val, dinic.min_cut_side(s)
