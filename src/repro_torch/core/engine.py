"""Incremental pairwise min-cut layout engine (the fast path behind GLAD).

The seed implementation of Alg. 1 re-evaluated the full O(n+m) objective per
proposal and rebuilt every auxiliary graph with per-edge Python loops; at the
ROADMAP's production graph sizes the *optimizer* dominated end-to-end time.
This engine makes one Alg.-1 iteration cost O(|members| + vol(members)):

  * cached assignment state (:class:`repro_torch.core.cost.LayoutState`) turns the
    accept decision into an exact delta over moved vertices + incident links;
  * auxiliary graphs are assembled with pure array ops — global->local index
    translation via preallocated scratch vectors, incident-edge discovery via
    the CSR edge-id view (no scan of the global edge list);
  * scratch buffers (member mask, local ids, theta vectors, flow arenas) are
    allocated once and reused across iterations;
  * a *batched sweep* solves a round-robin matching of disjoint server pairs
    per round.  Disjoint pairs touch disjoint member sets, so their cuts can
    be solved from one snapshot and composed; every acceptance still uses an
    exact delta against the live state, so composing never mis-accepts.

Round -> block -> scatter pipeline (the block-diagonal round solver):

  1. **round** — :meth:`PairCutEngine.sweep_round` takes one round-robin
     matching of disjoint server pairs, skips the clean ones, and
     batch-assembles the dirty ones' auxiliary graphs in a single pass of
     array ops: one vertex->block lookup classifies every vertex, one
     ragged CSR gather yields all incident links, and per-block t-link /
     n-link weights come from vectorized gathers over the concatenated
     member list (no per-pair Python work).
  2. **block** — members without intra-pair links are settled by the
     vectorized t-link argmin; the connected cores of all blocks are packed
     into ONE block-diagonal symmetric-CSR flow problem glued at a shared
     source/sink and solved by a single scipy max-flow pass whose BFS never
     crosses block boundaries (:func:`repro_torch.core.maxflow.
     min_st_cut_csr_blocks`).  Scratch (member masks, local ids, the flow
     CSR arena) is grown once per sweep and reused across rounds.  Without
     scipy, blocks fall back to per-block pure-python Dinic solves, fanned
     out over ``workers`` threads/processes.
  3. **scatter** — each block's slice of the source-side mask maps back to
     "member stays on i / moves to j"; the proposals are then applied in
     pair order, each guarded by an exact O(moved + incident) live delta,
     so composition semantics are identical to the per-pair batched sweep.

Cross-round assembly caching (the AssemblyCache):

  Quadratic submodularity makes GLAD's auxiliary graphs *local*: pair
  (i, j)'s t-link vectors and internal arcs depend only on its member set
  and the layout of the members' neighbors.  Between two visits to the same
  pair, most of that context is unchanged — so each pair's assembled arrays
  (theta_i/theta_j, member-local CSR arc lists, connected-core
  classification, and the symmetric flow-CSR structure) are persisted in a
  per-pair :class:`AssemblyCache` entry stamped with the engine's dirty
  version.  A per-vertex epoch array (bumped for movers and their neighbors
  on every commit) tells a later solve exactly which vertices were touched
  since the entry's stamp:

    * touched set empty           -> reuse every array verbatim;
    * touched, membership intact  -> patch the touched members' theta rows
      in O(touched + their degree) — internal arcs, the singleton/core
      split and the flow-CSR *structure* are provably unchanged (an
      internal arc can only flip to boundary when an endpoint leaves the
      member set, i.e. membership changes);
    * membership changed          -> full re-assembly (stored back).

  All patched values reproduce the fresh assembly bit-for-bit (same unary
  base, same bincount accumulation order), so cached trajectories are
  identical to uncached ones.  Entries live in an LRU dict under a byte
  budget; eviction only costs the evicted pair a re-assembly.  Admission
  is frequency-gated (see :meth:`PairCutEngine._admit`): under budget
  pressure, first-touch pairs are solved but not stored, so cyclic sweeps
  whose pair universe overruns the budget keep a stable resident set
  instead of scan-thrashing.

The engine preserves the paper's auxiliary-graph semantics exactly
(Sec. IV-B: t-link = unary + side-effect traffic to third servers, n-link =
tau_ij per internal link), so Thm 4-6 continue to hold per pair.

The port's copy of ``repro.core.engine``, with ``repro`` renamed ``repro_torch``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost import CostModel
from repro_torch.core.maxflow import (_HAVE_SCIPY, PEEL_GATE_FRAC, CutArena,
                                ResidualCut, _chunk_block_spans, min_st_cut,
                                min_st_cut_csr_blocks, peel_gate_fraction,
                                peel_warm_solve)
from repro_torch.graphs.datagraph import csr_multirange

#: Default node budget for one glued block-diagonal flow union
#: (``chunk_nodes='auto'``).  Beyond this the union's working set (the
#: assembly gathers and the flow CSR together) outgrows cache and a single
#: glued pass loses to bounded chunks (the n=50k inversion); below it,
#: splitting only adds per-call scipy overhead.
AUTO_CHUNK_NODES = 8192


class _PairAssembly:
    """One pair's persisted auxiliary-graph assembly (AssemblyCache entry).

    ``members`` (ascending global ids), t-link vectors ``theta_i/theta_j``,
    member-local internal arcs (both directions, row-grouped ascending —
    the presorted canonical order), and, built lazily on first use:
    the singleton/core classification and the symmetric flow-CSR structure
    with a capacity template (int_w filled in, theta slots zero).
    ``residual`` optionally holds the pair's warm-start flow state
    (:class:`repro_torch.core.maxflow.ResidualCut`) — valid across theta patches
    (the flow structure is membership-determined), dropped on membership
    patches and rebuilds, and counted against the LRU byte budget.
    ``residual_key`` says WHICH problem the residual was primed on: None
    for the full core, else the persistency peel's alive mask (the state
    lives over the reduced survivor problem and is only reusable while the
    forced set repeats — the peel-composed warm start).
    ``stamp`` is the engine dirty-version the arrays are valid for.
    """

    __slots__ = ("members", "theta_i", "theta_j", "int_a", "int_b", "int_w",
                 "stamp", "has_int", "core", "core_int_a", "core_int_b",
                 "residual", "residual_key", "nbytes")

    def __init__(self, members, theta_i, theta_j, int_a, int_b, int_w,
                 stamp):
        self.members = members
        self.theta_i = theta_i
        self.theta_j = theta_j
        self.int_a = int_a
        self.int_b = int_b
        self.int_w = int_w
        self.stamp = stamp
        self.has_int = None
        self.core = None
        self.core_int_a = None
        self.core_int_b = None
        self.residual = None
        self.residual_key = None
        self.nbytes = (members.nbytes + theta_i.nbytes + theta_j.nbytes
                       + int_a.nbytes + int_b.nbytes + int_w.nbytes)


def round_robin_rounds(m: int) -> List[List[Tuple[int, int]]]:
    """Circle-method tournament schedule: m-1 rounds (m even; m rounds if
    odd) of vertex-disjoint pairs that jointly cover every pair i < j."""
    ids = list(range(m))
    if m % 2:
        ids.append(-1)                       # bye slot
    k = len(ids)
    rounds: List[List[Tuple[int, int]]] = []
    for _ in range(max(k - 1, 0)):
        rnd = []
        for a in range(k // 2):
            x, y = ids[a], ids[k - 1 - a]
            if x >= 0 and y >= 0:
                rnd.append((min(x, y), max(x, y)))
        rounds.append(rnd)
        ids = [ids[0], ids[-1]] + ids[1:-1]  # rotate all but the pivot
    return rounds


class PairCutEngine:
    """Stateful solver of restricted two-server subproblems over one layout.

    Owns a :class:`LayoutState` (read ``.state.assign`` / ``.state.total``)
    plus the preallocated scratch that keeps per-pair work at
    O(n bool-scan + pair member volume): the accept path is
    O(moved + incident links), auxiliary construction is proportional to
    the pair's member volume, and the only full-graph term left is the
    vectorized member scan in :meth:`members_of` — deliberate, it is
    memory-bandwidth noise next to one min-cut solve.
    """

    def __init__(
        self,
        cm: CostModel,
        assign: np.ndarray,
        active: Optional[np.ndarray] = None,
        backend: str = "auto",
        workers: int = 0,
        worker_mode: str = "thread",
        cache: "bool | str" = "auto",
        cache_bytes: int = 256 << 20,
        chunk_nodes: "int | str" = "auto",
        warm: "bool | str" = "auto",
    ):
        self.cm = cm
        self._workers = int(workers)
        self._worker_mode = worker_mode
        self.state = cm.layout_state(assign)
        # Epoch plumbing: EVERY commit that lands on the state — the
        # engine's own accept path or a caller committing directly through
        # the LayoutState API (fault-runtime warm restarts, benchmark
        # perturbations) — must bump the dirty stamps and vertex epochs, or
        # cached assemblies and warm-start residuals go silently stale.
        self.state.on_commit = self._mark_dirty
        g = cm.graph
        self._indptr = g.indptr
        self._indices = g.indices
        self._eids = g.edge_ids
        self._w = self.state._w                  # share LayoutState's copy
        self._unit_w = g.edge_weights is None    # skip weight gathers
        self._tau = cm.net.tau
        self._active = None if active is None else np.asarray(active, bool)
        self._backend = backend
        self._use_csr = _HAVE_SCIPY and backend in ("auto", "scipy")
        self._arena = CutArena()
        # Scratch, allocated once: member mask + global->local translation.
        self._mask = np.zeros(g.n, dtype=bool)
        self._loc = np.full(g.n, -1, dtype=np.int64)
        # Touched-vertex ledger: every committed mover (the engine's own
        # accepts AND external apply_assignment commits) is flagged here, so
        # callers get the run's move delta without an O(n) diff — the same
        # epoch machinery the caches ride feeds the plan-patch pipeline.
        self._moved_mask = np.zeros(g.n, dtype=bool)
        # Dirty-pair tracking: the auxiliary graph of (i, j) depends only on
        # its member set and the layout of members' neighbors, so a pair is
        # clean — its solve would reproduce the last (rejected) proposal
        # verbatim — until a commit touches one of its servers.  Clean
        # probes are skipped; this keeps the Alg.-1 trajectory bit-identical
        # while eliding most non-improving cut solves near convergence.
        self._version = 0
        self._server_dirty = np.zeros(cm.net.m, dtype=np.int64)
        self._pair_stamp: dict = {}
        # Cross-slot rebind epochs (see :meth:`rebind`): per-server (whole
        # unary column / tau row changed), per-tau-entry (internal arc
        # capacities — theta patches never repair int_w, so any touched
        # (i, j) forces a full rebuild of that pair), and per-vertex
        # STRUCTURAL (edge insert/delete/reweight — arcs can't be patched
        # either).  The scalar maxes gate the _refresh_entry checks so
        # engines that never rebind pay nothing on the hot path.
        self._server_epoch = np.zeros(cm.net.m, dtype=np.int64)
        self._struct_epoch = np.zeros(g.n, dtype=np.int64)
        self._tau_pair_epoch: Optional[np.ndarray] = None
        self._server_max = 0
        self._tau_max = 0
        self._struct_max = 0
        # Cross-round assembly cache: per-vertex epochs say when a vertex's
        # assembly-relevant context (its own slot, or a neighbor's) last
        # changed; per-pair entries stamped against them decide verbatim
        # reuse / O(touched) theta patch / incremental membership patch /
        # full re-assembly.  'auto' enables it for incremental workloads
        # (an ``active`` mask means a GLAD-E-style relayout whose touched
        # sets stay small between visits); cold full sweeps — including
        # the fault-runtime's warm-started but unmasked relayouts — churn
        # memberships too fast for per-pair reuse to beat the fused batch
        # assembly, so they cache only when explicitly asked.
        if cache == "auto":
            self._cache_on = active is not None
        else:
            self._cache_on = bool(cache)
        # Warm-start incremental max-flow: per-pair ResidualCut state rides
        # the cache entries (same per-vertex epoch keying), so warm solving
        # requires the cache.  'auto' follows the cache policy; warm=True
        # promotes cache='auto' to ON, but an explicit cache=False is a
        # contradiction worth surfacing.  Masks are bit-identical warm or
        # cold (the minimal source side is unique per integer problem), so
        # the knob only picks a schedule, never a trajectory.
        if warm == "auto":
            self._warm_on = self._cache_on
        else:
            self._warm_on = bool(warm)
            if self._warm_on and not self._cache_on:
                if cache == "auto":
                    self._cache_on = True
                else:
                    raise ValueError(
                        "warm=True requires the assembly cache "
                        "(warm state is stored on cache entries); "
                        "drop cache=False or pass warm=False")
        self._warm_on = self._warm_on and self._use_csr
        self._cache_bytes = int(cache_bytes)
        self._cache: "OrderedDict[Tuple[int, int], _PairAssembly]" = \
            OrderedDict()
        self._cache_used = 0
        # Pair-frequency admission (TinyLFU-lite): per-pair touch counts
        # back the under-pressure admission decision in _admit.
        self._touches: Dict[Tuple[int, int], int] = {}
        self._vertex_epoch = np.zeros(g.n, dtype=np.int64)
        self.cache_hits = 0          # verbatim reuse (nothing touched)
        self.cache_patched = 0       # O(touched) theta patch
        self.cache_misses = 0        # full (re-)assembly
        self.cache_evictions = 0
        self.cache_rejected = 0      # assemblies not admitted under pressure
        self.warm_hits = 0           # integer caps unchanged: mask-only BFS
        self.warm_repairs = 0        # drain + delta augment
        self.warm_cold = 0           # primed / gated back to a cold solve
        if chunk_nodes == "auto":
            chunk_nodes = AUTO_CHUNK_NODES
        self._chunk_nodes = int(chunk_nodes or 0)
        # Movable-member universe: what one full matching round can touch.
        # Drives the 'auto' round-solver policy (see :meth:`sweep_round`).
        self._universe = (int(self._active.sum())
                          if self._active is not None else g.n)

    def cache_stats(self) -> Dict[str, int]:
        return {
            "hits": self.cache_hits, "patched": self.cache_patched,
            "misses": self.cache_misses, "evictions": self.cache_evictions,
            "rejected": self.cache_rejected,
            "entries": len(self._cache), "bytes": self._cache_used,
            "warm_hits": self.warm_hits, "warm_repairs": self.warm_repairs,
            "warm_cold": self.warm_cold,
        }

    def touched_vertices(self) -> np.ndarray:
        """Vertices committed as movers at least once on this engine (a
        superset of the net movers — a vertex may move and move back)."""
        return np.flatnonzero(self._moved_mask)

    def pair_clean(self, i: int, j: int) -> bool:
        """True iff (i, j)'s auxiliary graph is unchanged since its last
        solve AND that solve did not end in an accept (an accepted solve
        dirties both servers, so clean implies last-result == reject)."""
        stamp = self._pair_stamp.get((i, j), -1)
        return stamp >= max(self._server_dirty[i], self._server_dirty[j])

    def _mark_dirty(self, moved: np.ndarray, old_servers: np.ndarray) -> None:
        """After committing ``moved``, dirty every server whose pairs could
        see a different auxiliary graph: the movers' old and new servers
        (membership changes) plus every server hosting a neighbor of a
        mover (their boundary side-effect terms reference the movers'
        layout)."""
        assign = self.state.assign
        servers = [old_servers, assign[moved]]
        flat, _ = csr_multirange(self._indptr, moved)
        if len(flat):
            servers.append(assign[self._indices[flat]])
        dirty = np.unique(np.concatenate(servers))
        self._version += 1
        self._server_dirty[dirty] = self._version
        self._moved_mask[moved] = True
        # Vertex epochs feed the AssemblyCache: a mover's own slot changed,
        # and every neighbor's boundary/t-link context references it.
        self._vertex_epoch[moved] = self._version
        if len(flat):
            self._vertex_epoch[self._indices[flat]] = self._version

    # ------------------------------------------------------------- internals
    def members_of(self, i: int, j: int) -> np.ndarray:
        assign = self.state.assign
        pair_mask = (assign == i) | (assign == j)
        if self._active is not None:
            pair_mask &= self._active
        return np.flatnonzero(pair_mask)

    # ------------------------------------------------------- assembly cache
    def _cache_entry(self, i: int, j: int) -> Optional[_PairAssembly]:
        """The pair's up-to-date assembly: verbatim reuse, O(touched)
        theta/membership patch, or full re-assembly — stored back under the
        LRU byte budget.  Returns None when the pair hosts no active
        vertices."""
        key = (i, j)
        touches = self._touches.get(key, 0) + 1
        self._touches[key] = touches
        resident = False
        e = self._cache.get(key)
        if e is not None:
            if self._refresh_entry(i, j, e):
                self._cache.move_to_end(key)
                return e
            self._cache_used -= self._entry_bytes(e)
            del self._cache[key]
            resident = True                # rebuild of a proven-hot entry
        e = self._assemble_full(i, j)
        self.cache_misses += 1
        if e is not None:
            self._ensure_core(e)           # eager: every entry gets solved
            if resident or self._admit(e.nbytes, touches):
                self._cache[key] = e
                self._cache_used += e.nbytes   # base + core bytes, while
                self._evict_over_budget()      # still resident
            else:
                # Not admitted: the assembly is still used for this solve,
                # just not stored (and never primes warm state — the
                # refreshed/allow_prime plumbing treats it as fresh).
                self.cache_rejected += 1
        return e

    def _admit(self, nbytes: int, touches: int) -> bool:
        """Pair-frequency admission (TinyLFU-lite): under budget pressure a
        fresh assembly is admitted only when the pair has been touched
        before AND more often than the LRU victim it would displace.

        Plain LRU scan-thrashes on cyclic sweeps whose pair universe
        overruns the byte budget (the n=50k flat path): every visit evicts
        the entry that is next to be reused, so the cache degrades into
        pure overhead.  Frequency admission freezes a resident set instead
        — a uniform scan stops evicting entirely, while genuinely hot
        pairs (skewed revisit patterns, GLAD-E masks) out-touch stale
        victims and still displace them.

        The required lead is TWO touches, not one: a cyclic scan touches
        the candidate before it touches the not-yet-visited LRU resident,
        so mid-scan the candidate always leads by exactly one — a margin
        of one would re-admit once per pass (thrash with extra steps).  A
        genuinely hotter pair's lead grows without bound and clears the
        margin immediately.  Admission changes WHICH pairs are cached,
        never any cached value, so trajectories remain bit-identical with
        the policy on or off."""
        if not self._cache or self._cache_used + nbytes <= self._cache_bytes:
            return True
        if touches < 2:
            return False
        victim = next(iter(self._cache))
        return touches > self._touches.get(victim, 0) + 1

    def _evict_over_budget(self) -> None:
        """LRU eviction down to the byte budget (never below one entry).
        Run after ANY ledger growth — fresh assemblies and warm-state
        primes alike; a converged re-probe sweep primes residuals on
        verbatim hits without ever taking the assembly-miss path, and
        those bytes must not silently overrun the budget."""
        while (self._cache_used > self._cache_bytes
               and len(self._cache) > 1):
            _, old = self._cache.popitem(last=False)
            self._cache_used -= self._entry_bytes(old)
            self.cache_evictions += 1

    @staticmethod
    def _entry_bytes(e: _PairAssembly) -> int:
        return e.nbytes

    def _gather_theta_rows(self, tm: np.ndarray, i: int, j: int):
        """Fresh t-link rows for members ``tm`` (member mask set in
        ``self._mask``): same unary base + one bincount in CSR row order as
        the full assembly, so the values are bit-identical to a fresh
        gather.  Also returns the gather arrays for arc extraction."""
        assign = self.state.assign
        k = len(tm)
        th_i = self.cm.unary[tm, i]
        th_j = self.cm.unary[tm, j]
        flat, rep = csr_multirange(self._indptr, tm)
        nbr_in = None
        nbr = None
        if len(flat):
            nbr = self._indices[flat]
            nbr_in = self._mask[nbr]
            bnd = ~nbr_in
            if bnd.any():
                ins = rep[bnd]
                outs = assign[nbr[bnd]]
                ti = self._tau[i, outs]
                tj = self._tau[j, outs]
                if not self._unit_w:
                    bw = self._w[self._eids[flat[bnd]]]
                    ti = ti * bw
                    tj = tj * bw
                th_i += np.bincount(ins, weights=ti, minlength=k)
                th_j += np.bincount(ins, weights=tj, minlength=k)
        return th_i, th_j, flat, rep, nbr, nbr_in

    def _refresh_entry(self, i: int, j: int, e: _PairAssembly) -> bool:
        """Bring a cached assembly up to the current version in place.

        Verbatim reuse when nothing relevant was touched; an O(touched)
        theta patch when the member set is intact; an incremental
        membership patch (retained rows copied, touched/arrived rows
        re-gathered, arc list merged) when few members changed.  All
        patched arrays are bit-identical to a fresh assembly.  Returns
        False when the entry should be rebuilt from scratch instead."""
        members = self.members_of(i, j)
        k = len(members)
        if k == 0:
            return False
        # Cross-slot rebind invalidations (scalar-gated: all the maxes
        # stay 0 on engines that never rebind).  A changed tau[i,j] /
        # tau[j,i] rescales every internal arc — beyond what any patch
        # can repair, so rebuild from scratch.
        if (self._tau_max > e.stamp
                and (self._tau_pair_epoch[i, j] > e.stamp
                     or self._tau_pair_epoch[j, i] > e.stamp)):
            return False
        # A server epoch on i or j (dense unary column repricing, or a
        # dense tau row whose (i,j)/(j,i) entries happen to be intact —
        # the gate above already caught the rest) moves whole theta
        # columns without bumping per-vertex epochs.
        col_stale = (self._server_max > e.stamp
                     and (self._server_epoch[i] > e.stamp
                          or self._server_epoch[j] > e.stamp))
        # Structural edge deltas bump BOTH endpoints' vertex epochs (see
        # rebind), so the membership patch re-derives every arc touching
        # them — only the theta-only fast path (which never rewrites arc
        # lists) must be disqualified for entries that saw struct churn.
        arc_stale = (self._struct_max > e.stamp
                     and bool((self._struct_epoch[members] > e.stamp).any()))
        tmask = self._vertex_epoch[members] > e.stamp
        same = (k == len(e.members)
                and bool(np.array_equal(members, e.members)))
        if same and not tmask.any() and not col_stale:
            self.cache_hits += 1            # struct-touched members always
            e.stamp = self._version         # carry a vertex-epoch bump, so
            return True                     # a pure hit implies !arc_stale
        if col_stale:
            # Theta COLUMNS changed (fault-loop degrade/revive repricing):
            # the internal arcs only read tau[i,j]*w, which the tau gate
            # above proved intact, so re-gathering EVERY member's theta
            # rows restores the entry exactly — and, unlike a rebuild,
            # keeps the arc lists, core classification and warm residual
            # (the warm solve re-quantizes against current capacities, so
            # a retained flow is repaired, not trusted).
            if not same or arc_stale:
                return False
            mask = self._mask
            mask[members] = True
            th_i, th_j, _, _, _, _ = self._gather_theta_rows(members, i, j)
            e.theta_i[:] = th_i
            e.theta_j[:] = th_j
            mask[members] = False
            self.cache_patched += 1
            e.stamp = self._version
            return True
        tm = members[tmask]
        if 4 * len(tm) > k:
            return False                    # patch would not beat re-gather
        mask, loc = self._mask, self._loc
        mask[members] = True
        if same and not arc_stale:
            # Membership intact => internal arcs and the singleton/core
            # split are unchanged (an internal arc only flips to boundary
            # when an endpoint leaves the member set); only the touched
            # members' t-link rows can differ.
            th_i, th_j, _, _, _, _ = self._gather_theta_rows(tm, i, j)
            rows = np.flatnonzero(tmask)
            e.theta_i[rows] = th_i
            e.theta_j[rows] = th_j
            mask[members] = False
            self.cache_patched += 1
            e.stamp = self._version
            return True
        # Membership changed (arrivals/departures are movers, so they are
        # all in the touched set).  Untouched members kept their exact
        # theta values and their arcs among themselves; everything
        # involving a touched member is re-derived from a gather of the
        # touched rows only.
        untouched = ~tmask
        pos_in_old = np.searchsorted(e.members, members[untouched])
        if (pos_in_old >= len(e.members)).any() or not bool(
                np.array_equal(e.members[pos_in_old], members[untouched])):
            # An untouched vertex missing from the old member set would
            # contradict the epoch invariant — rebuild defensively.
            mask[members] = False          # pragma: no cover
            return False                   # pragma: no cover
        loc[members] = np.arange(k)
        theta_i = np.empty(k, dtype=np.float64)
        theta_j = np.empty(k, dtype=np.float64)
        theta_i[untouched] = e.theta_i[pos_in_old]
        theta_j[untouched] = e.theta_j[pos_in_old]
        th_i, th_j, flat, rep, nbr, nbr_in = \
            self._gather_theta_rows(tm, i, j)
        trows = np.flatnonzero(tmask)
        theta_i[trows] = th_i
        theta_j[trows] = th_j
        # Old arcs between two untouched survivors carry over (remapped);
        # arcs touching a mover/arrival come from the touched-row gather —
        # the copy with an untouched tail is the gathered copy swapped.
        old_to_new = np.full(len(e.members), -1, dtype=np.int64)
        old_to_new[pos_in_old] = np.flatnonzero(untouched)
        oa = old_to_new[e.int_a]
        ob = old_to_new[e.int_b]
        keep = (oa >= 0) & (ob >= 0)
        if nbr is not None and nbr_in is not None and nbr_in.any():
            ta = trows[rep[nbr_in]]
            tb = loc[nbr[nbr_in]]
            tij = float(self._tau[i, j])
            if self._unit_w:
                tw = np.full(len(ta), tij, dtype=np.float64)
            else:
                tw = tij * self._w[self._eids[flat[nbr_in]]]
            swap = untouched[tb]
            ia = np.concatenate([oa[keep], ta, tb[swap]])
            ib = np.concatenate([ob[keep], tb, ta[swap]])
            iw = np.concatenate([e.int_w[keep], tw, tw[swap]])
        else:
            ia = oa[keep]
            ib = ob[keep]
            iw = e.int_w[keep]
        order = np.lexsort((ib, ia))       # canonical (row, col) order
        self._cache_used -= e.nbytes
        e.members = members
        e.theta_i = theta_i
        e.theta_j = theta_j
        e.int_a = ia[order].astype(np.int32)
        e.int_b = ib[order].astype(np.int32)
        e.int_w = iw[order]
        e.has_int = None                   # core classification changed
        e.core = e.core_int_a = e.core_int_b = None
        e.residual = None                  # warm flow keyed to old structure
        e.residual_key = None
        e.nbytes = (members.nbytes + theta_i.nbytes + theta_j.nbytes
                    + e.int_a.nbytes + e.int_b.nbytes + e.int_w.nbytes)
        self._cache_used += e.nbytes
        mask[members] = False
        loc[members] = -1
        self.cache_patched += 1
        e.stamp = self._version
        # Rebuild the core classification NOW, while the entry is still
        # resident, and charge the budget for it here — a later
        # _ensure_core on an entry evicted in the meantime must not touch
        # the accounting (_ensure_core itself never does).
        before = e.nbytes
        self._ensure_core(e)
        self._cache_used += e.nbytes - before
        return True

    def _assemble_full(self, i: int, j: int) -> Optional[_PairAssembly]:
        """Fresh pair assembly into owned arrays (the cache-entry twin of
        :meth:`solve_pair`'s scratch assembly — identical values)."""
        members = self.members_of(i, j)
        k = len(members)
        if k == 0:
            return None
        cm, assign = self.cm, self.state.assign
        mask, loc = self._mask, self._loc
        mask[members] = True
        loc[members] = np.arange(k)
        theta_i = cm.unary[members, i]
        theta_j = cm.unary[members, j]
        flat, row = csr_multirange(self._indptr, members)
        if len(flat):
            nbr = self._indices[flat]
            nbr_in = mask[nbr]
            bnd = ~nbr_in
            if bnd.any():
                ins = row[bnd]
                outs = assign[nbr[bnd]]
                ti = self._tau[i, outs]
                tj = self._tau[j, outs]
                if not self._unit_w:
                    bw = self._w[self._eids[flat[bnd]]]
                    ti = ti * bw
                    tj = tj * bw
                theta_i += np.bincount(ins, weights=ti, minlength=k)
                theta_j += np.bincount(ins, weights=tj, minlength=k)
            internal = nbr_in
            int_a = row[internal].astype(np.int32)
            int_b = loc[nbr[internal]].astype(np.int32)
            tij = float(self._tau[i, j])
            if self._unit_w:
                int_w = np.full(len(int_a), tij, dtype=np.float64)
            else:
                int_w = tij * self._w[self._eids[flat[internal]]]
        else:
            int_a = int_b = np.zeros(0, dtype=np.int32)
            int_w = np.zeros(0, dtype=np.float64)
        mask[members] = False
        loc[members] = -1
        return _PairAssembly(members, theta_i, theta_j, int_a, int_b, int_w,
                             self._version)

    def _ensure_core(self, e: _PairAssembly) -> None:
        """Singleton/core classification + core-local arcs (valid across
        theta patches; a membership patch resets them)."""
        if e.has_int is not None:
            return
        k = len(e.members)
        has_int = np.zeros(k, dtype=bool)
        has_int[e.int_a] = True
        core = np.flatnonzero(has_int).astype(np.int32)
        cloc = np.empty(k, dtype=np.int32)
        cloc[core] = np.arange(len(core), dtype=np.int32)
        e.has_int = has_int
        e.core = core
        e.core_int_a = cloc[e.int_a]
        e.core_int_b = cloc[e.int_b]
        e.nbytes += (has_int.nbytes + core.nbytes + e.core_int_a.nbytes
                     + e.core_int_b.nbytes)

    def _solve_entry(self, e: _PairAssembly, i: int, j: int,
                     allow_prime: bool = True) -> np.ndarray:
        """Cut the cached pair: singleton argmin + core flow solve over the
        cached core classification (peeled/assembled per solve — theta may
        have been patched since).  With warm starts on, the core solve
        repairs the entry's retained residual instead of pushing the flow
        from zero (:meth:`_solve_core_warm`) — bit-identical masks.
        ``allow_prime=False`` withholds the warm-state investment for
        freshly (re-)assembled entries: under membership churn or LRU
        scan-thrash the state would be invalidated/evicted before reuse,
        so priming is pure overhead (existing state is still repaired)."""
        k = len(e.members)
        self._ensure_core(e)
        new_assign = np.empty(k, dtype=np.int64)
        sing = ~e.has_int
        new_assign[sing] = np.where(
            e.theta_i[sing] < e.theta_j[sing], i, j)
        kc = len(e.core)
        if kc:
            if self._warm_on:
                side = self._solve_core_warm(e, kc, (i, j), allow_prime)
            else:
                side = self._solve_flow(
                    kc, e.core_int_a, e.core_int_b, e.int_w,
                    e.theta_i[e.core], e.theta_j[e.core])
            new_assign[e.core] = np.where(side[:kc], i, j)
        return new_assign

    def _drop_residual(self, e: _PairAssembly, key) -> None:
        """Detach an entry's warm state; the byte budget is only touched
        while the entry is still RESIDENT (a batched round can solve an
        entry that a later pair's assembly already evicted — its bytes left
        the ledger at eviction time)."""
        if e.residual is not None:
            nb = e.residual.nbytes
            e.residual = None
            e.residual_key = None
            e.nbytes -= nb
            if self._cache.get(key) is e:
                self._cache_used -= nb

    def _solve_core_warm(self, e: _PairAssembly, kc: int,
                         key: Tuple[int, int],
                         allow_prime: bool = True) -> np.ndarray:
        """Warm-start route for one cached core's flow solve.

        Composition with the persistency peel: the shared adaptive gate
        (:func:`peel_gate_fraction`) decides peel-vs-direct exactly as the
        cold block solver would.  When the gate says PEEL, the solve runs
        through :func:`repro_torch.core.maxflow.peel_warm_solve`: the peel
        reduces the problem exactly as the cold path would, and the
        SURVIVOR flow is primed/repaired from a residual keyed by the
        forced set — the converged-but-peel-gated regime (stable forced
        sets, tiny theta perturbations) warms instead of re-pushing.  When
        the gate says direct (~90% survivors), the entry's full-core
        ResidualCut is primed / repaired as before.  A regime flip drops
        the other regime's state (the structures are incompatible).
        Either way the mask is bit-identical to the cold path's."""
        th_i = e.theta_i[e.core]
        th_j = e.theta_j[e.core]
        frac = peel_gate_fraction(kc, e.core_int_a, e.int_w, th_i, th_j)
        if frac >= PEEL_GATE_FRAC:
            if e.residual is not None and e.residual_key is None:
                self._drop_residual(e, key)    # full-core state: wrong shape
            old_rc = e.residual
            side, rc, rkey, mode = peel_warm_solve(
                kc, e.core_int_a, e.core_int_b, e.int_w, th_i, th_j,
                residual=e.residual, residual_key=e.residual_key,
                allow_prime=allow_prime or e.residual is not None)
            if mode == "hit":
                self.warm_hits += 1
            elif mode == "warm":
                self.warm_repairs += 1
            else:
                self.warm_cold += 1
            if rc is not old_rc:
                if old_rc is not None:
                    self._drop_residual(e, key)
                if rc is not None:
                    e.residual = rc
                    e.residual_key = rkey
                    e.nbytes += rc.nbytes
                    if self._cache.get(key) is e:
                        self._cache_used += rc.nbytes
                        self._evict_over_budget()
            return side
        if e.residual is not None and e.residual_key is not None:
            self._drop_residual(e, key)        # peel-keyed state: wrong shape
        rc = e.residual
        if rc is not None and rc.k == kc:
            side, mode = rc.resolve(e.core_int_a, e.core_int_b, e.int_w,
                                    th_i, th_j)
            if mode == "hit":
                self.warm_hits += 1
            elif mode == "warm":
                self.warm_repairs += 1
            else:
                self.warm_cold += 1
            return side
        if not allow_prime:
            self.warm_cold += 1
            return self._solve_flow(kc, e.core_int_a, e.core_int_b,
                                    e.int_w, th_i, th_j, peel_frac=frac)
        side, rc = ResidualCut.prime(kc, e.core_int_a, e.core_int_b,
                                     e.int_w, th_i, th_j)
        self.warm_cold += 1
        if rc is not None:
            e.residual = rc
            e.nbytes += rc.nbytes
            if self._cache.get(key) is e:
                self._cache_used += rc.nbytes
                self._evict_over_budget()
        return side

    # ----------------------------------------------------------- pair solve
    def solve_pair(
        self, i: int, j: int
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Min s-t cut of the auxiliary graph A(i, j) over the current
        layout.  Returns (members, proposed_servers_for_members) or None if
        the pair hosts no active vertices.  Does NOT mutate the state.

        Cached and uncached modes share one assembly (:meth:`_assemble_full`
        — boundary side-effect terms folded into BOTH t-link columns per
        Sec. IV-B, internal links as both directed arcs) and one solve tail
        (:meth:`_solve_entry` — vectorized t-link argmin for singleton
        members, tie -> sink side to match the max-flow residual
        convention; only the connected core reaches the flow solver); the
        cache merely decides whether the assembly is reused/patched or
        built fresh and discarded."""
        if self._cache_on:
            before = self.cache_misses
            e = self._cache_entry(i, j)
            refreshed = e is not None and self.cache_misses == before
        else:
            e = self._assemble_full(i, j)
            refreshed = False
        if e is None:
            return None
        return e.members, self._solve_entry(e, i, j,
                                            allow_prime=refreshed)

    def _solve_flow(self, k, int_a, int_b, int_w, theta_i, theta_j,
                    peel_frac=None):
        """Min cut of the (connected-core) auxiliary flow network: nodes
        0..k-1 plus S=k, T=k+1; t-link caps theta_j (s->v) / theta_i (v->t);
        internal arcs already both directions in (int_a, int_b)."""
        S, T = k, k + 1
        n_int = len(int_w)
        if self._use_csr:
            # Single-block route through the block solver: integer
            # persistency peel first (most of the core is settled without a
            # flow solve), then direct symmetric-CSR assembly of the
            # survivors — bit-identical masks to the unpeeled solve.  The
            # member gather already yields arcs in canonical (row, col)
            # order (DataGraph rows are dst-sorted, member-local ids
            # rank-monotone), so no lexsort is paid.
            return min_st_cut_csr_blocks(
                np.array([0, k], dtype=np.int64), int_a, int_b, int_w,
                theta_i, theta_j, arena=self._arena, backend="scipy",
                presorted=True, chunk_nodes=0, peel_frac=peel_frac)
        us = np.empty(2 * k + n_int, dtype=np.int64)
        vs = np.empty(2 * k + n_int, dtype=np.int64)
        caps_uv = np.empty(2 * k + n_int, dtype=np.float64)
        caps_vu = np.zeros(2 * k + n_int, dtype=np.float64)
        us[:k] = S
        vs[:k] = np.arange(k)
        caps_uv[:k] = theta_j
        us[k:2 * k] = np.arange(k)
        vs[k:2 * k] = T
        caps_uv[k:2 * k] = theta_i
        # Internal arcs appear twice in (int_a, int_b) (both directions);
        # emit them as one-way capacities.
        us[2 * k:] = int_a
        vs[2 * k:] = int_b
        caps_uv[2 * k:] = int_w
        _, side = min_st_cut(
            k + 2, S, T, us, vs, caps_uv, caps_vu,
            backend=self._backend, arena=self._arena,
        )
        return side

    # ----------------------------------------------------------- accept path
    def try_pair(self, i: int, j: int, tol: float = 1e-9) -> Tuple[bool, bool]:
        """Solve pair (i, j) and commit iff the exact delta improves.

        Returns (solved, accepted).  Clean pairs (see :meth:`pair_clean`)
        skip the solve entirely — the result is known to be a reject.  The
        accept decision costs O(|moved| + incident links) via the cached
        LayoutState — no full objective evaluation."""
        if self.pair_clean(i, j):
            return True, False
        sol = self.solve_pair(i, j)
        if sol is None:
            self._pair_stamp[(i, j)] = self._version
            return False, False
        members, proposed = sol
        accepted = self.try_apply(members, proposed, tol=tol)
        # Stamp AFTER a possible commit: re-solving the just-accepted pair
        # reproduces the committed layout verbatim (same auxiliary graph,
        # deterministic cut), i.e. a reject — so the pair starts clean.
        self._pair_stamp[(i, j)] = self._version
        return True, accepted

    def sweep_round(
        self,
        pairs: Sequence[Tuple[int, int]],
        tol: float = 1e-9,
        solver: str = "auto",
    ) -> List[Tuple[bool, bool]]:
        """One batched round: solve a matching of disjoint server pairs from
        the current snapshot, then apply each cut with an exact live delta.

        The member sets are disjoint, so the solves are independent;
        composition is guarded per pair by the delta against the state as
        commits land.  Returns (solved, accepted) per pair, in order.

        ``solver``:
          * ``'auto'`` — ``'block'`` while the round's member universe fits
            the glued-union budget, ``'pairwise'`` beyond it (at ~50k
            members the fused batch assembly itself outgrows cache and
            per-pair composition measures faster — the two produce
            identical proposals, so this only picks the faster schedule).
          * ``'block'`` — batch-assemble every dirty pair's auxiliary
            graph and solve them as block-diagonal flow unions, glued in
            groups bounded by ``chunk_nodes`` (one scipy pass per group;
            per-block Dinic with optional ``workers`` fan-out without
            scipy).
          * ``'pairwise'`` — PR-1 behavior: one cut solve per dirty pair.
        """
        if solver == "auto":
            big = (self._chunk_nodes
                   and self._universe > 4 * self._chunk_nodes)
            solver = "pairwise" if big else "block"
        # Solve phase — nothing mutates the state, so every solve sees the
        # same snapshot and the same dirty-version.
        snapshot_version = self._version
        if solver == "pairwise":
            sols = [
                "clean" if self.pair_clean(i, j) else self.solve_pair(i, j)
                for i, j in pairs
            ]
        elif solver == "block":
            sols: List = []
            dirty_slots, dirty_pairs = [], []
            for slot, (i, j) in enumerate(pairs):
                if self.pair_clean(i, j):
                    sols.append("clean")
                else:
                    sols.append(None)
                    dirty_slots.append(slot)
                    dirty_pairs.append((i, j))
            servers = [s for p in dirty_pairs for s in p]
            if len(servers) != len(set(servers)):
                # Blocks are only well-defined for a MATCHING; a shared
                # server would silently misclassify its members, so solve
                # overlapping rounds per pair instead.
                for slot, (i, j) in zip(dirty_slots, dirty_pairs):
                    sols[slot] = self.solve_pair(i, j)
            elif dirty_pairs:
                for slot, sol in zip(dirty_slots,
                                     self._solve_round_blocks(dirty_pairs)):
                    sols[slot] = sol
        else:
            raise ValueError(f"unknown round solver {solver!r}")

        # Apply phase — identical for every solver: pair order, exact live
        # delta per acceptance, PR-1 dirty-stamp semantics.
        out = []
        for (i, j), sol in zip(pairs, sols):
            if isinstance(sol, str):                 # clean: known reject
                out.append((True, False))
                continue
            if sol is None:
                self._pair_stamp[(i, j)] = snapshot_version
                out.append((False, False))
                continue
            dirt_before = max(self._server_dirty[i], self._server_dirty[j])
            accepted = self.try_apply(*sol, tol=tol)
            # "Clean implies re-solve == reject" only holds for an accepted
            # pair if nothing ELSE dirtied it between its snapshot solve and
            # this commit — then its layout equals its own deterministic cut
            # and the post-commit stamp is valid.  If another pair's commit
            # in this round touched its servers (dirt_before > solve
            # version), or it was rejected, keep the solve-time stamp so the
            # pair is re-solved against the fresh state.
            if accepted and dirt_before <= snapshot_version:
                self._pair_stamp[(i, j)] = self._version
            else:
                self._pair_stamp[(i, j)] = snapshot_version
            out.append((True, accepted))
        return out

    # ---------------------------------------------------- block round solve
    def _solve_round_blocks(
        self, dirty: Sequence[Tuple[int, int]]
    ) -> List[Optional[Tuple[np.ndarray, np.ndarray]]]:
        """Batch-assemble the auxiliary graphs of the round's dirty pairs
        and solve them as one block-diagonal flow problem.

        Returns, per dirty pair (in order), ``None`` (no members) or
        ``(members, proposed_servers)`` exactly as :meth:`solve_pair` —
        does NOT mutate the state.

        Vertex-disjoint server pairs => disjoint member sets, so one
        vertex->block classification covers the whole round and a single
        ragged CSR gather yields every block's incident links at once.
        With the assembly cache on, the blocks are instead drawn from the
        per-pair cache (verbatim / patched / re-assembled as needed) and
        only the glued union is rebuilt per round.

        Large rounds are split into consecutive pair groups whose combined
        member estimate stays under ``chunk_nodes``: the batch assembly's
        gathers and the glued flow CSR then stay cache-resident (one
        50k-member union loses to bounded groups on every path — the
        assembly, not just the solve, is what outgrows cache), while the
        grouping itself cannot change any cut (per-block quantization is
        composition-invariant)."""
        if self._cache_on:
            return self._solve_round_blocks_cached(dirty)
        if self._chunk_nodes and len(dirty) > 1:
            sizes = np.bincount(self.state.assign, minlength=self.cm.net.m)
            groups: List[List[Tuple[int, int]]] = []
            cur: List[Tuple[int, int]] = []
            acc = 0
            for p in dirty:
                est = int(sizes[p[0]] + sizes[p[1]])
                if cur and acc + est > self._chunk_nodes:
                    groups.append(cur)
                    cur, acc = [], 0
                cur.append(p)
                acc += est
            groups.append(cur)
            if len(groups) > 1:
                out: List = []
                for grp in groups:
                    out.extend(self._solve_round_blocks_fused(grp))
                return out
        return self._solve_round_blocks_fused(dirty)

    def _solve_round_blocks_fused(
        self, dirty: Sequence[Tuple[int, int]]
    ) -> List[Optional[Tuple[np.ndarray, np.ndarray]]]:
        """One fused batch assembly + glued solve over ``dirty`` (see
        :meth:`_solve_round_blocks`)."""
        cm, assign = self.cm, self.state.assign
        B = len(dirty)
        srv_i = np.fromiter((p[0] for p in dirty), np.int64, count=B)
        srv_j = np.fromiter((p[1] for p in dirty), np.int64, count=B)
        lookup = np.full(cm.net.m, -1, dtype=np.int64)
        lookup[srv_i] = np.arange(B)
        lookup[srv_j] = np.arange(B)
        vblk = lookup[assign]                       # vertex -> block (or -1)
        if self._active is not None:
            vblk = np.where(self._active, vblk, -1)
        sel = np.flatnonzero(vblk >= 0)
        if len(sel) == 0:
            return [None] * B
        vb = vblk[sel]
        order = np.argsort(vb, kind="stable")       # block-grouped, ascending
        members_all = sel[order]                    # within each block
        sizes = np.bincount(vb, minlength=B)
        bptr = np.zeros(B + 1, dtype=np.int64)
        np.cumsum(sizes, out=bptr[1:])
        N = len(members_all)

        rep_i = np.repeat(srv_i, sizes)             # per-member block servers
        rep_j = np.repeat(srv_j, sizes)
        mrow_blk = np.repeat(np.arange(B), sizes)
        theta_i = cm.unary[members_all, rep_i].astype(np.float64)
        theta_j = cm.unary[members_all, rep_j].astype(np.float64)
        loc = self._loc                             # global -> member row
        loc[members_all] = np.arange(N)

        flat, rep = csr_multirange(self._indptr, members_all)
        if len(flat):
            nbr = self._indices[flat]
            rowb = mrow_blk[rep]
            # A neighbor is internal iff it is a member of the SAME block;
            # members of other blocks are frozen third-server vertices for
            # this pair (their commits land only in the apply phase).
            internal = vblk[nbr] == rowb
            bnd = ~internal
            if bnd.any():
                ins = rep[bnd]
                outs = assign[nbr[bnd]]
                bi = rowb[bnd]
                ti = self._tau[srv_i[bi], outs]
                tj = self._tau[srv_j[bi], outs]
                if not self._unit_w:
                    bw = self._w[self._eids[flat[bnd]]]
                    ti = ti * bw
                    tj = tj * bw
                theta_i += np.bincount(ins, weights=ti, minlength=N)
                theta_j += np.bincount(ins, weights=tj, minlength=N)
            int_rows = rep[internal]
            int_cols = loc[nbr[internal]]
            int_w = self._tau[srv_i, srv_j][rowb[internal]]  # per-block tau_ij
            if not self._unit_w:
                int_w = int_w * self._w[self._eids[flat[internal]]]
        else:
            int_rows = int_cols = np.zeros(0, dtype=np.int64)
            int_w = np.zeros(0, dtype=np.float64)

        # Singleton reduction across ALL blocks at once (tie -> sink side,
        # matching the per-pair path); only the connected cores reach flow.
        new_assign = np.where(theta_i < theta_j, rep_i, rep_j)
        has_int = np.zeros(N, dtype=bool)
        has_int[int_rows] = True
        core = np.flatnonzero(has_int)              # stays block-grouped
        if len(core):
            cloc = np.empty(N, dtype=np.int64)
            cloc[core] = np.arange(len(core))
            core_ptr = np.zeros(B + 1, dtype=np.int64)
            np.cumsum(np.bincount(mrow_blk[core], minlength=B),
                      out=core_ptr[1:])
            side = min_st_cut_csr_blocks(
                core_ptr, cloc[int_rows], cloc[int_cols], int_w,
                theta_i[core], theta_j[core], arena=self._arena,
                backend="scipy" if self._use_csr else self._backend,
                workers=self._workers, worker_mode=self._worker_mode,
                presorted=True, chunk_nodes=self._chunk_nodes)
            new_assign[core] = np.where(side, rep_i[core], rep_j[core])

        loc[members_all] = -1                       # reset scratch
        return [
            (members_all[lo:hi], new_assign[lo:hi]) if hi > lo else None
            for lo, hi in zip(bptr[:-1], bptr[1:])
        ]

    def _solve_round_blocks_cached(
        self, dirty: Sequence[Tuple[int, int]]
    ) -> List[Optional[Tuple[np.ndarray, np.ndarray]]]:
        """Block round solve over cached per-pair assemblies: each dirty
        pair's block comes from the AssemblyCache (verbatim, patched, or
        re-assembled), their connected cores are glued into one
        block-diagonal flow union (chunked to ``chunk_nodes``), and the
        per-block mask slices scatter back — value-identical to the fused
        batch assembly (same theta, arcs, quantization).

        With warm starts on, REFRESHED entries (verbatim hits and
        theta/membership patches — their member set survived since the last
        visit) are solved per pair so each can repair its retained
        :class:`ResidualCut` instead of re-pushing its flow inside a glued
        union; freshly (re-)assembled entries stay on the glued cold path —
        a fresh assembly means membership churn, which would invalidate
        warm state before it is ever reused, so priming there is pure
        overhead.  Masks are identical either way (the block solver's
        per-block normalization reproduces the per-pair quantization
        exactly, and warm masks are bit-identical to cold)."""
        B = len(dirty)
        entries: List[Optional[_PairAssembly]] = []
        refreshed: List[bool] = []
        for i, j in dirty:
            before = self.cache_misses
            e = self._cache_entry(int(i), int(j))
            entries.append(e)
            refreshed.append(e is not None and self.cache_misses == before)
        warm_assign: Dict[int, np.ndarray] = {}
        core_sizes = np.zeros(B, dtype=np.int64)
        for b, e in enumerate(entries):
            if e is None:
                continue
            if self._warm_on and refreshed[b]:
                i, j = dirty[b]
                warm_assign[b] = self._solve_entry(e, int(i), int(j))
            else:
                self._ensure_core(e)
                core_sizes[b] = len(e.core)
        core_ptr = np.zeros(B + 1, dtype=np.int64)
        np.cumsum(core_sizes, out=core_ptr[1:])
        # Glue consecutive blocks in groups bounded by the chunk budget so
        # the concatenated union stays cache-resident (grouping cannot
        # change any cut: per-block quantization is composition-invariant).
        if self._chunk_nodes and core_ptr[-1] > self._chunk_nodes:
            spans = _chunk_block_spans(core_ptr, self._chunk_nodes)
        else:
            spans = [(0, B)] if core_ptr[-1] else []
        block_side: List[Optional[np.ndarray]] = [None] * B
        for blo, bhi in spans:
            sub = entries[blo:bhi]
            sub_sizes = core_sizes[blo:bhi]
            total = int(sub_sizes.sum())
            if total == 0:
                continue
            sub_ptr = np.zeros(len(sub) + 1, dtype=np.int64)
            np.cumsum(sub_sizes, out=sub_ptr[1:])
            offs = sub_ptr[:-1]
            # Entries with sub_sizes 0 contribute nothing — pairs with no
            # connected core, and warm-solved entries already settled above.
            glue = [(b, e) for b, e in enumerate(sub)
                    if e is not None and sub_sizes[b]]
            g_ia = np.concatenate(
                [e.core_int_a.astype(np.int64) + offs[b] for b, e in glue])
            g_ib = np.concatenate(
                [e.core_int_b.astype(np.int64) + offs[b] for b, e in glue])
            g_iw = np.concatenate([e.int_w for _, e in glue])
            g_ti = np.concatenate([e.theta_i[e.core] for _, e in glue])
            g_tj = np.concatenate([e.theta_j[e.core] for _, e in glue])
            side = min_st_cut_csr_blocks(
                sub_ptr, g_ia, g_ib, g_iw, g_ti, g_tj, arena=self._arena,
                backend="scipy" if self._use_csr else self._backend,
                workers=self._workers, worker_mode=self._worker_mode,
                presorted=True, chunk_nodes=0)
            for b in range(blo, bhi):
                if core_sizes[b]:
                    lo = sub_ptr[b - blo]
                    block_side[b] = side[lo:lo + core_sizes[b]]
        out: List[Optional[Tuple[np.ndarray, np.ndarray]]] = []
        for b, ((i, j), e, bs) in enumerate(zip(dirty, entries, block_side)):
            if e is None:
                out.append(None)
                continue
            if b in warm_assign:
                out.append((e.members, warm_assign[b]))
                continue
            new_assign = np.empty(len(e.members), dtype=np.int64)
            sing = ~e.has_int
            new_assign[sing] = np.where(
                e.theta_i[sing] < e.theta_j[sing], i, j)
            if bs is not None:
                new_assign[e.core] = np.where(bs, i, j)
            out.append((e.members, new_assign))
        return out

    def try_apply(
        self, members: np.ndarray, proposed: np.ndarray, tol: float = 1e-9
    ) -> bool:
        """Delta-check a proposed re-assignment of ``members`` against the
        LIVE state and commit when improving (used by the batched sweep,
        where the cut may have been computed against a slightly stale
        snapshot: the exact live delta is what guards acceptance)."""
        changed = proposed != self.state.assign[members]
        if not changed.any():
            return False
        moved = members[changed]
        new_servers = proposed[changed]
        if self.state.propose(moved, new_servers) < -tol:
            self.state.commit_pending()      # on_commit hook marks dirty
            return True
        self.state.discard_pending()
        return False

    def apply_assignment(self, members: np.ndarray,
                         new_servers: np.ndarray) -> float:
        """Commit a re-assignment UNCONDITIONALLY (no improvement guard)
        and keep every cache coherent via the on_commit epoch hook.  The
        entry point for externally-imposed moves — fault-runtime orphan
        reseeding, straggler perturbations, benchmark churn — after which
        the engine's warm-started re-solves stay exact.  Returns the exact
        cost delta that was applied."""
        members = np.asarray(members, dtype=np.int64)
        new_servers = np.asarray(new_servers, dtype=np.int64)
        changed = new_servers != self.state.assign[members]
        if not changed.any():
            return 0.0
        return self.state.commit(members[changed], new_servers[changed])

    # ------------------------------------------------------ cross-slot rebind
    def rebind(self, cm: CostModel, assign: np.ndarray,
               active: Optional[np.ndarray] = None) -> None:
        """Adopt the next slot's (CostModel, assignment, active mask)
        WITHOUT discarding cross-slot state: the AssemblyCache, warm-start
        residuals, pair-touch frequencies and arena scratch all survive.

        The model diff (:meth:`CostModel.rebind`) is translated into the
        same epoch machinery commits use: changed unary rows, neighbors of
        vertices on changed tau columns, vertices whose assignment or
        active status differs from the previous slot (plus their
        neighbors) bump ``_vertex_epoch`` — the theta patch repairs them;
        structural edge deltas bump both the vertex AND struct epochs —
        the membership patch re-derives the touched rows' arcs (the
        struct epoch only disqualifies the arc-blind theta fast path);
        densely repriced servers (degrade/revive) bump ``_server_epoch``
        — affected pairs re-gather whole theta columns but KEEP their
        arcs, core split and warm residual (tau, and therefore every
        internal arc, is untouched by compute repricing); only changed
        tau entries force rebuilds.  Untouched entries refresh verbatim.  Every pair starts
        dirty (``_server_dirty`` = new version), so the first sweep after
        adoption probes exactly the schedule a fresh engine would — the
        savings are pure assembly/flow reuse, and trajectories are
        bit-identical to a per-slot rebuild.

        Raises ValueError when the fleet size changed or the graph shrank
        (no incremental mapping exists — build a fresh engine)."""
        old_cm = self.cm
        old_assign = self.state.assign            # pre-adopt layout (owned)
        old_active = self._active
        diff = cm.rebind(old_cm)                  # validates m / graph growth
        g = cm.graph
        n_old = old_cm.graph.n
        assign = np.asarray(assign, dtype=np.int64)
        self.cm = cm
        self._tau = cm.net.tau
        self._indptr = g.indptr
        self._indices = g.indices
        self._eids = g.edge_ids
        self.state = cm.layout_state(assign)
        self.state.on_commit = self._mark_dirty
        self._w = self.state._w
        self._unit_w = g.edge_weights is None
        self._active = None if active is None else np.asarray(active, bool)
        if g.n > n_old:
            grow = g.n - n_old
            self._mask = np.zeros(g.n, dtype=bool)
            self._loc = np.full(g.n, -1, dtype=np.int64)
            self._moved_mask = np.concatenate(
                [self._moved_mask, np.zeros(grow, dtype=bool)])
            self._vertex_epoch = np.concatenate(
                [self._vertex_epoch, np.zeros(grow, dtype=np.int64)])
            self._struct_epoch = np.concatenate(
                [self._struct_epoch, np.zeros(grow, dtype=np.int64)])
        # The touched-vertex ledger restarts per adoption: callers read the
        # CURRENT run's movers, exactly like a fresh engine's.
        self._moved_mask[:] = False
        self._universe = (int(self._active.sum())
                          if self._active is not None else g.n)
        self._version += 1
        v = self._version
        self._server_dirty[:] = v
        # --- per-vertex epochs: theta-patchable changes -------------------
        if len(diff.unary_rows):
            self._vertex_epoch[diff.unary_rows] = v
        if len(diff.tau_cols):
            # tau[i, c] changed sparsely: any member with a boundary
            # neighbor homed on c folds the stale price into its theta.
            on_cols = np.flatnonzero(np.isin(assign, diff.tau_cols))
            flat, _ = csr_multirange(self._indptr, on_cols)
            if len(flat):
                self._vertex_epoch[self._indices[flat]] = v
        # Vertices re-assigned between the slots (orphan scatter, replica
        # re-homing, external churn) and active-mask flips change pair
        # memberships without a commit — mirror _mark_dirty: the vertex
        # AND its neighbors are stale.
        movers = np.flatnonzero(assign[:n_old] != old_assign)
        oa = (old_active if old_active is not None
              else np.ones(n_old, dtype=bool))
        na = (self._active[:n_old] if self._active is not None
              else np.ones(n_old, dtype=bool))
        xor = np.flatnonzero(oa != na)
        touch = np.unique(np.concatenate([movers, xor]))
        if len(touch):
            self._vertex_epoch[touch] = v
            flat, _ = csr_multirange(self._indptr, touch)
            if len(flat):
                self._vertex_epoch[self._indices[flat]] = v
        # --- rebuild-forcing epochs ---------------------------------------
        if len(diff.servers):
            self._server_epoch[diff.servers] = v
            self._server_max = v
        if diff.tau_pairs is not None:
            if self._tau_pair_epoch is None:
                self._tau_pair_epoch = np.zeros(
                    (cm.net.m, cm.net.m), dtype=np.int64)
            self._tau_pair_epoch[diff.tau_pairs] = v
            self._tau_max = v
        if len(diff.struct_vertices):
            # Both endpoints of every changed/new edge are in the struct
            # set, so re-gathering the struct vertices' rows (the
            # membership patch's touched path) reproduces a fresh
            # assembly's arcs exactly; the struct epoch only disqualifies
            # the theta-only fast path, which cannot rewrite arc lists.
            self._vertex_epoch[diff.struct_vertices] = v
            self._struct_epoch[diff.struct_vertices] = v
            self._struct_max = v


class LayoutSession:
    """Persistent cross-slot layout engine (the adaptive loop's warm path).

    Owns one :class:`PairCutEngine` across GLAD-S/E/A calls and fault
    relayouts: ``adopt`` rebinds the live engine to the next slot's
    (CostModel, assignment, active mask) via :meth:`PairCutEngine.rebind`,
    keeping every untouched assembly and warm-start residual alive —
    per-slot relayouts stop paying the from-scratch engine build they
    would otherwise pay at ``glad_s``'s rebuild site.  Trajectories are
    bit-identical to per-slot rebuilds (pinned by golden + fuzz tests);
    only the schedule of cache/warm reuse changes.

    Engine knobs are fixed at session construction (a session IS one
    engine configuration); ``cache='auto'`` resolves ON — persistence is
    the point, and the first adoption often carries no active mask.  A
    fleet resize or graph shrink has no incremental mapping: ``adopt``
    transparently falls back to a fresh engine (state reset, same
    semantics as the first adoption).
    """

    def __init__(self, backend: str = "auto", workers: int = 0,
                 worker_mode: str = "thread", cache: "bool | str" = "auto",
                 cache_bytes: int = 256 << 20,
                 chunk_nodes: "int | str" = "auto",
                 warm: "bool | str" = "auto"):
        self._opts = dict(
            backend=backend, workers=workers, worker_mode=worker_mode,
            cache=(True if cache == "auto" else cache),
            cache_bytes=cache_bytes, chunk_nodes=chunk_nodes, warm=warm)
        self.engine: Optional[PairCutEngine] = None
        self.adoptions = 0           # total adopt() calls
        self.rebinds = 0             # adoptions served by an engine rebind
        # Persistent multilevel coarsening hierarchies, one per V-cycle
        # configuration — the LevelStack cache that survives GLAD-E
        # escalations and fault relayouts (see
        # repro_torch.core.multilevel.LevelStack).
        self._stacks: dict = {}

    def level_stack(self, coarsen_to: int = 1024,
                    max_levels: Optional[int] = None,
                    mu_gate: bool = True):
        """Get-or-create the session's persistent
        :class:`repro_torch.core.multilevel.LevelStack` for one V-cycle
        configuration (local import — engine <-> multilevel cycle)."""
        key = (int(coarsen_to), max_levels, bool(mu_gate))
        st = self._stacks.get(key)
        if st is None:
            from repro_torch.core.multilevel import LevelStack
            st = LevelStack(coarsen_to=coarsen_to, max_levels=max_levels,
                            mu_gate=mu_gate)
            self._stacks[key] = st
        return st

    def stack_valid_for(self, cm: CostModel, coarsen_to: int = 1024,
                        max_levels: Optional[int] = None,
                        mu_gate: bool = True) -> bool:
        """True when a cached LevelStack for this configuration was built
        over ``cm``'s graph — i.e. a V-cycle escalation would refresh the
        hierarchy instead of coarsening from scratch (the signal GLAD-E's
        churn-measured auto policy reads)."""
        key = (int(coarsen_to), max_levels, bool(mu_gate))
        st = self._stacks.get(key)
        return st is not None and st.valid_for(cm)

    def adopt(self, cm: CostModel, assign: np.ndarray,
              active: Optional[np.ndarray] = None) -> PairCutEngine:
        """Bind the session's engine to the next slot; returns the engine
        (rebound in place when possible, freshly built otherwise)."""
        self.adoptions += 1
        if self.engine is not None:
            try:
                self.engine.rebind(cm, assign, active=active)
            except ValueError:
                self.engine = None   # fleet resized / graph shrank
            else:
                self.rebinds += 1
                return self.engine
        self.engine = PairCutEngine(cm, assign, active=active, **self._opts)
        return self.engine
