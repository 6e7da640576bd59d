"""GLAD-S: graph-layout scheduling for static input graphs (paper Alg. 1).

Iteratively picks the least-visited connected server pair <i, j>, builds the
auxiliary graph A(i, j) over the clients currently resident on i or j, solves
a minimum s-t cut (Thm 4: exact for the restricted two-server subproblem),
and accepts the induced layout whenever total cost improves.  Terminates when
R consecutive attempts fail to improve (Thm 6 guarantees convergence;
Thm 5 gives C(pi) <= 2*lambda*C(pi*) + eps).

Auxiliary-graph weights (Sec. IV-B):
  t-link  s(=i) -> v : unary cost of v living on j  +  side-effect traffic
                       from v's links to vertices on *other* servers k
                       (paid when v lands on the sink side = server j)
  t-link  v -> t(=j) : symmetric, for v living on i
  n-link  u <-> v    : tau_ij  (paid when a data link is cut by the layout)

The side-effect terms make each pairwise cut *globally* cost-aware, which is
what lets the pairwise sweep descend the full objective.

Two execution engines:
  * ``engine='incremental'`` (default) — repro_torch.core.engine.PairCutEngine:
    vectorized auxiliary-graph assembly, reused scratch arenas, and an exact
    O(moved + incident links) delta on the accept path (no full-objective
    re-evaluation per iteration).
  * ``engine='reference'`` — the direct transcription of Alg. 1 kept as the
    oracle for property tests and the speedup benchmark.

Two sweep disciplines (incremental engine only):
  * ``sweep='single'`` — Alg. 1 verbatim: one least-visited pair at a time.
  * ``sweep='batched'`` — a round-robin matching of disjoint server pairs
    per round; disjoint pairs host disjoint member sets so their cuts are
    solved from one snapshot and composed, each acceptance guarded by an
    exact live delta.  ``round_solver`` picks how a round's cuts are
    solved: ``'block'`` (the ``'auto'`` default) batch-assembles every
    dirty pair into one block-diagonal flow problem solved by a single
    scipy pass (pure-python fallback: per-block Dinic over ``workers``
    threads/processes); ``'pairwise'`` keeps the one-solve-per-pair
    path (benchmark baseline).

The port's copy of ``repro.core.glad_s``, with ``repro`` renamed ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.cost import CostModel
from repro_torch.core.engine import LayoutSession, PairCutEngine, round_robin_rounds
from repro_torch.core.maxflow import min_st_cut


@dataclasses.dataclass
class GladResult:
    assign: np.ndarray
    cost: float
    history: List[float]            # total cost after every iteration
    iterations: int
    accepted: int
    wall_time_s: float
    factors: dict
    # Net move delta vs the starting layout (vertices whose final server
    # differs from ``init``) — feeds gnn.distributed.patch_plan so the
    # serving layer patches its ShardPlan instead of recompiling.  All
    # vertices for a random init.
    moved: Optional[np.ndarray] = None
    # Multilevel runs only: one stats dict per level solve (coarsest solve
    # first, then each refinement down to the finest), carrying the
    # projected init / boundary-active mask each level ran under — enough
    # to replay any level on the flat engine bit-for-bit.  With
    # ``record_levels=False`` the replay arrays collapse to checksums +
    # sizes (scale-cell telemetry).
    levels: Optional[List[dict]] = None
    # Multilevel runs with a session only: the LevelStack's coarsening
    # reuse stats for this solve (mode build/refresh, levels
    # reused/rebuilt, cumulative builds/refreshes).
    coarsen: Optional[dict] = None
    # replicate=True runs only: the accepted move-vs-replicate overlay on
    # the final cut (core.cost.Replication), the objective with it applied
    # (cost - replication.gain), and the replicated total recorded after
    # each ACCEPTED round.  The overlay never feeds back into the cut
    # decisions, so the assign/cost/history trajectory is bit-identical
    # with the knob on or off.
    replication: Optional[object] = None
    replicated_cost: Optional[float] = None
    repl_history: Optional[List[float]] = None


def _pair_members(assign: np.ndarray, i: int, j: int,
                  active: Optional[np.ndarray]) -> np.ndarray:
    members = (assign == i) | (assign == j)
    if active is not None:
        members &= active
    return np.where(members)[0]


def solve_pair(
    cm: CostModel,
    assign: np.ndarray,
    i: int,
    j: int,
    active: Optional[np.ndarray] = None,
    backend: str = "auto",
) -> Optional[np.ndarray]:
    """One min s-t cut for server pair (i, j).  Returns a full proposed
    assignment vector (copy), or None if the pair hosts no active vertices.

    Reference construction (per-edge scan of the whole graph); the engine
    path in repro_torch.core.engine builds the same auxiliary graph from the CSR
    incident-edge view.  Kept as the oracle for the Thm-4 exactness tests.
    """
    members = _pair_members(assign, i, j, active)
    if len(members) == 0:
        return None
    net, graph = cm.net, cm.graph
    n_aux = len(members) + 2
    S, T = len(members), len(members) + 1      # aux ids of source/sink
    aux_id = {int(v): k for k, v in enumerate(members)}

    # Unary terms: theta_i[v] = unary[v, i], theta_j[v] = unary[v, j],
    # plus side-effect traffic to neighbors on other servers.
    theta_i = cm.unary[members, i].astype(np.float64).copy()
    theta_j = cm.unary[members, j].astype(np.float64).copy()

    edges = graph.edges
    weights = graph.weights_or_ones()
    eu, ev = edges[:, 0], edges[:, 1]
    m_mask = np.zeros(graph.n, dtype=bool)
    m_mask[members] = True

    # Internal links (both endpoints in member set): pairwise tau_ij.
    internal = m_mask[eu] & m_mask[ev]
    # Boundary links: one endpoint in member set -> side-effect unary.
    bnd_u = m_mask[eu] & ~m_mask[ev]
    bnd_v = ~m_mask[eu] & m_mask[ev]
    if bnd_u.any():
        ins, outs, w = eu[bnd_u], ev[bnd_u], weights[bnd_u]
        np.add.at(theta_i, [aux_id[int(x)] for x in ins],
                  net.tau[i, assign[outs]] * w)
        np.add.at(theta_j, [aux_id[int(x)] for x in ins],
                  net.tau[j, assign[outs]] * w)
    if bnd_v.any():
        ins, outs, w = ev[bnd_v], eu[bnd_v], weights[bnd_v]
        np.add.at(theta_i, [aux_id[int(x)] for x in ins],
                  net.tau[i, assign[outs]] * w)
        np.add.at(theta_j, [aux_id[int(x)] for x in ins],
                  net.tau[j, assign[outs]] * w)

    # Build the flow network.  Convention: source side = server i.
    #   cap(s -> v) = theta_j[v]   (paid when v ends on sink side, i.e. j? no:
    #   s->v is cut exactly when v is in the sink component => v on j ...
    #   => the cut pays the cost of assigning v to j) -- see maxflow.min_st_cut.
    k = len(members)
    us = [S] * k + [kk for kk in range(k)]
    vs = list(range(k)) + [T] * k
    caps_uv = list(theta_j) + list(theta_i)
    caps_vu = [0.0] * (2 * k)
    if internal.any():
        tij = float(net.tau[i, j])
        for a, b, w in zip(eu[internal], ev[internal], weights[internal]):
            us.append(aux_id[int(a)])
            vs.append(aux_id[int(b)])
            caps_uv.append(tij * w)
            caps_vu.append(tij * w)
    _, side = min_st_cut(
        n_aux, S, T, np.array(us), np.array(vs),
        np.array(caps_uv), np.array(caps_vu), backend=backend,
    )
    proposal = assign.copy()
    on_source = side[:k]          # True -> stays with server i
    proposal[members[on_source]] = i
    proposal[members[~on_source]] = j
    return proposal


def _init_assign(cm: CostModel, init: Optional[np.ndarray],
                 rng: np.random.Generator) -> np.ndarray:
    if init is None:
        return rng.integers(0, cm.net.m, size=cm.graph.n).astype(np.int64)
    return np.asarray(init, dtype=np.int64).copy()


def _empty_result(cm: CostModel, assign: np.ndarray) -> GladResult:
    f = cm.factors(assign)
    return GladResult(assign, f["total"], [f["total"]], 0, 0, 0.0, f,
                      moved=np.zeros(0, dtype=np.int64))


def glad_s(
    cm: CostModel,
    R: Optional[int] = None,
    init: Optional[np.ndarray] = None,
    active: Optional[np.ndarray] = None,
    seed: int = 0,
    backend: str = "auto",
    max_iterations: int = 100_000,
    on_iteration: Optional[Callable[[int, float], None]] = None,
    sweep: str = "single",
    engine: str = "incremental",
    round_solver: str = "auto",
    workers: int = 0,
    worker_mode: str = "thread",
    cache: "bool | str" = "auto",
    cache_bytes: int = 256 << 20,
    chunk_nodes: "int | str" = "auto",
    warm: "bool | str" = "auto",
    multilevel: "bool | str" = False,
    coarsen_to: int = 1024,
    levels: Optional[int] = None,
    chunk_vertices: "int | str | None" = None,
    record_levels: bool = True,
    replicate: "bool | dict" = False,
    session: Optional[LayoutSession] = None,
) -> GladResult:
    """Paper Algorithm 1.

    Args:
      cm: cost model binding (net, graph, gnn workload).
      R: convergence patience — consecutive non-improving attempts tolerated.
         Defaults to |D|(|D|-1)/2 (the exhaustive setting in Sec. IV-B).
      init: starting layout; random if None (Alg. 1 line 1).
      active: optional mask — only these vertices may move (GLAD-E reuses
        this to freeze the unfiltered layout).
      backend: max-flow backend.
      sweep: 'single' (Alg. 1 verbatim) or 'batched' (disjoint-pair rounds).
      engine: 'incremental' (delta-cost engine) or 'reference' (seed Alg. 1
        transcription — oracle/benchmark baseline).
      round_solver: batched-sweep round solver — 'auto'/'block' (one
        block-diagonal flow per round) or 'pairwise' (PR-1 per-pair solves).
      workers: fan a round's block/chunk solves out over this many
        threads/processes ('worker_mode'); scipy holds the GIL, so thread
        mode mainly helps the pure-python fallback — measure first.
      cache: cross-round AssemblyCache — persist each pair's assembled
        t-link vectors / arc lists / core classification and patch theta
        or membership deltas in O(touched) between visits.  'auto' enables
        it exactly when an ``active`` mask is present (incremental
        GLAD-E-style relayouts, where touched sets stay small); cold full
        sweeps — warm-started ones without a mask included — churn pair
        memberships too fast for per-pair reuse to beat the fused batch
        assembly, so they only cache when explicitly asked (cache=True).
        Trajectories are bit-identical with the cache on or off.
      cache_bytes: LRU budget for the AssemblyCache.
      chunk_nodes: bound on one glued block-diagonal flow union ('auto' =
        engine default; 0 = single glued pass per round).
      warm: warm-start incremental max-flow — retain each cached pair's
        flow/residual arrays (maxflow.ResidualCut, stored on its
        AssemblyCache entry under the same per-vertex epochs) and repair
        them on re-solve (drain over-saturated arcs, augment the delta)
        instead of re-pushing the whole flow.  'auto' follows the cache
        policy; an adaptive gate falls back to the cold (peeled) path
        whenever the touched fraction is large, so warm='auto' is never a
        regression.  Masks are bit-identical warm or cold — the minimal
        source side is unique per quantized problem — so trajectories are
        unchanged (differential-fuzz + golden-fixture pinned).
      multilevel: route the solve through the coarsen/solve/refine V-cycle
        (:func:`repro_torch.core.multilevel.glad_multilevel`) — the scaling path
        for n >> 10^5.  'auto' enables it for maskless solves at
        ``multilevel.MULTILEVEL_AUTO_MIN_N`` vertices and beyond; the
        default False preserves every existing flat trajectory.  The
        V-cycle always sweeps batched internally and is incompatible with
        an ``active`` mask (it is a full-layout construct) and with
        ``engine='reference'``.
      coarsen_to: V-cycle coarsest-level size (multilevel only).
      levels: cap on the number of hierarchy levels (None = until
        ``coarsen_to`` or stagnation; multilevel only).
      chunk_vertices: stream the V-cycle's coarsening in bounded vertex
        windows of this size ('auto' = default window) — peak coarsening
        RSS becomes a knob instead of O(n + m) per level, with levels
        bit-identical to the in-core build (multilevel only).
      record_levels: keep the full per-level replay arrays on
        ``result.levels`` (default).  False slims them to checksums +
        sizes so scale cells don't retain O(levels x n) telemetry
        (multilevel only; the trajectory is unchanged).
      replicate: move-vs-replicate overlay (Fograph-style inference
        replication).  True — or a dict of
        :meth:`CostModel.replicate_greedy` kwargs (``sync_weight``,
        ``storage``, ``budget``) — re-runs the greedy after each ACCEPTED
        round, recording the replicated total in ``repl_history``, and
        attaches the final overlay as ``result.replication`` /
        ``result.replicated_cost``.  The overlay is a post-pass on the
        current cut: it never alters which moves are proposed or accepted,
        so layouts are bit-identical with the knob on or off (default
        False skips the extra per-accept work entirely).
      session: optional :class:`repro_torch.core.engine.LayoutSession` — a
        persistent cross-slot engine.  The call ADOPTS the session's
        engine (rebinding its model/assignment/mask in place, keeping
        cached assemblies + warm residuals from previous slots alive)
        instead of building a fresh one; per-call engine knobs
        (cache/warm/chunk_nodes/workers) are fixed at session construction
        and ignored here.  Trajectories are bit-identical to the
        sessionless call.  With ``multilevel`` the session additionally
        carries the persistent coarsening hierarchy
        (:class:`repro_torch.core.multilevel.LevelStack` — reused matchings
        across relayouts of an unchanged graph) and its engine is adopted
        by the V-cycle's finest refinement.  Incompatible with
        ``engine='reference'``.
    """
    if session is not None and engine == "reference":
        raise ValueError("session= requires engine='incremental'")
    if multilevel == "auto":
        from repro_torch.core.multilevel import MULTILEVEL_AUTO_MIN_N
        multilevel = active is None and cm.graph.n >= MULTILEVEL_AUTO_MIN_N
    if multilevel:
        if engine == "reference":
            raise ValueError("multilevel requires engine='incremental'")
        if active is not None:
            raise ValueError(
                "multilevel solves the full layout; run flat glad_s for "
                "masked (GLAD-E-style) refinements")
        from repro_torch.core.multilevel import glad_multilevel
        return _attach_replication(cm, glad_multilevel(
            cm, R=R, init=init, seed=seed, backend=backend,
            coarsen_to=coarsen_to, levels=levels,
            round_solver=round_solver, workers=workers,
            worker_mode=worker_mode, cache=cache, cache_bytes=cache_bytes,
            chunk_nodes=chunk_nodes, warm=warm,
            max_iterations=max_iterations, on_iteration=on_iteration,
            chunk_vertices=chunk_vertices, record_levels=record_levels,
            session=session),
            replicate)
    rng = np.random.default_rng(seed)
    net, graph = cm.net, cm.graph
    t0 = time.perf_counter()

    assign = _init_assign(cm, init, rng)
    pairs = net.pairs
    if len(pairs) == 0 or graph.n == 0:
        return _empty_result(cm, assign)
    if R is None:
        R = net.m * (net.m - 1) // 2

    if engine == "reference":
        return _attach_replication(cm, _glad_s_reference(
            cm, assign, pairs, R, active, rng, backend, max_iterations,
            on_iteration, t0), replicate)
    if engine != "incremental":
        raise ValueError(f"unknown engine {engine!r}")

    init_snapshot = assign.copy()
    if session is not None:
        eng = session.adopt(cm, assign, active=active)
    else:
        eng = PairCutEngine(cm, assign, active=active, backend=backend,
                            workers=workers, worker_mode=worker_mode,
                            cache=cache, cache_bytes=cache_bytes,
                            chunk_nodes=chunk_nodes, warm=warm)
    history = [eng.state.total]
    repl_history: Optional[List[float]] = None
    if replicate:
        # Per-accepted-round replicated-cost ledger: acceptance is exactly
        # a strict drop of the live total, so the wrapper re-greedies the
        # overlay on every improvement without touching the sweep loops
        # (the trajectory stays bit-identical — replication reads the cut,
        # never writes it).
        repl_opts = replicate if isinstance(replicate, dict) else {}
        repl_history = []
        base_cb, best = on_iteration, {"c": eng.state.total}

        def _repl_cb(it, cost):
            if cost < best["c"] - 1e-12:
                best["c"] = cost
                r = cm.replicate_greedy(eng.state.assign, **repl_opts)
                repl_history.append(
                    cm.replication_cost(eng.state.assign, r)["total"])
            if base_cb is not None:
                base_cb(it, cost)

        on_iteration = _repl_cb
    if sweep == "single":
        iters, accepted = _sweep_single(
            eng, pairs, R, rng, max_iterations, on_iteration, history)
    elif sweep == "batched":
        iters, accepted = _sweep_batched(
            eng, net, R, max_iterations, on_iteration, history,
            round_solver)
    else:
        raise ValueError(f"unknown sweep {sweep!r}")

    # Net movers via the engine's commit ledger: only vertices it ever
    # committed can differ from the init, so the diff is O(touched).
    touched = eng.touched_vertices()
    moved = touched[eng.state.assign[touched] != init_snapshot[touched]]
    res = GladResult(
        assign=eng.state.assign, cost=eng.state.total, history=history,
        iterations=iters, accepted=accepted,
        wall_time_s=time.perf_counter() - t0,
        factors=eng.state.factors(), moved=moved,
    )
    res.repl_history = repl_history
    return _attach_replication(cm, res, replicate)


def _attach_replication(cm: CostModel, res: GladResult,
                        replicate) -> GladResult:
    """Final move-vs-replicate overlay on the solved cut (post-pass)."""
    if not replicate:
        return res
    opts = replicate if isinstance(replicate, dict) else {}
    repl = cm.replicate_greedy(res.assign, **opts)
    res.replication = repl
    res.replicated_cost = cm.replication_cost(res.assign, repl)["total"]
    return res


def _sweep_single(eng, pairs, R, rng, max_iterations, on_iteration, history):
    """Alg. 1 line 3-9: least-visited pair, accept on (delta) improvement."""
    visits = np.zeros(len(pairs), dtype=np.int64)
    r = iters = accepted = 0
    while r <= R and iters < max_iterations:
        mn = visits.min()
        cand = np.where(visits == mn)[0]
        p = cand[rng.integers(0, len(cand))]
        visits[p] += 1
        i, j = int(pairs[p, 0]), int(pairs[p, 1])

        solved, ok = eng.try_pair(i, j)
        iters += 1
        if solved and ok:
            accepted += 1
            r = 0
        else:
            r += 1
        history.append(eng.state.total)
        if on_iteration is not None:
            on_iteration(iters, eng.state.total)
    return iters, accepted


def _sweep_batched(eng, net, R, max_iterations, on_iteration, history,
                   round_solver="auto"):
    """Disjoint-pair rounds: each round solves a matching of server pairs
    from one snapshot (one block-diagonal flow per round by default), then
    applies the cuts with exact live deltas."""
    connected = {(int(i), int(j)) for i, j in net.pairs}
    rounds = [
        [p for p in rnd if p in connected]
        for rnd in round_robin_rounds(net.m)
    ]
    rounds = [rnd for rnd in rounds if rnd]
    if not rounds:
        return 0, 0
    r = iters = accepted = 0
    while r <= R and iters < max_iterations:
        for rnd in rounds:
            for _solved, ok in eng.sweep_round(rnd, solver=round_solver):
                iters += 1
                if ok:
                    accepted += 1
                    r = 0
                else:
                    r += 1
                history.append(eng.state.total)
                if on_iteration is not None:
                    on_iteration(iters, eng.state.total)
                if r > R or iters >= max_iterations:
                    return iters, accepted
    return iters, accepted


def _glad_s_reference(cm, assign, pairs, R, active, rng, backend,
                      max_iterations, on_iteration, t0):
    """Seed-path Alg. 1: full total() per proposal, per-edge-scan auxiliary
    construction.  Oracle for equivalence tests + the speedup benchmark."""
    init_snapshot = assign.copy()
    visits = np.zeros(len(pairs), dtype=np.int64)
    cur_cost = cm.total(assign)
    history = [cur_cost]
    r = iters = accepted = 0
    while r <= R and iters < max_iterations:
        mn = visits.min()
        cand = np.where(visits == mn)[0]
        p = cand[rng.integers(0, len(cand))]
        visits[p] += 1
        i, j = int(pairs[p, 0]), int(pairs[p, 1])

        proposal = solve_pair(cm, assign, i, j, active=active, backend=backend)
        iters += 1
        if proposal is not None:
            new_cost = cm.total(proposal)
            if new_cost < cur_cost - 1e-9:
                assign, cur_cost = proposal, new_cost
                accepted += 1
                r = 0
            else:
                r += 1
        else:
            r += 1
        history.append(cur_cost)
        if on_iteration is not None:
            on_iteration(iters, cur_cost)

    return GladResult(
        assign=assign, cost=cur_cost, history=history, iterations=iters,
        accepted=accepted, wall_time_s=time.perf_counter() - t0,
        factors=cm.factors(assign),
        moved=np.flatnonzero(assign != init_snapshot),
    )
