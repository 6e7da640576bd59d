"""GLAD-E: incremental layout optimization for evolved graphs (paper Alg. 2).

Only the vertices that can *increase* cost — newly inserted ones and those
with fresh cross-server links — are re-optimized; everything else keeps its
slot (no migration, no service interruption).  Implemented by running GLAD-S
with an ``active`` mask so the frozen layout contributes exact side-effect
terms to every auxiliary cut (a boundary-aware refinement of the paper's
"extract G+ and call GLAD-S" description; noted in DESIGN.md §7).

The port's copy of ``repro.core.glad_e``, with ``repro`` renamed ``repro_torch``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.cost import CostModel
from repro_torch.core.evolution import changed_vertices
from repro_torch.core.engine import LayoutSession
from repro_torch.core.glad_s import GladResult, glad_s
from repro_torch.graphs.datagraph import DataGraph

#: Churn-measured escalation policy (``multilevel='auto'``): escalate to
#: the V-cycle iff its estimated cost undercuts the masked incremental
#: sweep's.  Both scale ~linearly in the vertices they touch — the sweep
#: in churned vertices (plus their boundary rings), the V-cycle in ALL
#: vertices — so the decision reduces to a break-even churn fraction:
#: escalate iff measured churn > (V-cycle per-vertex cost) / (incremental
#: per-vertex cost).  A fresh coarsen+solve+refine pass costs about twice
#: an incremental sweep per touched vertex, putting the fresh break-even
#: at 0.5 — exactly the pre-existing ``active.mean() > 0.5`` heuristic,
#: now derived instead of guessed.
MULTILEVEL_ESCALATE_FRESH = 0.5
#: With a valid persistent LevelStack (session carries a hierarchy built
#: over this same graph) the escalation skips matching + contraction and
#: only rebuilds coarse cost models, roughly halving the V-cycle's
#: per-vertex cost — the break-even churn drops with it.
MULTILEVEL_ESCALATE_STACKED = 0.25


def seed_new_vertices(
    cm: CostModel, assign: np.ndarray, new_mask: np.ndarray
) -> np.ndarray:
    """Greedy-marginal initial placement for vertices with no slot yet.

    Sequential over new vertices (each placement feeds the next one's
    marginal), vectorized over servers x placed neighbors via
    :meth:`CostModel.marginal_all`."""
    assign = assign.copy()
    placed = ~new_mask
    for v in np.where(new_mask)[0]:
        assign[v] = int(np.argmin(cm.marginal_all(placed, assign, int(v))))
        placed[v] = True
    return assign


def glad_e(
    cm_new: CostModel,
    old_graph: DataGraph,
    assign_old: np.ndarray,
    R: Optional[int] = None,
    seed: int = 0,
    backend: str = "auto",
    sweep: str = "batched",
    workers: int = 0,
    cache: "bool | str" = "auto",
    chunk_nodes: "int | str" = "auto",
    warm: "bool | str" = "auto",
    multilevel: "bool | str" = False,
    coarsen_to: int = 1024,
    levels: Optional[int] = None,
    chunk_vertices: "int | str | None" = None,
    replicate: "bool | dict" = False,
    session: Optional[LayoutSession] = None,
) -> GladResult:
    """Args:
      cm_new: cost model bound to the *evolved* graph G(t).
      old_graph / assign_old: G(t-1) and its layout pi(t-1).
      sweep: GLAD-S sweep discipline — incremental relayout defaults to the
        batched disjoint-pair rounds (block-diagonal round solver), since
        the changed-vertex filter wants wall time, not the Alg.-1 order.
      workers / cache / chunk_nodes / warm: engine knobs, passed through to
        :func:`glad_s` (assembly caching, chunked/parallel block solves,
        warm-started incremental re-solves).  GLAD-E's active-mask workload
        is exactly the regime both 'auto' policies enable themselves for.
      multilevel / coarsen_to / levels / chunk_vertices: escalation to
        the multilevel V-cycle when the churn is too large for the
        incremental path to pay: with ``multilevel=True`` — or 'auto' and
        measured churn above the break-even fraction
        (:data:`MULTILEVEL_ESCALATE_FRESH`, dropping to
        :data:`MULTILEVEL_ESCALATE_STACKED` when the session holds a
        still-valid LevelStack for this graph) — the masked refinement is
        replaced by a full coarsen/solve/refine V-cycle warm-started from
        the carried-over layout — a massively-evolved graph is a fresh
        layout problem, and the V-cycle is the fast full solver.
        ``chunk_vertices`` streams the escalation's coarsening in bounded
        vertex windows.  Default False keeps the masked incremental path
        (bit-identical to previous behavior).
      replicate: move-vs-replicate overlay, forwarded to :func:`glad_s` —
        re-greedied after each accepted round of the refinement and
        attached to the result (``result.replication``).  A post-pass:
        the evolved layout itself is bit-identical with the knob off.
      session: optional :class:`~repro_torch.core.engine.LayoutSession` carrying
        engine state (assembly cache + warm residuals) and the persistent
        LevelStack hierarchy across slots.  The masked incremental
        refinement adopts its engine; a multilevel escalation threads it
        through so the V-cycle refreshes the session's LevelStack (and
        its finest refinement adopts the engine) instead of coarsening
        from scratch.  Only the no-change early exit leaves the session
        untouched.  Trajectories are bit-identical with or without a
        session.

    The result's ``moved`` is the relayout's move delta RELATIVE TO the
    carried-over old layout — net movers plus every newly-inserted vertex —
    i.e. exactly the set :func:`repro_torch.gnn.distributed.patch_plan` needs to
    patch a live ShardPlan after the incremental relayout.
    """
    new_graph = cm_new.graph
    active = changed_vertices(old_graph, new_graph, assign_old)

    # Carry forward the old layout; pad and seed newly-inserted vertices.
    assign = np.zeros(new_graph.n, dtype=np.int64)
    keep = min(old_graph.n, new_graph.n)
    assign[:keep] = assign_old[:keep]
    new_ids = np.arange(old_graph.n, new_graph.n, dtype=np.int64)
    if new_graph.n > old_graph.n:
        new_mask = np.zeros(new_graph.n, dtype=bool)
        new_mask[old_graph.n:] = True
        assign = seed_new_vertices(cm_new, assign, new_mask)

    if not active.any():
        from repro_torch.core.glad_s import _attach_replication
        f = cm_new.factors(assign)
        return _attach_replication(
            cm_new,
            GladResult(assign, f["total"], [f["total"]], 0, 0, 0.0, f,
                       moved=new_ids),
            replicate)

    # Churn-triggered escalation: when (almost) everything changed, the
    # masked incremental refinement degenerates into a flat full sweep —
    # hand the problem to the V-cycle instead, warm-started from the
    # carried layout (the mask is dropped; the V-cycle refines boundaries
    # at every level, a superset of the changed set's effect).  The
    # break-even churn is cost-measured: cheaper V-cycles (a session
    # whose LevelStack is still valid for this graph skips the coarsening
    # work) escalate earlier.  Evolution normally changes the graph and so
    # invalidates the stack — the stacked threshold engages on relayouts
    # of an UNCHANGED graph (fault-runtime degrades/stragglers).
    if multilevel == "auto":
        churn = float(active.mean())
        stacked = session is not None and session.stack_valid_for(
            cm_new, coarsen_to=coarsen_to, max_levels=levels)
        multilevel = churn > (MULTILEVEL_ESCALATE_STACKED if stacked
                              else MULTILEVEL_ESCALATE_FRESH)
    if multilevel:
        res = glad_s(
            cm_new, R=R, init=assign, seed=seed, backend=backend,
            workers=workers, cache=cache, chunk_nodes=chunk_nodes,
            warm=warm, multilevel=True, coarsen_to=coarsen_to,
            levels=levels, chunk_vertices=chunk_vertices,
            replicate=replicate, session=session,
        )
        res.moved = (np.union1d(res.moved, new_ids) if len(new_ids)
                     else res.moved)
        return res

    # R defaults small for incremental updates (the filtered set is small).
    if R is None:
        R = max(3, cm_new.net.m)
    res = glad_s(
        cm_new, R=R, init=assign, active=active, seed=seed, backend=backend,
        sweep=sweep, workers=workers, cache=cache, chunk_nodes=chunk_nodes,
        warm=warm, replicate=replicate, session=session,
    )
    # glad_s diffs against the seeded init; fold the insertions back in.
    res.moved = np.union1d(res.moved, new_ids) if len(new_ids) else res.moved
    return res
