"""GLAD-A: adaptive scheduling between GLAD-E and GLAD-S (paper Alg. 3).

The performance drift f(t) = C^E(t) - C^S(t) cannot be observed (only one
algorithm runs per slot), so GLAD-A tracks the Thm-8 upper bound

    f(t) <= C(pi(t-1) | G(t)) - C(t-1)

i.e. the cost of the *unadjusted* layout on the evolved graph minus last
slot's cost — computable from known quantities.  While the accumulated drift
stays within the SLA theta, the cheap incremental GLAD-E runs; once exceeded,
a global GLAD-S re-layout is triggered and the accumulator resets.

The port's copy of ``repro.core.glad_a``, with ``repro`` renamed ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.cost import CostModel, GNNWorkload
from repro_torch.core.engine import LayoutSession
from repro_torch.core.glad_e import glad_e, seed_new_vertices
from repro_torch.core.glad_s import glad_s
from repro_torch.graphs.datagraph import DataGraph
from repro_torch.graphs.edgenet import EdgeNetwork


def drift_bound(
    cm_new: CostModel,
    old_graph: DataGraph,
    assign_old: np.ndarray,
    last_cost: float,
) -> float:
    """Thm 8: f(t) <= C(pi(t-1)|G(t)) - C(t-1).

    The unadjusted layout is pi(t-1) carried forward; per the proof, inserted
    vertices are charged at their *maximum*-cost server to keep the bound an
    upper bound; deletions never raise cost.
    """
    new_graph = cm_new.graph
    assign = np.zeros(new_graph.n, dtype=np.int64)
    keep = min(old_graph.n, new_graph.n)
    assign[:keep] = assign_old[:keep]
    carried = cm_new.total(assign)
    if new_graph.n > old_graph.n:
        placed = np.ones(new_graph.n, dtype=bool)
        placed[old_graph.n:] = False
        extra = 0.0
        for v in range(old_graph.n, new_graph.n):
            # Vectorized over servers x placed neighbors (CostModel caches).
            extra += float(cm_new.marginal_all(placed, assign, v).max())
            placed[v] = True
        # carried already counted them at server 0; replace with the max bound.
        base_ids = np.arange(old_graph.n, new_graph.n)
        carried -= float(cm_new.unary[base_ids, assign[base_ids]].sum())
        carried += extra
    return max(0.0, carried - last_cost)


@dataclasses.dataclass
class SlotRecord:
    t: int
    algorithm: str          # 'glad-e' | 'glad-s'
    cost: float
    drift_estimate: float
    accumulated_drift: float
    migrated_vertices: int
    wall_time_s: float


class GladA:
    """Stateful adaptive scheduler over a stream of evolved graphs."""

    def __init__(
        self,
        net: EdgeNetwork,
        gnn: GNNWorkload,
        graph0: DataGraph,
        theta: float,
        R: Optional[int] = None,
        seed: int = 0,
        backend: str = "auto",
        session: "bool | LayoutSession" = True,
    ):
        self.net, self.gnn, self.theta = net, gnn, theta
        self.R, self.seed, self.backend = R, seed, backend
        # Cross-slot persistent engine: assembly cache + warm residuals
        # earned in slot t survive into slot t+1 (trajectories stay
        # bit-identical with session=False; only wall time changes).
        if session is True:
            session = LayoutSession(backend=backend)
        elif session is False:
            session = None
        self.session = session
        cm0 = CostModel(net, graph0, gnn)
        res = glad_s(cm0, R=R, seed=seed, backend=backend,
                     session=self.session)
        self.graph = graph0
        self.assign = res.assign
        self.last_cost = res.cost
        self.acc_drift = 0.0
        self.t = 0
        self.records: List[SlotRecord] = [
            SlotRecord(0, "glad-s", res.cost, 0.0, 0.0, 0, res.wall_time_s)
        ]

    def step(self, new_graph: DataGraph) -> SlotRecord:
        """Paper Alg. 3 for one time slot."""
        self.t += 1
        cm_new = CostModel(self.net, new_graph, self.gnn)
        f_hat = drift_bound(cm_new, self.graph, self.assign, self.last_cost)
        self.acc_drift += f_hat

        if self.acc_drift <= self.theta:
            algo = "glad-e"
            res = glad_e(
                cm_new, self.graph, self.assign,
                R=self.R, seed=self.seed + self.t, backend=self.backend,
                session=self.session,
            )
        else:
            algo = "glad-s"
            # Warm-start global re-layout from the carried layout.
            assign = np.zeros(new_graph.n, dtype=np.int64)
            keep = min(self.graph.n, new_graph.n)
            assign[:keep] = self.assign[:keep]
            if new_graph.n > self.graph.n:
                mask = np.zeros(new_graph.n, dtype=bool)
                mask[self.graph.n:] = True
                assign = seed_new_vertices(cm_new, assign, mask)
            res = glad_s(
                cm_new, R=self.R, init=assign,
                seed=self.seed + self.t, backend=self.backend,
                session=self.session,
            )
            self.acc_drift = 0.0

        keep = min(self.graph.n, new_graph.n, len(res.assign), len(self.assign))
        migrated = int((res.assign[:keep] != self.assign[:keep]).sum())
        self.graph = new_graph
        self.assign = res.assign
        self.last_cost = res.cost
        rec = SlotRecord(
            self.t, algo, res.cost, f_hat, self.acc_drift, migrated,
            res.wall_time_s,
        )
        self.records.append(rec)
        return rec
