"""De-facto placement baselines the paper compares against (Sec. VI-A):

  Random — each client to an arbitrary server.
  Greedy — each client to the server minimizing its *individual* cost
           (data collection + GNN computation + data-dependent maintenance,
           i.e. the unary term; ignores cross-edge traffic).

The port's copy of ``repro.core.baselines``, with ``repro`` renamed ``repro_torch``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.cost import CostModel


def random_layout(cm: CostModel, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cm.net.m, size=cm.graph.n).astype(np.int64)


def greedy_layout(cm: CostModel) -> np.ndarray:
    """argmin_i [ mu_vi + C_P(v,i) + rho_i ] per vertex."""
    return cm.unary.argmin(axis=1).astype(np.int64)


def uploading_first_layout(cm: CostModel) -> np.ndarray:
    """The initialization tactic discussed in Sec. IV-B: greedily minimize C_U
    only — useful when data collection dominates."""
    return cm.net.mu.argmin(axis=1).astype(np.int64)
