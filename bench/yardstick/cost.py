"""The DGPE cost of a layout (paper Eq. 4-9), frozen: a copy of the
arithmetic of ``repro_torch.core.cost.CostModel.factors`` and of
``workload_for``'s factors, summed in the same order, so it gives the same
bits on the same layout.

    C   = C_U + C_P + C_T + C_M                                   (Eq. 9)
    C_U = sum_v mu[v, a_v]                                        (Eq. 4)
    C_P = sum_v deg_v alpha_a agg + beta_a upd + gamma_a act      (Eq. 5, 6)
    C_T = sum_(u,v) in E tau[a_u, a_v]                            (Eq. 7)
    C_M = sum_v rho[a_v] + sum_i eps_i                            (Eq. 8)
"""
from __future__ import annotations

import numpy as np

# The three Eq. 5 terms' scale by model: (aggregation, update, activation).
SCALES = {"gcn": (1.0, 1.0, 1.0), "gat": (2.0, 1.25, 1.0),
          "sage": (0.75, 2.0, 1.0)}


def workload_units(model: str, dims) -> tuple:
    """(agg, upd, act) units of a model over its layer widths ``dims``:
    sum_k s_(k-1), sum_k s_(k-1) s_k and sum_k s_k, each scaled."""
    agg, upd, act = SCALES[model]
    dims = list(dims)
    return (agg * float(sum(dims[:-1])),
            upd * float(sum(a * b for a, b in zip(dims[:-1], dims[1:]))),
            act * float(sum(dims[1:])))


def degrees(n: int, edges: np.ndarray) -> np.ndarray:
    deg = np.zeros(n, dtype=np.int64)
    if len(edges):
        np.add.at(deg, edges[:, 0], 1)
        np.add.at(deg, edges[:, 1], 1)
    return deg


def factors(fleet: dict, n: int, edges: np.ndarray, model: str, dims,
            assign: np.ndarray) -> dict:
    """C_U, C_P, C_T, C_M and their total for ``assign`` (n,) in [0, m)."""
    assign = np.asarray(assign, dtype=np.int64)
    mu = np.array(fleet["mu"], dtype=np.float64)
    agg, upd, act = workload_units(model, dims)
    deg = degrees(n, edges).astype(np.float64)
    cp_matrix = (np.outer(deg, fleet["alpha"]) * agg
                 + fleet["beta"][None, :] * upd
                 + fleet["gamma"][None, :] * act)
    cu = float(mu[np.arange(n), assign].sum())
    cp = float(cp_matrix[np.arange(n), assign].sum())
    if len(edges):
        w = np.ones(len(edges))
        ct = float((fleet["tau"][assign[edges[:, 0]], assign[edges[:, 1]]]
                    * w).sum())
    else:
        ct = 0.0
    cm = float(fleet["rho"][assign].sum() + fleet["eps"].sum())
    return {"C_U": cu, "C_P": cp, "C_T": ct, "C_M": cm,
            "total": cu + cp + ct + cm}


def total(fleet: dict, n: int, edges: np.ndarray, model: str, dims,
          assign: np.ndarray) -> float:
    return factors(fleet, n, edges, model, dims, assign)["total"]
