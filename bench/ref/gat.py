"""GAT (paper Eq. 2, GATv1): Wh_u = W h_u, per arc u -> v (self loops
included) e_vu = LeakyReLU_0.2(att_src . Wh_v + att_dst . Wh_u),
eta_vu = softmax over v's arcs, h_v' = sigma(sum_u eta_vu Wh_u), ReLU
between layers and none after the last."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.ref.common import Precision

# Whether every vertex also attends to itself as an arc.
SELF_LOOPS = True


def forward(params, x: torch.Tensor, graph: dict,
            prec: Precision) -> torch.Tensor:
    n = graph["n"]
    loops = torch.arange(n, device=graph["src"].device)
    src = torch.cat([graph["src"], loops])
    dst = torch.cat([graph["dst"], loops])
    h = x.to(prec.dtype)
    for k, p in enumerate(params):
        wh = prec.operand(h) @ prec.operand(p["w"].to(prec.dtype))
        whp = prec.operand(wh)
        a_dst = whp @ prec.operand(p["att_src"].to(prec.dtype))
        a_src = whp @ prec.operand(p["att_dst"].to(prec.dtype))
        logits = F.leaky_relu(a_dst[dst] + a_src[src], 0.2)
        top = torch.full((n,), float("-inf"), dtype=logits.dtype,
                         device=logits.device).scatter_reduce(
            0, dst, logits, reduce="amax", include_self=True)
        ex = torch.exp(logits - top[dst])
        denom = torch.zeros(n, dtype=ex.dtype, device=ex.device).index_add(
            0, dst, ex)
        eta = ex / denom[dst]
        h = torch.zeros((n, wh.shape[1]), dtype=wh.dtype,
                        device=wh.device).index_add(
            0, dst, prec.operand(eta)[:, None] * whp[src])
        if k < len(params) - 1:
            h = torch.relu(h)
    return h


def aggregations(dims, train: bool) -> list:
    """GAT's weights depend on the features: no fixed sparse product."""
    return []


def flops(counts: dict, dims, train: bool) -> float:
    """Floating-point operations of a forward (and, with ``train``, the
    backward with no gradient for the input features, the loss and the
    SGD update) on the real graph: ``n`` vertices, ``arcs`` directed links
    plus a self loop each."""
    n = counts["n"]
    arcs = counts["arcs"] + n
    layers = list(zip(dims[:-1], dims[1:]))
    total = 0.0
    for k, (a, b) in enumerate(layers):
        last = k == len(layers) - 1
        # W h, the two score projections, per arc: score, LeakyReLU, max,
        # shift, exp, sum, divide, then the weighted message and its sum.
        total += (2 * n * a * b + 4 * n * b + arcs * (7 + 2 * b)
                  + (0 if last else n * b))
        if train:
            total += 2 * n * a * b + arcs * (4 * b + 5) + 8 * n * b
            if k > 0:
                total += 2 * n * a * b + n * a
    if train:
        c = dims[-1]
        total += n * 4 * c + n * 2 * c
        total += 2 * sum(a * b + 2 * b for a, b in layers)
    return float(total)


def param_shapes(dims) -> list:
    """Each layer's leaves and their shapes, with their Glorot fans."""
    return [{"w": ((a, b), a, b), "att_src": ((b,), b, 1),
             "att_dst": ((b,), b, 1)} for a, b in zip(dims[:-1], dims[1:])]
