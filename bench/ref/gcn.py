"""GCN (paper Eq. 1): a_v = sum_(u in N_v) h_u,
h_v' = sigma(W (a_v + h_v) / (|N_v| + 1)), ReLU between layers and none
after the last."""
from __future__ import annotations

import torch

from bench.ref.common import Precision

# Whether every vertex also attends to itself as an arc.
SELF_LOOPS = False


def forward(params, x: torch.Tensor, graph: dict,
            prec: Precision) -> torch.Tensor:
    src, dst, n = graph["src"], graph["dst"], graph["n"]
    norm = (graph["deg"].to(prec.dtype) + 1.0)[:, None]
    h = x.to(prec.dtype)
    for k, p in enumerate(params):
        hs = prec.operand(h)
        agg = torch.zeros_like(h).index_add(0, dst, hs[src])
        h = prec.operand((agg + hs) / norm) @ prec.operand(
            p["w"].to(prec.dtype))
        if k < len(params) - 1:
            h = torch.relu(h)
    return h


def aggregations(dims, train: bool) -> list:
    """The neighbour sums a step needs, as (direction, width): one forward
    sum a layer, and in training one transposed sum for every layer whose
    input needs a gradient (all but the first).  A layer's sum is taken at
    the narrower of its two widths, since A X W may be computed either way
    round."""
    widths = [min(a, b) for a, b in zip(dims[:-1], dims[1:])]
    out = [("fwd", w) for w in widths]
    if train:
        out += [("bwd", w) for w in widths[1:]]
    return out


def flops(counts: dict, dims, train: bool) -> float:
    """Floating-point operations of a forward (and, with ``train``, the
    backward with no gradient for the input features, the loss and the
    SGD update) on the real graph: ``counts`` gives ``n`` vertices and
    ``arcs`` directed links."""
    n, arcs = counts["n"], counts["arcs"]
    layers = list(zip(dims[:-1], dims[1:]))
    total = 0.0
    for k, (a, b) in enumerate(layers):
        w = min(a, b)
        last = k == len(layers) - 1
        total += arcs * w + 2 * n * w + 2 * n * a * b + (0 if last else n * b)
        if train:
            total += 2 * n * a * b                       # dL/dW
            if k > 0:                                    # dL/d(input)
                total += 2 * n * a * b + 2 * n * w + arcs * w + n * a
    if train:
        c = dims[-1]
        total += n * 4 * c + n * 2 * c                   # NLL and its grad
        total += 2 * sum(a * b for a, b in layers)       # SGD
    return float(total)


def param_shapes(dims) -> list:
    """Each layer's leaves and their shapes, with their Glorot fans."""
    return [{"w": ((a, b), a, b)} for a, b in zip(dims[:-1], dims[1:])]
