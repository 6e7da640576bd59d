"""What the reference models share: the precision they compute in, the
graph they read, the loss and plain SGD."""
from __future__ import annotations

import numpy as np
import torch


class Precision:
    """Exact arithmetic in ``dtype``: a product reads its operands as
    they are."""

    name = "exact"

    def __init__(self, dtype=torch.float64):
        self.dtype = dtype

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return x


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as the card's ``cvt.rna.tf32.f32`` does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _ToTF32(torch.autograd.Function):
    """TF32 rounding of a product's operand, and of the gradient that
    flows back into it (the backward's products read TF32 too)."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


class TF32(Precision):
    """float32 where every product (the dense layers and the neighbour
    sums) reads its operands in TF32 and accumulates in float32: what a
    float32 model gets from the tensor cores with TF32 on.  The control
    of a configuration that states float32 with TF32 off."""

    name = "tf32"

    def __init__(self):
        super().__init__(torch.float32)

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return _ToTF32.apply(x)


def graph_tensors(n: int, edges: np.ndarray, device) -> dict:
    """The directed arcs of the undirected ``edges`` (forward arcs, then
    the reversed ones) and every vertex's in-degree, on ``device``."""
    e = torch.as_tensor(np.asarray(edges, dtype=np.int64), device=device)
    src = torch.cat([e[:, 0], e[:, 1]])
    dst = torch.cat([e[:, 1], e[:, 0]])
    deg = torch.zeros(n, dtype=torch.float64, device=device)
    deg.index_add_(0, dst, torch.ones_like(dst, dtype=torch.float64))
    return {"n": n, "src": src, "dst": dst, "deg": deg}


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over every vertex (full batch)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0].mean()


def cast(params, dtype):
    return [{k: v.detach().to(dtype) for k, v in p.items()} for p in params]


def sgd(model, params, x, labels, graph, lr: float, steps: int,
        prec: Precision):
    """``steps`` full-batch SGD steps from ``params``: the loss before
    each step, the gradients of the first, and the parameters after each
    step, all in ``prec.dtype``."""
    p = cast(params, prec.dtype)
    losses, first_grads, after = [], None, []
    for _ in range(steps):
        leaves = [{k: v.clone().requires_grad_(True) for k, v in q.items()}
                  for q in p]
        with torch.enable_grad():
            loss = nll(model.forward(leaves, x, graph, prec), labels)
            flat = [v for q in leaves for v in q.values()]
            grads = iter(torch.autograd.grad(loss, flat))
        g = [{k: next(grads) for k in q} for q in leaves]
        if first_grads is None:
            first_grads = g
        with torch.no_grad():
            p = [{k: q[k] - lr * gq[k] for k in q} for q, gq in zip(p, g)]
        losses.append(loss.detach())
        after.append(p)
    return losses, first_grads, after
