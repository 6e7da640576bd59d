"""GNN training (node classification, the paper's SIoT/Yelp tasks).

The counterpart of ``repro.gnn.training``: whole-graph full-batch training
and the distributed train step over the BSP forward.  Gradients come from
``torch.autograd.grad`` where the reference uses ``jax.value_and_grad``;
parameters stay the port's list of per-layer dicts, and a step returns new
tensors, ``p - lr * g``, as the reference's ``sgd_step`` does.

The distributed step differentiates through the one-device BSP forward:
the exchange's adjoint moves each halo row's gradient back to its owner
(the roll transposes to the opposite roll, the allgather's gather to a
segment sum over owners), and K1's backward is the same kernel over the
transposed operand.  Every gradient on the card is summed in a fixed order,
so a step is bit-equal run to run.

Over the rank forward (:func:`repro_torch.gnn.ranks.make_rank_bsp_forward`,
one process per edge server) each rank's loss is its own rows' masked NLL
sum over the global mask count, the gradients flow back through the
exchange's adjoint collectives, and the ranks' gradients are summed in rank
order (an all-gather, then a sum on the host), so every rank applies the
same bits and the replicas of the parameters stay equal.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.gnn.models import GNNConfig, forward, loss_fn


def sgd_step(params, grads, lr: float):
    """New parameters ``p - lr * g`` for every leaf."""
    with torch.no_grad():
        return [{k: v - lr * g[k] for k, v in p.items()}
                for p, g in zip(params, grads)]


def _value_and_grad(loss_of: Callable, params, *args):
    """``loss_of(params, *args)`` and its gradient with respect to every
    leaf of ``params``, taken on detached copies (``params`` is left as
    it is)."""
    leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
              for p in params]
    with torch.enable_grad():
        loss = loss_of(leaves, *args)
        flat = [v for p in leaves for v in p.values()]
        got = iter(torch.autograd.grad(loss, flat, allow_unused=True,
                                       materialize_grads=True))
    grads = [{k: next(got) for k in p} for p in leaves]
    return loss.detach(), grads


def _on(x, dev, dtype=None):
    t = torch.as_tensor(x).to(dev)
    return t if dtype is None else t.to(dtype)


def loss_and_grads(cfg: GNNConfig, params, features, src_dst, labels,
                   mask=None, device: DeviceLike = "cuda"):
    """The whole-graph ``loss_fn`` and its gradients (a list of per-layer
    dicts), on ``device``."""
    dev = resolve_device(device)
    params = [{k: _on(v, dev) for k, v in p.items()} for p in params]
    feats = _on(features, dev, cfg.dtype)
    sd = _on(src_dst, dev, torch.long)
    lab = _on(labels, dev, torch.long)
    m = None if mask is None else _on(mask, dev, cfg.dtype)
    return _value_and_grad(
        lambda p: loss_fn(cfg, p, feats, sd, lab, m), params)


def train_step(cfg: GNNConfig, params, features, src_dst, labels, lr: float,
               mask=None, device: DeviceLike = "cuda"):
    """One full-batch SGD step: returns (new params, loss)."""
    dev = resolve_device(device)
    params = [{k: _on(v, dev) for k, v in p.items()} for p in params]
    loss, grads = loss_and_grads(cfg, params, features, src_dst, labels,
                                 mask, dev)
    return sgd_step(params, grads, lr), loss


def fit(cfg: GNNConfig, params, features, src_dst, labels, steps: int = 100,
        lr: float = 0.05, mask=None, log_every: int = 0,
        device: DeviceLike = "cuda"):
    """Full-batch training loop; returns (params, losses)."""
    dev = resolve_device(device)
    feats = _on(features, dev, cfg.dtype)
    sd = _on(src_dst, dev, torch.long)
    lab = _on(labels, dev, torch.long)
    losses = []
    for s in range(steps):
        params, loss = train_step(cfg, params, feats, sd, lab, lr, mask, dev)
        losses.append(float(loss))
        if log_every and s % log_every == 0:
            print(f"step {s:4d} loss {float(loss):.4f}")
    return params, losses


def accuracy(cfg: GNNConfig, params, features, src_dst, labels,
             device: DeviceLike = "cuda") -> float:
    """Fraction of vertices whose argmax logit is their label."""
    dev = resolve_device(device)
    with torch.no_grad():
        logits = forward(cfg, [{k: _on(v, dev) for k, v in p.items()}
                               for p in params],
                         _on(features, dev, cfg.dtype),
                         _on(src_dst, dev, torch.long))
    pred = torch.argmax(logits, -1).cpu().numpy()
    return float((pred == np.asarray(labels)).mean())


def make_distributed_train_step(
    cfg: GNNConfig, bsp_forward: Callable, labels_blocks, mask_blocks,
    lr: float = 0.05,
):
    """Distributed train step over the BSP engine.

    ``bsp_forward(params, blocks, replica0=None)`` is
    :func:`repro_torch.gnn.distributed.make_bsp_forward`'s forward, with
    labels and mask as (P, cap) blocks (``scatter_ints`` of the labels and
    of a 0/1 mask); or a rank's forward from
    :func:`repro_torch.gnn.ranks.make_rank_bsp_forward`, with the rank's
    own rows of those blocks, shaped as its block without the feature axis.
    The loss is the masked mean NLL over all blocks, as in the reference;
    on ranks, every rank gets that global loss and the gradients summed
    over ranks (building the step is a collective: it sums the mask).
    Returns ``step(params, blocks, replica0=None) -> (new params, loss)``;
    ``step.loss_and_grads`` gives the loss and the gradients without the
    update."""
    dev = bsp_forward.device
    comm = getattr(bsp_forward, "comm", None)
    labels = _on(labels_blocks, dev, torch.long)
    mask = _on(mask_blocks, dev, torch.float32)
    total = mask.sum() if comm is None else comm.sum_over_ranks(
        mask.sum().reshape(1))[0]
    count = torch.clamp(total, min=1.0)

    def loss_of(params, blocks, replica0):
        out = bsp_forward(params, blocks, replica0=replica0)
        logp = torch.log_softmax(out, dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        nll = nll * mask
        return nll.sum() / count

    def loss_and_grads(params, blocks, replica0=None):
        loss, grads = _value_and_grad(loss_of, params, blocks, replica0)
        if comm is not None:
            loss, grads = _summed_over_ranks(comm, loss, grads)
        return loss, grads

    def step(params, blocks, replica0=None):
        loss, grads = loss_and_grads(params, blocks, replica0)
        return sgd_step(params, grads, lr), loss

    step.loss_and_grads = loss_and_grads
    return step


def _summed_over_ranks(comm, loss, grads):
    """The loss and every gradient leaf summed over the ranks, in rank
    order, by one collective over their concatenation."""
    leaves = [g for layer in grads for g in layer.values()]
    flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in leaves])
    total = comm.sum_over_ranks(flat)
    parts = iter(torch.split(total[1:], [g.numel() for g in leaves]))
    return total[0], [{k: next(parts).reshape(g.shape) for k, g in
                       layer.items()} for layer in grads]
