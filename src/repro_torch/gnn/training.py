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

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.gnn.distributed import call_captured, input_signature
from repro_torch.gnn.models import GNNConfig, forward, loss_fn
from repro_torch.step import resolve_graphs


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
    lr: float = 0.05, graphs: Optional[bool] = None,
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
    update (eagerly).  ``step.set_targets(labels_blocks, mask_blocks)``
    rewrites the labels and the mask in place (a relayout moves them), so
    a captured step replays over new targets too.

    ``graphs`` (None: as the forward's ``graphs``) captures the step, as
    the reference jits it: the forward, ``torch.autograd.grad`` through
    K1's backward and the segment sums', and the SGD update, as one CUDA
    graph per input signature (:class:`repro_torch.step.Step`; its first
    call runs eagerly).  The parameters, ``blocks`` and ``replica0`` go
    into its static input buffers, and each call returns new tensors.  The
    forward's plan is synced before each call: a value-only patch is read
    by the next replay, a rebuild captures anew.  True raises on the CPU
    and over ranks, whose gloo collectives are not captured.
    ``step.steps`` maps each input signature of the current build to its
    Step."""
    dev = bsp_forward.device
    comm = getattr(bsp_forward, "comm", None)
    if graphs is None:
        graphs = getattr(bsp_forward, "graphs", False)
    elif graphs and comm is not None:
        raise ValueError("make_distributed_train_step(graphs=True): the "
                         "rank forward's gloo collectives are not captured")
    graphs = resolve_graphs(graphs, dev, "make_distributed_train_step")
    run = getattr(bsp_forward, "eager", bsp_forward)
    labels = _on(labels_blocks, dev, torch.long).clone()
    mask = _on(mask_blocks, dev, torch.float32).clone()
    count = torch.ones((), device=dev)

    def set_targets(labels_blocks, mask_blocks):
        for name, t, new in (("labels", labels, _on(labels_blocks, dev,
                                                     torch.long)),
                             ("mask", mask, _on(mask_blocks, dev,
                                                torch.float32))):
            if new.shape != t.shape:
                raise ValueError(f"{name} blocks of shape "
                                 f"{tuple(new.shape)}, the step's are "
                                 f"{tuple(t.shape)}")
            t.copy_(new)
        total = mask.sum() if comm is None else comm.sum_over_ranks(
            mask.sum().reshape(1))[0]
        count.copy_(torch.clamp(total, min=1.0))

    set_targets(labels, mask)

    def loss_of(params, blocks, replica0):
        out = run(params, blocks, replica0=replica0)
        logp = torch.log_softmax(out, dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        nll = nll * mask
        return nll.sum() / count

    def loss_and_grads(params, blocks, replica0=None):
        loss, grads = _value_and_grad(loss_of, params, blocks, replica0)
        if comm is not None:
            loss, grads = _summed_over_ranks(comm, loss, grads)
        return loss, grads

    def eager_step(params, blocks, replica0=None):
        loss, grads = loss_and_grads(params, blocks, replica0)
        return sgd_step(params, grads, lr), loss

    steps = {}                  # input signature -> Step, a build's
    built = [None]

    def step(params, blocks, replica0=None):
        if not graphs:
            return eager_step(params, blocks, replica0)
        bsp_forward.sync()
        if built[0] != bsp_forward.stats["builds"]:
            steps.clear()
            built[0] = bsp_forward.stats["builds"]
        r0 = replica0 if bsp_forward.reads_replica0(replica0) else None
        new, loss = call_captured(
            steps, input_signature(params, blocks, r0),
            f"train {cfg.model} {bsp_forward.mode}", eager_step, pool, dev,
            params, blocks, r0)
        return ([{k: v.clone() for k, v in p.items()} for p in new],
                loss.clone())

    pool = torch.cuda.graph_pool_handle() if graphs else None
    step.loss_and_grads = loss_and_grads
    step.set_targets = set_targets
    step.graphs = graphs
    step.steps = steps
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
