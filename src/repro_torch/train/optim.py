"""Optimizers: AdamW and Lion, the counterpart of ``repro.train.optim``.

States mirror the parameter tree leaf for leaf (an ``OptState`` of
``step``, ``m``, ``v``, with the reference's field names, so a checkpoint
of one restores in the other).  Lion keeps a single momentum, in bf16 as in
the reference (``for_model``), and a tree of fp32 zero scalars for ``v``.

The update is IN PLACE: :func:`apply_updates` writes the new parameters,
moments and ``step`` into the tensors it is given, under
``torch.no_grad()``, and returns them, so a train step captured into a CUDA
graph reads at its next replay what it returned.  The reference's update is functional; at
llama3.2-1b's 1.24 B parameters a functional copy of parameters and both
moments would hold another 20 GB of device memory.  Each leaf computes the
reference's formulas in fp32 in the reference's order and casts the
result to the leaf's dtype.  The reference's ``clip_by_global_norm`` is
applied inside the update: its scale ``min(1, max_norm / max(norm,
1e-9))`` multiplies each gradient as ``(g * scale).to(g.dtype)``.  A leaf
is updated in flat chunks of ``UPDATE_CHUNK`` elements, so the step holds
no clipped copy of the gradients and its fp32 temporaries stay
the size of a chunk: a stacked leaf of a model's layers (deepseek-moe-16b's
routed experts, 1.5 B parameters in four MoE layers) would otherwise take
several leaf-sized temporaries at once.  Every element sees the same
operations either way, so the result is the same bit for bit.
Under a mesh the parameters, gradients and moments are DTensors laid out
by the same specs (:func:`opt_state_specs`: the moments live where their
parameter's shard lives, never gathered).  The global norm is DTensor's
sum of every leaf's squares over every shard, so the clip scale is the same
on every process; each leaf's update then runs on its local shard, in flat
chunks of that shard (a flat view of a DTensor is not a flat view of its
shard).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | lion
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    momentum_dtype: Any = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any                        # zero scalars per leaf for lion


def tree_map(fn, *trees):
    """``fn`` over the leaves of dict trees of the same structure, in the
    order of :func:`leaves`."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(trees[0])}
    return fn(*trees)


def named_leaves(tree, prefix: str = "") -> list:
    """``(name, tensor)`` for each of the tree's tensors in the reference's
    flattening order (sorted dict keys); a name joins the keys with '/'."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def leaves(tree) -> list:
    """The tree's tensors in the order of :func:`named_leaves`."""
    return [x for _, x in named_leaves(tree)]


def _is_dtensor(t) -> bool:
    return hasattr(t, "placements")


def _local(t):
    """A DTensor's local shard (a view of its data), or the tensor."""
    return t.to_local() if _is_dtensor(t) else t


def init_opt_state(cfg: OptConfig, params) -> OptState:
    """Zero moments shaped (and, for DTensor parameters, laid out) as the
    parameters; Lion's ``v`` is a zero scalar per leaf."""
    def zeros(p, dtype):
        if _is_dtensor(p):
            return torch.zeros_like(p, dtype=dtype)
        return torch.zeros(p.shape, dtype=dtype, device=p.device)
    m = tree_map(lambda p: zeros(p, cfg.momentum_dtype), params)
    if cfg.name == "adamw":
        v = tree_map(lambda p: zeros(p, torch.float32), params)
    else:
        v = tree_map(lambda p: torch.zeros((), dtype=torch.float32,
                                           device=_local(p).device), params)
    dev = _local(leaves(params)[0]).device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev), m, v)


def opt_state_specs(cfg: OptConfig, param_specs):
    """The optimizer state's specs (the reference's): ``step`` replicated,
    ``m`` (and AdamW's ``v``) as the parameters, Lion's ``v`` scalars
    replicated."""
    from repro_torch.models.common import P
    if cfg.name == "adamw":
        v_specs = param_specs
    else:
        v_specs = tree_map(lambda s: P(), param_specs)
    return OptState(P(), param_specs, v_specs)


def _global_norm(grads):
    """The sqrt of the sum over the leaves, in order, of each leaf's fp32
    sum of squares."""
    return torch.sqrt(sum(g.float().square().sum() for g in leaves(grads)))


def _clip_scale(gn, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


# Elements a leaf's update works on at once (:func:`apply_updates`).
UPDATE_CHUNK = 1 << 26


def _chunks(p, g, *moments):
    """Aligned flat chunks of a leaf's parameter, gradient and moments (a
    DTensor's local shard), the written ones (parameter, moments:
    contiguous, as ``init_params`` and :func:`init_opt_state` make them) as
    views, so an in-place write to a chunk lands in the tensor."""
    p, g, *moments = (_local(t) for t in (p, g, *moments))
    return zip(p.view(-1).split(UPDATE_CHUNK),
               g.reshape(-1).split(UPDATE_CHUNK),
               *(t.view(-1).split(UPDATE_CHUNK) for t in moments))


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, state: OptState):
    """One clipped AdamW or Lion step, in place.  Returns (params,
    OptState(step, m, v), grad_norm): the same parameter, moment and step
    tensors, updated (``step`` + 1).  DTensor gradients are first laid out
    as their parameters."""
    if _is_dtensor(leaves(params)[0]):
        grads = tree_map(lambda p, g: g.redistribute(p.device_mesh,
                                                     p.placements),
                         params, grads)
    gn = _global_norm(grads)
    scale = _local(_clip_scale(gn, cfg.grad_clip))
    step = state.step.add_(1)
    if cfg.name == "adamw":
        t = step.float()
        bc1 = 1.0 - cfg.b1 ** t
        bc2 = 1.0 - cfg.b2 ** t

        def upd(p, g, m, v):
            g32 = (g * scale).to(g.dtype).float()
            m2 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g32.square())
            delta = (m2 / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            delta = delta + cfg.weight_decay * p.float()
            p.copy_((p.float() - cfg.lr * delta).to(p.dtype))
            m.copy_(m2.to(m.dtype))

        tree_map(lambda *leaf: [upd(*c) for c in _chunks(*leaf)],
                 params, grads, state.m, state.v)
        return params, OptState(step, state.m, state.v), gn
    if cfg.name == "lion":
        def upd(p, g, m):
            g32 = (g * scale).to(g.dtype).float()
            m32 = m.float()
            u = torch.sign(cfg.b1 * m32 + (1 - cfg.b1) * g32)
            u = u + cfg.weight_decay * p.float()
            p.copy_((p.float() - cfg.lr * u).to(p.dtype))
            m.copy_((cfg.b2 * m32 + (1 - cfg.b2) * g32).to(m.dtype))

        tree_map(lambda *leaf: [upd(*c) for c in _chunks(*leaf)],
                 params, grads, state.m)
        return params, OptState(step, state.m, state.v), gn
    raise ValueError(cfg.name)


def for_model(model_cfg) -> OptConfig:
    return OptConfig(name=getattr(model_cfg, "optimizer", "adamw"),
                     momentum_dtype=(torch.bfloat16
                                     if model_cfg.optimizer == "lion"
                                     else torch.float32))
