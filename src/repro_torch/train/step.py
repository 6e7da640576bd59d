"""Train-step builder: microbatched gradient accumulation and optional int8
gradient compression with error feedback, the counterpart of
``repro.train.step`` on one device.

``make_train_step(cfg, opt_cfg, microbatches, compress_grads, loss_fn)``
returns a function

    (params, opt_state, ef, batch) -> (params', opt_state', ef', metrics)

that updates ``params`` and the optimizer's moments in place
(:func:`optim.apply_updates`).  Microbatching splits the batch on its
leading axis and accumulates gradients in a Python loop (the reference's
``lax.scan``) with the reference's formula: ``acc + g / M`` in fp32, kept
in bf16 under Lion, and ``loss / M``.  Gradient compression quantizes each
leaf to int8 (per-leaf absmax scale) with an error-feedback residual
carried across steps (``torch.round`` rounds half to even, as
``jnp.round``).  ``jit_train_step`` (GSPMD sharding) comes with
``launch/``'s mesh work.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import models as zoo
from repro_torch.models.common import LMConfig
from repro_torch.train import optim


def _quantize_int8(g, ef):
    """Error-feedback int8 quantization: returns (dequantized, new_ef)."""
    g32 = g.float() + ef
    scale = g32.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g32 / scale), -127, 127)
    deq = q * scale
    return deq.to(g.dtype), g32 - deq


def init_error_feedback(params):
    return optim.tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)


def make_train_step(
    cfg: LMConfig,
    opt_cfg: Optional[optim.OptConfig] = None,
    microbatches: int = 1,
    compress_grads: bool = False,
    loss_fn: Optional[Callable] = None,
):
    """The step function (module docstring); ``step.grads_of(params,
    batch)`` gives the (loss, gradients) it would apply, with no update."""
    opt_cfg = opt_cfg or optim.for_model(cfg)
    loss_fn = loss_fn or (lambda p, b: zoo.loss_fn(cfg, p, b))
    # Lion's sign-based update tolerates bf16 accumulation, as in the
    # reference.
    acc_dtype = torch.bfloat16 if opt_cfg.name == "lion" else torch.float32

    def value_and_grad(params, batch):
        """(loss, gradients) of ``loss_fn`` at ``params``: autograd through
        aliases of the leaves, so ``params`` is left as it was."""
        alias = optim.tree_map(lambda p: p.detach().requires_grad_(True),
                               params)
        with torch.enable_grad():
            loss = loss_fn(alias, batch)
            grads = torch.autograd.grad(loss, optim.leaves(alias))
        it = iter(grads)
        return loss.detach(), optim.tree_map(lambda _: next(it), alias)

    def grads_of(params, batch):
        if microbatches <= 1:
            return value_and_grad(params, batch)
        mb = {k: x.reshape((microbatches, x.shape[0] // microbatches)
                           + tuple(x.shape[1:])) for k, x in batch.items()}
        acc = optim.tree_map(lambda p: torch.zeros(
            p.shape, dtype=acc_dtype, device=p.device), params)
        loss_acc = 0.0
        for i in range(microbatches):
            loss, grads = value_and_grad(params, {k: x[i]
                                                  for k, x in mb.items()})
            acc = optim.tree_map(lambda a, g: (
                a.float() + g.float() / microbatches).to(acc_dtype),
                acc, grads)
            del grads
            loss_acc = loss_acc + loss / microbatches
        return loss_acc, acc

    def step(params, opt_state, ef, batch):
        """``ef`` is the error-feedback tree when compressing, else None."""
        loss, grads = grads_of(params, batch)
        if compress_grads:
            out = optim.tree_map(_quantize_int8, grads, ef)
            grads = optim.tree_map(lambda o: o[0], out)
            ef = optim.tree_map(lambda o: o[1], out)
        params, opt_state, gn = optim.apply_updates(opt_cfg, params, grads,
                                                    opt_state)
        metrics = {"loss": loss, "grad_norm": gn, "step": opt_state.step}
        return params, opt_state, ef, metrics

    step.grads_of = grads_of
    return step

