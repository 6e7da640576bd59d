"""Train-step builder: microbatched gradient accumulation and optional int8
gradient compression with error feedback, the counterpart of
``repro.train.step``.

``make_train_step(cfg, opt_cfg, microbatches, compress_grads, loss_fn)``
returns a function

    (params, opt_state, ef, batch) -> (params', opt_state', ef', metrics)

that updates ``params``, the optimizer's moments and step and the error
feedback in place (:func:`optim.apply_updates`) and returns them.
Microbatching splits the batch on its leading axis and accumulates
gradients in a Python loop (the reference's ``lax.scan``) with the
reference's formula: ``acc + g / M`` in fp32, kept in bf16 under Lion,
and ``loss / M``.  Gradient compression quantizes each leaf to int8
(per-leaf absmax scale) with an error-feedback residual carried across
steps (``torch.round`` rounds half to even, as ``jnp.round``).

Under a mesh (``dist``) the step runs over DTensors: ``loss_fn`` is the
zoo's under ``dist``, each gradient is laid out as its parameter, the
microbatch split takes global rows ``i*B/M .. (i+1)*B/M - 1`` (the
reference's reshape) and re-states the batch placement, and the update
runs on the local shards (``optim``).  :func:`jit_train_step` is the
reference's ``jax.jit`` of the step with every input and output laid out
by the specs.

On the card, with or without a mesh, the step is the reference's
``jax.jit`` of it (``launch/train.py``, ``jit_train_step``): one
:class:`repro_torch.step.Step` for each input signature (the shapes and
dtypes of the parameters, moments, step, error feedback and batch, and
under a mesh their placements), run eagerly at its first call, then
captured into a CUDA graph and replayed.  The step adopts the state
tensors of that first call as its buffers: it updates them in place and
returns them, so the next call, given them back, copies nothing but the
batch (the reference's ``donate_argnums``); other state tensors (a
restored checkpoint's) are copied in once.  ``loss`` and ``grad_norm`` are
the graph's outputs, rewritten by its next replay.  Under a mesh the
gradients' redistribution, the microbatch split, ``Dist.wsc``'s hold on
the gradients and the in-place update on the local shards all run inside
the capture; DTensor's dispatch runs only there.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import models as zoo
from repro_torch.models import moe
from repro_torch.models.common import (Dist, LMConfig, local_device,
                                       placements)
from repro_torch.step import cached_step, resolve_graphs, spec
from repro_torch.train import optim


def _quantize_int8(g, ef):
    """Error-feedback int8 quantization: returns (dequantized, ef), the
    new residual written into ``ef``."""
    g32 = g.float() + ef
    scale = g32.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g32 / scale), -127, 127)
    deq = q * scale
    return deq.to(g.dtype), ef.copy_(g32 - deq)


def init_error_feedback(params):
    def zeros(p):
        if hasattr(p, "placements"):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return optim.tree_map(zeros, params)


def microbatch_dist(dist: Dist, rows: int) -> Dist:
    """The Dist a batch of ``rows`` rows runs under: ``dist`` when its batch
    axes split the rows evenly, else the axes that do by
    ``launch.sharding.batch_dim_spec``'s rule ('data' alone, or none).
    The reference's sharding constraint pads such a split instead
    (llama3.2-1b's 16-row microbatches over 2x16 batch shards); either way
    each device runs one row."""
    from repro_torch.launch.sharding import batch_dim_spec
    spec = batch_dim_spec(rows, dist)
    axes = () if spec is None else (spec if isinstance(spec, tuple)
                                    else (spec,))
    if axes == tuple(dist.batch_axes):
        return dist
    return dataclasses.replace(dist, batch_axes=axes)


def _split_placed(x, microbatches: int, dist: Dist):
    """Microbatches of a DTensor batch leaf: global rows ``i*B/M ..
    (i+1)*B/M - 1``, each laid out over the batch axes again."""
    from torch.distributed.tensor import Replicate
    rows = x.shape[0] // microbatches
    whole = x.redistribute(dist.mesh, [Replicate()] * dist.mesh.ndim)
    whole = whole.reshape((microbatches, rows) + tuple(x.shape[1:]))
    rest = [None] * (x.ndim - 1)
    spec = microbatch_dist(dist, rows).batch
    return [dist.wsc(whole[i], spec, *rest) for i in range(microbatches)]


def make_train_step(
    cfg: LMConfig,
    opt_cfg: Optional[optim.OptConfig] = None,
    microbatches: int = 1,
    compress_grads: bool = False,
    loss_fn: Optional[Callable] = None,
    dist: Optional[Dist] = None,
    graphs: Optional[bool] = None,
):
    """The step function (module docstring); ``step.grads_of(params,
    batch)`` gives the (loss, gradients) it would apply, with no update,
    eagerly.  ``dist`` (default: no mesh) runs it over DTensors.

    ``graphs`` captures the step into CUDA graphs (module docstring).
    None resolves to True on a CUDA device, and under a mesh of CUDA
    devices, unless the model's MoE reads the host there
    (``moe.reads_host``: fp32, the loop route); True raises on the CPU, on
    a mesh of CPU devices and on such a route.  ``graphs`` is resolved for
    the device of each call's parameters, at the call (so True raises at
    the first call); ``step.graphs`` holds the value last resolved (None
    before the first call), ``step.steps`` the steps built, one for each
    device and input signature."""
    opt_cfg = opt_cfg or optim.for_model(cfg)
    meshed = dist is not None and dist.mesh is not None
    if loss_fn is None and meshed:
        def loss_fn(p, b):
            rows = next(iter(b.values())).shape[0]
            return zoo.loss_fn(cfg, p, b, microbatch_dist(dist, rows))
    elif loss_fn is None:
        def loss_fn(p, b):
            return zoo.loss_fn(cfg, p, b)
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
        grads = optim.tree_map(lambda _: next(it), alias)
        if meshed:
            grads = optim.tree_map(lambda p, g: g.redistribute(
                p.device_mesh, p.placements), params, grads)
        return loss.detach(), grads

    def zeros(p):
        if meshed:
            return torch.zeros_like(p, dtype=acc_dtype)
        return torch.zeros(p.shape, dtype=acc_dtype, device=p.device)

    def grads_of(params, batch):
        if microbatches <= 1:
            return value_and_grad(params, batch)
        if meshed:
            mb = {k: _split_placed(x, microbatches, dist)
                  for k, x in batch.items()}
        else:
            mb = {k: x.reshape((microbatches, x.shape[0] // microbatches)
                               + tuple(x.shape[1:]))
                  for k, x in batch.items()}
        acc = optim.tree_map(zeros, params)
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

    def eager_step(params, opt_state, ef, batch):
        loss, grads = grads_of(params, batch)
        if compress_grads:
            out = optim.tree_map(_quantize_int8, grads, ef)
            grads = optim.tree_map(lambda o: o[0], out)
            ef = optim.tree_map(lambda o: o[1], out)
        params, opt_state, gn = optim.apply_updates(opt_cfg, params, grads,
                                                    opt_state)
        metrics = {"loss": loss, "grad_norm": gn, "step": opt_state.step}
        return params, opt_state, ef, metrics

    def resolve(dev: torch.device) -> bool:
        captured = resolve_graphs(graphs, dev, "make_train_step",
                                  dist.mesh if meshed else None)
        if captured and moe.reads_host(cfg, dev):
            if graphs:
                raise ValueError(f"{cfg.name}: make_train_step(graphs=True)"
                                 f": its MoE reads the host on {dev}")
            return False
        return captured

    def graphs_on(dev: torch.device) -> bool:
        if dev not in resolved:
            resolved[dev] = resolve(dev)
        step.graphs = resolved[dev]
        return step.graphs

    def step(params, opt_state, ef, batch):
        """``ef`` is the error-feedback tree when compressing, else None."""
        dev = local_device(optim.leaves(params)[0])
        if not graphs_on(dev):
            return eager_step(params, opt_state, ef, batch)
        state = _state_leaves(params, opt_state, ef)
        inputs = {**state, **{f"batch/{k}": x for k, x in batch.items()}}
        key = (dev,) + tuple((k, spec(x)) for k, x in inputs.items())
        if key not in steps and pool[0] is None:
            pool[0] = torch.cuda.graph_pool_handle()

        def body(**bufs):
            p, o, e = _state_from_leaves((params, opt_state, ef), bufs)
            return eager_step(p, o, e, {k: bufs[f"batch/{k}"]
                                        for k in batch})

        return cached_step(steps, key, f"train {cfg.name}", body, pool[0],
                           dev, own=state, **inputs)

    steps, pool, resolved = {}, [None], {}
    step.graphs = None
    step.steps = steps
    step.grads_of = grads_of
    return step


def _state_leaves(params, opt_state, ef) -> dict:
    """The train state's tensors by name: parameters, moments, step and
    error feedback (when given)."""
    trees = {"p": params, "m": opt_state.m, "v": opt_state.v}
    if ef is not None:
        trees["ef"] = ef
    out = {f"{t}/{name}": x for t, tree in trees.items()
           for name, x in optim.named_leaves(tree)}
    out["step"] = opt_state.step
    return out


def _state_from_leaves(like, leaves: dict):
    """(params, opt_state, ef) shaped as ``like`` over the tensors of
    :func:`_state_leaves`' names in ``leaves``."""
    params, opt_state, ef = like

    def tree(t, like_tree):
        names = iter(name for name, _ in optim.named_leaves(like_tree))
        return optim.tree_map(lambda _: leaves[f"{t}/{next(names)}"],
                              like_tree)

    return (tree("p", params),
            optim.OptState(leaves["step"], tree("m", opt_state.m),
                           tree("v", opt_state.v)),
            None if ef is None else tree("ef", ef))


def _place(x, spec, dist: Dist):
    """``x`` laid out by ``spec`` over ``dist.mesh``: a DTensor is
    redistributed, a whole tensor (the same on every process) split."""
    from torch.distributed.tensor import distribute_tensor
    pls = placements(spec, dist.mesh)
    if hasattr(x, "placements"):
        return x if list(x.placements) == pls else x.redistribute(
            dist.mesh, pls)
    return distribute_tensor(x, dist.mesh, pls, src_data_rank=None)


def _place_tree(tree, specs, dist: Dist):
    if tree is None:
        return None
    return optim.tree_map(lambda x, s: _place(x, s, dist), tree, specs)


def jit_train_step(cfg: LMConfig, dist: Dist, param_spec_tree,
                   opt_cfg: Optional[optim.OptConfig] = None,
                   microbatches: int = 1, compress_grads: bool = False,
                   batch_specs=None, loss_fn: Optional[Callable] = None,
                   graphs: Optional[bool] = None):
    """The reference's fully specified train step over ``dist.mesh``:
    ``(params, opt_state, ef, batch) -> (params', opt_state', ef',
    metrics)`` with params, the optimizer's moments and the error feedback
    laid out by ``param_spec_tree`` (``optim.opt_state_specs``), the batch
    by ``batch_specs``, and ``loss``, ``grad_norm`` and ``step``
    replicated.  Inputs given whole or laid out otherwise are laid out
    first, eagerly; DTensors already laid out are passed on as they are,
    so the state a call returns, passed back, is the step's own buffers.
    It is :func:`make_train_step` under ``dist`` with ``graphs`` (the
    compiled step on a mesh of CUDA devices); ``run.step`` is that
    step."""
    opt_cfg = opt_cfg or optim.for_model(cfg)
    step = make_train_step(cfg, opt_cfg, microbatches, compress_grads,
                           loss_fn=loss_fn, dist=dist, graphs=graphs)
    o_specs = optim.opt_state_specs(opt_cfg, param_spec_tree)

    def run(params, opt_state, ef, batch):
        params = _place_tree(params, param_spec_tree, dist)
        opt_state = optim.OptState(
            opt_state.step, _place_tree(opt_state.m, o_specs.m, dist),
            opt_state.v if opt_cfg.name != "adamw"
            else _place_tree(opt_state.v, o_specs.v, dist))
        ef = _place_tree(ef, param_spec_tree, dist)
        if batch_specs is not None:
            batch = {k: _place(x, batch_specs[k], dist)
                     for k, x in batch.items()}
        return step(params, opt_state, ef, batch)

    run.step = step
    return run
