"""The rank side of ``tests/test_torch_mesh_ranks.py`` (no tests of its
own): what every gloo rank runs on a (data, model) mesh, JAX-free so that
the spawned processes import only torch and the port.  Rank 0 returns the
whole results as numpy; the other ranks return None."""
import dataclasses

import numpy as np
import torch

from repro_torch import models as zoo
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.mesh import full_tree, make_debug_mesh, shard_tree
from repro_torch.launch.sharding import cache_specs
from repro_torch.models import moe
from repro_torch.models.common import Dist, P, ShapeCfg, placements
from repro_torch.models.transformer import params_from_jax
from repro_torch.train import optim, step as step_lib

MESH_ARCHS = ("llama3.2-1b", "qwen2.5-32b", "internvl2-2b",
              "deepseek-moe-16b", "kimi-k2-1t-a32b")
# Each family trained on one mesh shape, MoE on both (AdamW, then Lion).
TRAIN_ARCHS = {(2, 2): ("llama3.2-1b", "deepseek-moe-16b"),
               (1, 4): ("internvl2-2b", "kimi-k2-1t-a32b")}
DENSE_ARCHS = ("llama3.2-1b", "qwen2.5-32b", "yi-9b", "phi3-mini-3.8b")
B, L, MAX_LEN = 4, 16, 24
MICROBATCHES, STEPS = 2, 3
MOE_B, MOE_L = 2, 512              # 512 or 1024 tokens a data shard
MOE_FACTORS = (2.0, 0.5)           # 0.5: about half the assignments drop
BATCH_SPECS = {"tokens": P("data", None), "labels": P("data", None),
               "patches": P("data", None, None)}


def microbatches(arch: str) -> int:
    """The train step's microbatches: the dense config splits its batch
    (the split's re-stated layout), the others take it whole (the
    reference's step compiles a scan per microbatch count)."""
    return MICROBATCHES if arch == "llama3.2-1b" else 1


def config(arch: str, capacity_factor=None):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return cfg


def batch_np(cfg, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    batch = {"tokens": tokens,
             "labels": np.roll(tokens, -1, axis=1).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return batch


def moe_x_np(cfg) -> np.ndarray:
    return np.random.default_rng(7).standard_normal(
        (MOE_B, MOE_L, cfg.d_model)).astype(np.float32)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _arch_cases(cfg, params_np, dist: Dist):
    mesh = dist.mesh
    specs = zoo.param_specs(cfg, dist)
    whole = params_from_jax(params_np, device="cpu")
    params = shard_tree(whole, specs, mesh)
    batch = _tensors(batch_np(cfg))
    placed = {k: shard_tree(v, BATCH_SPECS[k], mesh)
              for k, v in batch.items()}
    out = {}
    with torch.no_grad():
        logits, _ = zoo.forward(cfg, params, placed, dist)
        out["logits"] = logits.full_tensor()
        serve = {k: v for k, v in placed.items() if k != "labels"}
        last, cache = zoo.prefill(cfg, params, serve, MAX_LEN, dist)
        out["prefill_logits"] = last.full_tensor()
        out["cache_k"] = cache["k"].full_tensor()
        out["cache_v"] = cache["v"].full_tensor()
        out["cache_len"] = cache["len"].full_tensor()
        spec = cache_specs(cfg, ShapeCfg("prefill", MAX_LEN, B, "prefill"),
                           dist)["k"]
        out["cache_spec"] = repr(spec)
        out["cache_placed"] = (list(cache["k"].placements)
                               == placements(spec, mesh))
    opt_cfg = optim.for_model(cfg)
    loss, grads = step_lib.make_train_step(cfg, opt_cfg, dist=dist).grads_of(
        params, placed)
    out["loss"] = loss.full_tensor()
    out["grads"] = full_tree(grads)
    return {k: (_np(v) if not isinstance(v, (str, bool)) else v)
            for k, v in out.items()}


def _train_losses(arch, cfg, params_np, dist: Dist):
    specs = zoo.param_specs(cfg, dist)
    opt_cfg = optim.for_model(cfg)
    step = step_lib.jit_train_step(cfg, dist, specs, opt_cfg,
                                   microbatches=microbatches(arch),
                                   batch_specs=BATCH_SPECS)
    params = params_from_jax(params_np, device="cpu")
    opt = optim.init_opt_state(opt_cfg, shard_tree(params, specs, dist.mesh))
    batch = _tensors(batch_np(cfg))
    losses = []
    for _ in range(STEPS):
        params, opt, _, metrics = step(params, opt, None, batch)
        losses.append(float(metrics["loss"].full_tensor()))
    return losses


def _moe_params(cfg, params_np, dist: Dist):
    """The first MoE layer's router and experts, whole and laid out by
    ``param_specs``."""
    lay = params_np["layers"]
    spec = zoo.param_specs(cfg, dist)["layers"]
    p, sp = {}, {}
    for name, key in (("router", "router"), ("w13", "moe_w13"),
                      ("w2", "moe_w2")):
        p[name] = torch.from_numpy(np.array(lay[key][0]))
        sp[name] = shard_tree(p[name], P(*spec[key][1:]), dist.mesh)
    return p, sp


def _moe_cases(cfg, params_np, dist: Dist):
    out = {}
    _, sp = _moe_params(cfg, params_np, dist)
    x = shard_tree(torch.from_numpy(moe_x_np(cfg)), P("data", None, None),
                   dist.mesh)
    for cf in MOE_FACTORS:
        c = dataclasses.replace(cfg, capacity_factor=cf)
        with torch.no_grad():
            y, _, dropped = moe.moe_ffn(c, sp, x, dist.mesh, dist.batch_axes,
                                        return_dropped=True)
        out[cf] = {"out": _np(y.full_tensor()),
                   "dropped": _np(dropped.full_tensor())}
    return out


def mesh_rank(rank, shape, params_by_arch):
    """Every case of one mesh shape (data, model) on rank ``rank``."""
    torch.manual_seed(0)
    mesh = make_debug_mesh(*shape, device_type="cpu")
    dist = Dist(mesh, batch_axes=("data",))
    res = {"arch": {}, "train": {}}
    for arch in MESH_ARCHS:
        res["arch"][arch] = _arch_cases(config(arch), params_by_arch[arch],
                                        dist)
    for arch in TRAIN_ARCHS[tuple(shape)]:
        res["train"][arch] = _train_losses(arch, config(arch),
                                           params_by_arch[arch], dist)
    res["moe"] = _moe_cases(config("deepseek-moe-16b"),
                            params_by_arch["deepseek-moe-16b"], dist)
    return res if rank == 0 else None


# ------------------------------------------------------------- the 1x1 mesh
def _mesh_free_and_meshed(cfg, params_np, dist):
    """forward, prefill and one train step, mesh-free and on ``dist``."""
    batch = _tensors(batch_np(cfg))
    whole = params_from_jax(params_np, device="cpu")
    specs = zoo.param_specs(cfg, dist)
    placed_p = shard_tree(whole, specs, dist.mesh)
    placed_b = {k: shard_tree(v, BATCH_SPECS[k], dist.mesh)
                for k, v in batch.items()}
    serve, serve_p = ({k: v for k, v in b.items() if k != "labels"}
                      for b in (batch, placed_b))
    out = {}
    with torch.no_grad():
        ref = zoo.forward(cfg, whole, batch)[0]
        got = zoo.forward(cfg, placed_p, placed_b, dist)[0].to_local()
        out["forward"] = (ref.numpy(), got.numpy())
        rl, rc = zoo.prefill(cfg, whole, serve, MAX_LEN)
        gl, gc = zoo.prefill(cfg, placed_p, serve_p, MAX_LEN, dist)
        out["prefill"] = (np.concatenate([rl.numpy().ravel(),
                                          rc["k"].numpy().ravel(),
                                          rc["v"].numpy().ravel()]),
                          np.concatenate([gl.to_local().numpy().ravel(),
                                          gc["k"].to_local().numpy().ravel(),
                                          gc["v"].to_local().numpy().ravel()]))
    opt_cfg = optim.for_model(cfg)
    rp = optim.tree_map(lambda t: t.clone(), whole)
    ro = optim.init_opt_state(opt_cfg, rp)
    rp, ro, _, rm = step_lib.make_train_step(cfg, opt_cfg)(rp, ro, None,
                                                            batch)
    step = step_lib.jit_train_step(cfg, dist, specs, opt_cfg,
                                   batch_specs=BATCH_SPECS)
    gp, go, _, gm = step(whole, optim.init_opt_state(opt_cfg, placed_p),
                         None, batch)
    flat = lambda tree: np.concatenate(  # noqa: E731
        [t.detach().numpy().ravel() for t in optim.leaves(tree)])
    out["train"] = (np.concatenate([[float(rm["loss"])], flat(rp),
                                    flat(ro.m)]),
                    np.concatenate([[float(gm["loss"].to_local())],
                                    flat(full_tree(gp)),
                                    flat(full_tree(go.m))]))
    return out


def single_rank(rank, params_by_arch):
    """The dense smoke configs and the capacity MoE on a 1x1 mesh: each
    case's mesh-free and meshed results."""
    torch.set_num_threads(1)      # the embedding's gradient sums in order
    mesh = make_debug_mesh(1, 1, device_type="cpu")
    dist = Dist(mesh, batch_axes=("data",))
    res = {arch: _mesh_free_and_meshed(config(arch), params_by_arch[arch],
                                       dist) for arch in DENSE_ARCHS}
    cfg = config("deepseek-moe-16b")
    p, sp = _moe_params(cfg, params_by_arch["deepseek-moe-16b"], dist)
    x = torch.from_numpy(moe_x_np(cfg))[:, :64]
    with torch.no_grad():
        ref = moe.moe_ffn(cfg, p, x)[0]
        got, _, dropped = moe.moe_ffn(
            cfg, sp, shard_tree(x, P("data", None, None), mesh), mesh,
            ("data",), return_dropped=True)
    res["moe"] = (ref.numpy(), got.to_local().numpy(),
                  int(dropped.to_local().sum()))
    return res


# ------------------------------------------- chip_smoke's mesh phases, on CPU
def _counting_attention():
    """K2's plain versions behind wrappers that count as the card's kernels
    do, and ``attention_any`` sending CPU tensors through
    ``flash_attention`` as the card's path does."""
    from repro_torch.kernels import flash_attention as FA
    plain_forward = FA._forward

    def forward(q, k, v, kv_len, causal, scale):
        path = FA.kernel_path(q.dtype, q.shape[1], k.shape[1], q.shape[2],
                              q.shape[3],
                              all(FA.aligned16(t) for t in (q, k, v)))
        FA.flash_attention.launches += 1
        FA.flash_attention.launches_by_path[path] += 1
        return plain_forward(q, k, v, kv_len, causal, scale)

    def backward(q, k, v, out, dout, *rest):
        path = FA.backward_path(q.dtype, q.shape[1], k.shape[1], q.shape[2],
                                q.shape[3], all(FA.aligned16(t) for t in (
                                    q, k, v, out, dout)))
        for key in FA.flash_attention.backward_launches:
            FA.flash_attention.backward_launches[key] += 1
        FA.flash_attention.backward_launches_by_path[path] += 1
        return FA.flash_attention_bwd_plain(q, k, v, out, dout, *rest)

    def attention_any(q, k, v, *, causal, chunk, kv_len=None):
        return FA.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), kv_len,
                                  causal=causal).transpose(1, 2)
    return forward, backward, attention_any


def chip_mesh_rank(rank):
    """``chip_smoke.py``'s mesh_parity, mesh_train and mesh_moe phases on
    this rank's 1x1 gloo mesh at the smoke widths (llama with head dim 64,
    so bf16 attention names prefill_tc), K2's plain versions counting as
    the kernels, the CUDA clock and timers stubbed.  Returns the phases'
    printed records."""
    import contextlib
    import importlib.util
    import io
    import json
    from pathlib import Path

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import common as TC
    from repro_torch.models import transformer as TT

    torch.set_num_threads(1)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_cpu", Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    small = {"llama3.2-1b": dataclasses.replace(
        get_smoke_config("llama3.2-1b"), head_dim=64),
        "deepseek-moe-16b": get_smoke_config("deepseek-moe-16b")}
    forward, backward, attention_any = _counting_attention()
    cs.get_config = small.__getitem__
    FA._forward = forward
    FA.flash_attention_bwd = backward
    TC.attention_any = TT.attention_any = attention_any
    torch.cuda.synchronize = lambda *a: None
    cs.time_ms = lambda fn, reps=25, warmup=3: (fn(), 0.0)[1]
    cs.device_ms = lambda fn, reps=25, warmup=3, tries=3, label="", \
        parts=None: (fn(), 0.0)[1]
    mesh = make_debug_mesh(1, 1, device_type="cpu")
    dev = torch.device("cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launched = {"mesh_parity": cs.phase_mesh_parity(dev, mesh),
                    "mesh_train": cs.phase_mesh_train(dev, mesh)}
        cs.phase_mesh_moe(dev, mesh)
    return {"records": [json.loads(line) for line in
                        out.getvalue().splitlines() if line.startswith("{")],
            "launched": launched}
