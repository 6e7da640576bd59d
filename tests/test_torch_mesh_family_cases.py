"""The rank side of ``tests/test_torch_mesh_families.py`` and
``tests/test_torch_mesh_decode.py`` (no tests of its own): what every gloo
rank runs on a (data, model) mesh, JAX-free so that the spawned processes
import only torch and the port.  Rank 0 returns the whole results as
numpy; the other ranks return None.  The reference scripts of both test
files import the constants and the input builders from here, so both
packages see the same configs, batches and decode tokens."""
import dataclasses

import numpy as np
import torch

from repro_torch import models as zoo
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.mesh import full_tree, make_debug_mesh, shard_tree
from repro_torch.launch.sharding import cache_specs
from repro_torch.models.common import Dist, P, ShapeCfg, placements
from repro_torch.models.transformer import params_from_jax
from repro_torch.train import optim, step as step_lib

FAMILY_ARCHS = ("zamba2-1.2b", "xlstm-1.3b", "seamless-m4t-medium")
# Each family trained on one mesh shape.
TRAIN_SHAPES = {"zamba2-1.2b": (2, 2), "xlstm-1.3b": (1, 4),
                "seamless-m4t-medium": (2, 2)}
# Smoke configs with other heads: qwen6's 6 q heads do not divide a 4-way
# model axis (the head-group split); llama_mqa's one KV head splits a
# B = 1 cache by sequence over both axes of (2, 2).
VARIANTS = {"qwen6": ("qwen2.5-32b", {"n_heads": 6, "n_kv_heads": 2}),
            "llama_mqa": ("llama3.2-1b", {"n_kv_heads": 1})}
B, L, MAX_LEN = 4, 136, 160        # L past one SSD chunk of 128
DECODE_STEPS, STEPS = 8, 3
DEC_B, DEC_L, DEC_MAX = 4, 20, 32  # the decode cases' prompts and cache
SERVE = dict(slots=4, max_len=48, requests=6, max_new=6)


def config(name: str, dtype=torch.float32):
    base, over = VARIANTS.get(name, (name, {}))
    return dataclasses.replace(get_smoke_config(base), dtype=dtype, **over)


def batch_np(cfg, rows: int = B, length: int = L, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (rows, length)).astype(np.int32)
    batch = {"tokens": tokens,
             "labels": np.roll(tokens, -1, axis=1).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (rows, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return batch


def decode_tokens_np(cfg, rows: int = B, seed: int = 2) -> np.ndarray:
    """The tokens fed to the decode steps, (DECODE_STEPS, rows, 1)."""
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (DECODE_STEPS, rows, 1)).astype(np.int32)


def serve_prompts(cfg) -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab, size=int(rng.integers(4, 12)))
            .astype(np.int32) for _ in range(SERVE["requests"])]


def batch_specs(batch_axes) -> dict:
    b = batch_axes[0] if len(batch_axes) == 1 else (batch_axes or None)
    return {"tokens": P(b, None), "labels": P(b, None),
            "frames": P(b, None, None)}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if hasattr(tree, "full_tensor"):
        tree = tree.full_tensor()
    return tree.detach().numpy().copy()


def _tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def serve_run(cfg, params, dist: Dist):
    """Each request's tokens through ``ServeEngine`` (under ``dist`` when it
    has a mesh)."""
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(cfg, params, slots=SERVE["slots"],
                      max_len=SERVE["max_len"], device="cpu", dist=dist)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=SERVE["max_new"],
                    eos_id=-1) for i, p in enumerate(serve_prompts(cfg))]
    for r in reqs:
        eng.submit(r)
    with torch.no_grad():
        eng.run()
    return [r.out_tokens for r in reqs]


def serve_cases(params_np, dist: Dist) -> dict:
    """The llama smoke config served through the engine on the mesh."""
    cfg = config("llama3.2-1b")
    return serve_run(cfg, params_from_jax(params_np, device="cpu"), dist)


def decode_cases(name: str, params_np, dist: Dist, rows: int = DEC_B):
    """Prefill ``rows`` prompts of DEC_L tokens into a DEC_MAX cache, then
    DECODE_STEPS decode steps on the given tokens: each step's logits, the
    final cache and its spec."""
    cfg = config(name)
    mesh = dist.mesh
    params = shard_tree(params_from_jax(params_np, device="cpu"),
                        zoo.param_specs(cfg, dist), mesh)
    b = dist.batch
    tokens = _tensors(batch_np(cfg, rows, DEC_L))["tokens"]
    out = {"logits": []}
    with torch.no_grad():
        _, cache = zoo.prefill(cfg, params, {
            "tokens": shard_tree(tokens, P(b, None), mesh)}, DEC_MAX, dist)
        for t in torch.from_numpy(decode_tokens_np(cfg, rows)):
            logits, cache = zoo.decode_step(
                cfg, params, shard_tree(t, P(b, None), mesh), cache, dist)
            out["logits"].append(_np(logits))
    spec = cache_specs(cfg, ShapeCfg("decode", DEC_MAX, rows, "decode"),
                       dist)["k"]
    out["cache"] = _np({k: cache[k] for k in ("k", "v", "len")})
    out["cache_spec"] = repr(spec)
    out["cache_placed"] = list(cache["k"].placements) == placements(spec,
                                                                    mesh)
    return out


def family_cases(name: str, params_np, dist: Dist, train: bool = True):
    """forward, prefill (logits and every cache key), DECODE_STEPS decode
    steps, the loss and every gradient, and STEPS ``jit_train_step``
    steps, for one config on ``dist``'s mesh."""
    cfg = config(name)
    mesh = dist.mesh
    specs = zoo.param_specs(cfg, dist)
    bspecs = batch_specs(dist.batch_axes)
    whole = params_from_jax(params_np, device="cpu")
    params = shard_tree(whole, specs, mesh)
    batch = _tensors(batch_np(cfg))
    placed = {k: shard_tree(v, bspecs[k], mesh) for k, v in batch.items()}
    serve = {k: v for k, v in placed.items() if k != "labels"}
    out = {"decode_logits": []}
    with torch.no_grad():
        out["logits"] = _np(zoo.forward(cfg, params, placed, dist)[0])
        last, cache = zoo.prefill(cfg, params, serve, MAX_LEN, dist)
        out["prefill_logits"] = _np(last)
        out["cache"] = _np(cache)
        cspec = cache_specs(cfg, ShapeCfg("prefill", MAX_LEN, B, "prefill"),
                            dist)
        out["cache_placed"] = all(
            list(cache[k].placements) == placements(cspec[k], mesh)
            for k in cache)
        for t in torch.from_numpy(decode_tokens_np(cfg)):
            logits, cache = zoo.decode_step(
                cfg, params, shard_tree(t, bspecs["tokens"], mesh), cache,
                dist)
            out["decode_logits"].append(_np(logits))
        out["decode_cache"] = _np(cache)
    opt_cfg = optim.for_model(cfg)
    loss, grads = step_lib.make_train_step(cfg, opt_cfg, dist=dist).grads_of(
        params, placed)
    out["loss"] = _np(loss)
    out["grads"] = _np(full_tree(grads))
    if train:
        step = step_lib.jit_train_step(cfg, dist, specs, opt_cfg,
                                       batch_specs=bspecs)
        p, opt = whole, optim.init_opt_state(opt_cfg, params)
        losses = []
        for _ in range(STEPS):
            p, opt, _, metrics = step(p, opt, None, batch)
            losses.append(float(metrics["loss"].full_tensor()))
        out["train"] = losses
    return out


def families_rank(rank, shape, params_by_arch):
    """The three families on one mesh shape (data, model)."""
    torch.manual_seed(0)
    mesh = make_debug_mesh(*shape, device_type="cpu")
    dist = Dist(mesh, batch_axes=("data",))
    res = {a: family_cases(a, params_by_arch[a], dist,
                           train=TRAIN_SHAPES[a] == tuple(shape))
           for a in FAMILY_ARCHS}
    return res if rank == 0 else None


def decode_rank(rank, shape, params_by_name):
    """The decode and serving cases of one mesh shape: llama over the
    cache as ``cache_specs`` lays it, qwen6's head-group split (forward,
    prefill, loss, gradients), the engine's tokens, and on (2, 2) the
    B = 1 long-context decode of llama_mqa split over both axes."""
    from tests.test_torch_mesh_cases import _arch_cases
    torch.manual_seed(0)
    mesh = make_debug_mesh(*shape, device_type="cpu")
    dist = Dist(mesh, batch_axes=("data",))
    res = {"llama": decode_cases("llama3.2-1b", params_by_name["llama3.2-1b"],
                                 dist),
           "qwen6": _arch_cases(config("qwen6"), params_by_name["qwen6"],
                                dist),
           "serve": serve_cases(params_by_name["llama3.2-1b"], dist)}
    if tuple(shape) == (2, 2):
        long = Dist(mesh, batch_axes=(), seq_shard=True)
        res["long"] = decode_cases("llama_mqa", params_by_name["llama_mqa"],
                                   long, rows=1)
    return res if rank == 0 else None


# ------------------------------------------------------------- the 1x1 mesh
def _bits(tree) -> np.ndarray:
    return np.concatenate([np.asarray(t, np.float64).ravel()
                           for _, t in sorted(_flat(tree))])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _flat(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree)
                for x in _flat(t, f"{prefix}{i}/")]
    return [(prefix, tree)]


def one_by_one_rank(rank, params_by_arch):
    """The three families on a 1x1 mesh against the mesh-free path: the
    forward, prefill, decode steps and a train step's loss and gradients
    (``family_cases`` both ways, no ``jit_train_step``)."""
    torch.set_num_threads(1)      # the embedding's gradient sums in order
    mesh = make_debug_mesh(1, 1, device_type="cpu")
    dist = Dist(mesh, batch_axes=("data",))
    res = {}
    for arch in FAMILY_ARCHS:
        got = family_cases(arch, params_by_arch[arch], dist, train=False)
        ref = _mesh_free(arch, params_by_arch[arch])
        res[arch] = {k: (_bits(ref[k]), _bits(got[k])) for k in ref}
    return res


def _mesh_free(name: str, params_np) -> dict:
    cfg = config(name)
    params = params_from_jax(params_np, device="cpu")
    batch = _tensors(batch_np(cfg))
    serve = {k: v for k, v in batch.items() if k != "labels"}
    out = {"decode_logits": []}
    with torch.no_grad():
        out["logits"] = _np(zoo.forward(cfg, params, batch)[0])
        last, cache = zoo.prefill(cfg, params, serve, MAX_LEN)
        out["prefill_logits"] = _np(last)
        out["cache"] = _np(cache)
        for t in torch.from_numpy(decode_tokens_np(cfg)):
            logits, cache = zoo.decode_step(cfg, params, t, cache)
            out["decode_logits"].append(_np(logits))
        out["decode_cache"] = _np(cache)
    loss, grads = step_lib.make_train_step(
        cfg, optim.for_model(cfg)).grads_of(params, batch)
    out["loss"], out["grads"] = _np(loss), _np(grads)
    return out


# ------------------------------------------- chip_smoke's new phases, on CPU
def chip_rehearsal_rank(rank):
    """``chip_smoke.py``'s kernels_decode_stats (at full width: the plain
    versions are cheap at one query row), mesh_serve and mesh_families on
    this rank's 1x1 gloo mesh at the smoke widths (llama with head dim 64,
    so bf16 attention names prefill_tc), K2's plain versions counting as
    the kernels, the CUDA clock and timers stubbed.  Returns the phases'
    printed records and their K2 launches."""
    import contextlib
    import importlib.util
    import io
    import json
    from pathlib import Path

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import common as TC
    from repro_torch.models import encdec as TE
    from repro_torch.models import transformer as TT
    from tests.test_torch_mesh_cases import _counting_attention

    torch.set_num_threads(1)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_cpu", Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    smoke = {a: get_smoke_config(a) for a in FAMILY_ARCHS}
    smoke["llama3.2-1b"] = dataclasses.replace(
        get_smoke_config("llama3.2-1b"), head_dim=64)
    # seamless's frames past the decode kernel's 16 rows (as the card's).
    smoke["seamless-m4t-medium"] = dataclasses.replace(
        smoke["seamless-m4t-medium"], head_dim=64, frontend_len=24)
    counting, backward, attention_any = _counting_attention()
    plain_stats = FA._decode_stats

    def forward(q, k, v, kv_len, causal, scale):
        """The decode kernel's mirror where the card takes the decode
        kernel (so one slice with stats is its bits), else the counting
        plain version."""
        path = FA.kernel_path(q.dtype, q.shape[1], k.shape[1], q.shape[2],
                              q.shape[3])
        if path != "decode":
            return counting(q, k, v, kv_len, causal, scale)
        FA.flash_attention.launches += 1
        FA.flash_attention.launches_by_path[path] += 1
        return FA.flash_decode_split_plain(
            q, k, v, kv_len, FA.decode_split(q.shape[-1], q.dtype), causal,
            scale)

    def stats(*a):
        FA.flash_attention.stats_launches += 1
        return plain_stats(*a)
    full = cs.get_config
    smoke_config = lambda a: smoke[a] if a in smoke else full(a)  # noqa: E731
    FA._forward = forward
    FA._decode_stats = stats
    FA.flash_attention_bwd = backward
    TC.attention_any = TT.attention_any = TE.attention_any = attention_any
    torch.cuda.synchronize = lambda *a: None
    cs.time_ms = lambda fn, reps=25, warmup=3: (fn(), 0.0)[1]
    cs.device_ms = lambda fn, reps=25, warmup=3, tries=3, label="", \
        parts=None: (fn(), 0.0)[1]
    cs._fresh_device = lambda: None
    mesh = make_debug_mesh(1, 1, device_type="cpu")
    dev = torch.device("cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cs.phase_flash_stats(dev)               # the kernel rows: full width
        cs.get_config = smoke_config
        launched = {"mesh_serve": cs.phase_mesh_serve(dev, mesh),
                    "mesh_families": cs.phase_mesh_families(dev, mesh)}
    return {"records": [json.loads(line) for line in
                        out.getvalue().splitlines() if line.startswith("{")],
            "launched": launched}
