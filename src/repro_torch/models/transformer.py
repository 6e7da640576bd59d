"""Decoder-only transformer LM: dense GQA (llama/qwen/yi/phi3),
fine-grained MoE (deepseek/kimi) and the VLM backbone (internvl2).

The torch counterpart of ``repro.models.transformer`` on one device:

  forward      — teacher-forced logits and the MoE aux loss (evaluation and
                 training)
  loss_fn      — next-token cross entropy over ``forward`` (training)
  prefill      — forward + KV-cache construction (inference prefill)
  decode_step  — one token against a padded KV cache (inference decode)

Parameters are a plain dict with the reference's keys and stacked layout
(``params["layers"][name]`` has a leading layer axis; an MoE model keeps its
first ``first_dense_layers`` dense layers in their own stack,
``params["dense_layers"]``, and its KV cache layers ``0 ..
first_dense_layers - 1`` are theirs); the layer loop is a Python loop over
those axes in place of ``lax.scan``.  Weights are kept in
``cfg.param_dtype`` and cast to ``cfg.dtype`` where used, as the reference
does; :func:`cast_params` makes those casts once (same values), which is
what the serving engine runs on.  Attention goes through
``common.attention_any``: the flash-attention kernel (K2) on the card, with
its hand-written backward when training.  An MoE layer's FFN is
``moe.moe_ffn`` (top-k routing, dropless, over grouped GEMMs) plus the
shared experts as one dense SwiGLU; it computes what the reference's
mesh-free path computes.  With ``cfg.remat`` set and grad on, ``forward``
checkpoints each layer (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` per scanned layer), so a layer's forward, K2 included,
runs again in the backward.

The VLM family is the dense model with a stub vision frontend:
``batch["patches"]`` (B, P, frontend_dim), projected by ``patch_proj``,
goes in front of the token embeddings in ``forward`` and ``prefill``;
``loss_fn`` scores the text positions only and ``decode_step`` is the dense
one.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (LMConfig, apply_rope, attention_any,
                                       check_family, dense_init, rms_norm,
                                       rope_tables, sharded_ce_loss)


def vocab_padded(cfg: LMConfig, mult: int = 256) -> int:
    return ((cfg.vocab + mult - 1) // mult) * mult


# ---------------------------------------------------------------- parameters
def _attn_shapes(cfg: LMConfig):
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d),
    }


def _layer_shapes(cfg: LMConfig, moe: bool):
    d = cfg.d_model
    shapes = {"ln1": (d,), "ln2": (d,), **_attn_shapes(cfg)}
    if cfg.qkv_bias:
        shapes.update({"bq": (cfg.n_heads * cfg.hd,),
                       "bk": (cfg.n_kv_heads * cfg.hd,),
                       "bv": (cfg.n_kv_heads * cfg.hd,)})
    if moe:
        f = cfg.expert_d_ff
        shapes.update({
            "router": (d, cfg.n_experts),
            "moe_w13": (cfg.n_experts, d, 2 * f),
            "moe_w2": (cfg.n_experts, f, d),
        })
        if cfg.n_shared_experts:
            fs = cfg.n_shared_experts * f
            shapes.update({"shared_w13": (d, 2 * fs), "shared_w2": (fs, d)})
    else:
        shapes.update({"w13": (d, 2 * cfg.d_ff), "w2": (cfg.d_ff, d)})
    return shapes


def _stack_init(gen: torch.Generator, shapes: Dict[str, tuple], n: int,
                dtype, dev) -> Dict[str, torch.Tensor]:
    """The reference's ``_stack_init``: norms ones, biases zeros, matrices
    Normal(0, 1/sqrt(fan_in)) with fan_in = shape[-2].  Each layer's slice
    of a matrix is drawn in fp32, scaled in place and cast into the
    ``(n, ...)`` tensor of ``dtype``, so a full-width stack never exists in
    fp32 and a bf16 init is the fp32 init rounded once."""
    out = {}
    for name, shp in shapes.items():
        if name.startswith("ln"):
            out[name] = torch.ones((n,) + shp, dtype=dtype, device=dev)
        elif name.startswith("b"):
            out[name] = torch.zeros((n,) + shp, dtype=dtype, device=dev)
        else:
            std = (shp[-2] if len(shp) > 1 else shp[-1]) ** -0.5
            out[name] = torch.empty((n,) + shp, dtype=dtype, device=dev)
            for i in range(n):
                out[name][i] = torch.randn(shp, generator=gen,
                                           device=gen.device).mul_(std)
    return out


def _n_dense(cfg: LMConfig) -> int:
    """Layers in ``params["dense_layers"]``: an MoE model's first
    ``first_dense_layers``; 0 for the dense family, whose layers are all in
    ``params["layers"]``."""
    return cfg.first_dense_layers if cfg.n_experts else 0


def init_params(cfg: LMConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = "cuda") -> Dict:
    """Random parameters with the reference's keys, stacked layout and
    per-shape scales.  The numbers are drawn on ``generator``'s device (a
    CPU generator with seed 0 when omitted; pass a CUDA generator for a
    full-width model) and differ from ``jax.random``'s; carry the
    reference's own weights across with :func:`params_from_jax`."""
    check_family(cfg.name, cfg.family)
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    vp, pdt = vocab_padded(cfg), cfg.param_dtype
    n_dense = _n_dense(cfg)
    params = {
        "embed": dense_init(gen, (vp, cfg.d_model), pdt, scale=0.02).to(dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=pdt, device=dev),
        "layers": _stack_init(gen, _layer_shapes(cfg, bool(cfg.n_experts)),
                              cfg.n_layers - n_dense, pdt, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (cfg.d_model, vp), pdt,
                                       scale=0.02).to(dev)
    if n_dense:
        params["dense_layers"] = _stack_init(
            gen, _layer_shapes(cfg, moe=False), n_dense, pdt, dev)
    if cfg.family == "vlm":
        params["patch_proj"] = dense_init(
            gen, (cfg.frontend_dim, cfg.d_model), pdt).to(dev)
    return params


def params_from_jax(params_np, device: DeviceLike = "cuda") -> Dict:
    """The reference's parameter dict (e.g. ``jax.tree.map(np.asarray,
    params)``) as torch tensors, so both packages compute with the same
    weights."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x)).to(dev)
    return conv(params_np)


# Weights the reference reads ``.astype(float32)`` at use, whatever
# ``cfg.dtype`` is: the MoE router (``moe.router_topk``), Mamba2's decay,
# skip and step-bias vectors (``ssm.mamba_forward``) and the sLSTM's
# recurrent matrix (``xlstm.slstm_forward``).  Rounding them to a bf16
# ``cfg.dtype`` would change what the model computes, so :func:`cast_params`
# leaves them in ``param_dtype``.
FP32_AT_USE = frozenset({"router", "A_log", "D", "dt_bias", "r"})


def cast_params(cfg: LMConfig, params: Dict) -> Dict:
    """The weights cast once to ``cfg.dtype`` where the reference casts them
    to ``cfg.dtype`` at use, so results are unchanged and the model
    functions' own casts are no-ops.  The leaves named in
    :data:`FP32_AT_USE` are returned as they are (the same tensor), as is a
    weight already in ``cfg.dtype``: neither is copied."""
    if isinstance(params, dict):
        return {k: v if k in FP32_AT_USE else cast_params(cfg, v)
                for k, v in params.items()}
    return params.to(cfg.dtype)


def unstack(stack: Dict[str, torch.Tensor]):
    """A stack's per-layer weight dicts, in order.  The stacked tensors are
    unbound once, so under grad a stack's gradient is one stack of the
    per-layer gradients."""
    split = {name: t.unbind(0) for name, t in stack.items()}
    n = next(iter(stack.values())).shape[0]
    return [{name: t[i] for name, t in split.items()} for i in range(n)]


def _layers(cfg: LMConfig, params: Dict):
    """Each layer's weights with its kind, in order: ``(p, moe)`` for the
    dense stack's layers, then the main stack's."""
    stacks = [(params["layers"], bool(cfg.n_experts))]
    if _n_dense(cfg):
        stacks.insert(0, (params["dense_layers"], False))
    return [(p, moe) for stack, moe in stacks for p in unstack(stack)]


def write_cache_rows(ck, cv, cache_at, k, v) -> None:
    """Write the new keys and values k, v (B, L, Hkv, hd) IN PLACE into the
    caches ck, cv (B, S, Hkv, hd) at per-row offsets ``cache_at`` (B,).

    A column at or past S is dropped, as the reference's functional
    ``.at[rows, cols].set`` drops it: an idle serving slot's ``len`` counts
    up every tick and passes the cache, and its write must neither fault
    nor land anywhere.  The drop stays on the device (no host read, so a
    decode step can be captured in a CUDA graph): the column is clamped to
    S - 1 and the value already there is written back.  Callers write one
    token a row (decode, L = 1), so a clamped column is its own row's and
    meets no other write of the same ``index_put_``."""
    B, L = k.shape[:2]
    S = ck.shape[1]
    rows = torch.arange(B, device=k.device)[:, None]
    cols = cache_at.long()[:, None] + torch.arange(L, device=k.device)
    keep = (cols < S)[:, :, None, None]
    cols = cols.clamp(max=S - 1)
    for cache, new in ((ck, k), (cv, v)):
        cache[rows, cols] = torch.where(keep, new.to(cache.dtype),
                                        cache[rows, cols])


# ------------------------------------------------------------------- blocks
def _attn(cfg: LMConfig, p, x, cos, sin, cache=None, cache_at=None,
          kv_len=None):
    """Attention block.  Returns (residual_out, (k, v)).

    With ``cache = (ck, cv)`` ((B, S, Hkv, hd) views of the stacked cache),
    the new keys and values are written into it IN PLACE at per-row offsets
    ``cache_at`` (B,) (:func:`write_cache_rows`; the reference's update was
    functional, ``.at[rows, cols].set``).  Attention then runs over the
    whole cache, masked to ``kv_len``."""
    B, L, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = h @ p["wq"].to(h.dtype)
    k = h @ p["wk"].to(h.dtype)
    v = h @ p["wv"].to(h.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(h.dtype)
        k = k + p["bk"].to(h.dtype)
        v = v + p["bv"].to(h.dtype)
    q = q.reshape(B, L, H, hd)
    k = k.reshape(B, L, Hkv, hd)
    v = v.reshape(B, L, Hkv, hd)
    q = apply_rope(q, cos[:, :, None, :], sin[:, :, None, :])
    k = apply_rope(k, cos[:, :, None, :], sin[:, :, None, :])

    if cache is not None:
        ck, cv = cache
        write_cache_rows(ck, cv, cache_at, k, v)
        # The reference's decode attends with its direct path at any cache
        # length: chunk = S keeps the CPU side off the chunked path.
        out = attention_any(q, ck.to(q.dtype), cv.to(q.dtype), causal=False,
                            chunk=ck.shape[1], kv_len=kv_len)
        knew, vnew = ck, cv
    else:
        out = attention_any(q, k, v, causal=True, chunk=cfg.attn_chunk)
        knew, vnew = k, v
    out = out.reshape(B, L, H * hd)
    return x + out @ p["wo"].to(out.dtype), (knew, vnew)


def _ffn_dense(cfg: LMConfig, p, x):
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    g, u = (h @ p["w13"].to(h.dtype)).chunk(2, dim=-1)
    act = (F.silu(g.float()) * u.float()).to(h.dtype)
    return x + act @ p["w2"].to(h.dtype)


def _ffn_moe(cfg: LMConfig, p, x):
    """Routed experts (``moe.moe_ffn``) plus the shared experts as one dense
    SwiGLU over ``n_shared_experts * expert_d_ff``.  Returns (x', aux)."""
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    out, aux = moe_lib.moe_ffn(
        cfg, {"router": p["router"], "w13": p["moe_w13"], "w2": p["moe_w2"]},
        h)
    if cfg.n_shared_experts:
        g, u = (h @ p["shared_w13"].to(h.dtype)).chunk(2, dim=-1)
        act = (F.silu(g.float()) * u.float()).to(h.dtype)
        out = out + act @ p["shared_w2"].to(h.dtype)
    return x + out, aux


def _one_layer(cfg: LMConfig, p, x, cos, sin, moe: bool, cache=None,
               cache_at=None, kv_len=None):
    """Returns (x', (k, v), aux); aux is 0.0 for a dense layer."""
    x, kv = _attn(cfg, p, x, cos, sin, cache, cache_at, kv_len)
    if moe:
        x, aux = _ffn_moe(cfg, p, x)
        return x, kv, aux
    return _ffn_dense(cfg, p, x), kv, 0.0


# ------------------------------------------------------------------ forward
def _embed(cfg: LMConfig, params, tokens):
    """Gather the rows, then cast: the same values as casting the whole
    table first, without a copy of the (vocab, d) table per call."""
    return params["embed"][tokens.long()].to(cfg.dtype)


def _unembed(cfg: LMConfig, params, x):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ w.to(cfg.dtype)


def _with_patches(cfg: LMConfig, params, batch: Dict, x):
    """The VLM family: ``batch["patches"] @ patch_proj`` in front of the
    token embeddings ``x``; other families and text-only batches pass."""
    if cfg.family == "vlm" and "patches" in batch:
        pe = batch["patches"].to(cfg.dtype) @ params["patch_proj"].to(
            cfg.dtype)
        x = torch.cat([pe, x], dim=1)
    return x


def _rope(cfg: LMConfig, positions):
    return rope_tables(positions, cfg.hd, cfg.rope_theta, cfg.dtype)


def _layer_out(cfg: LMConfig, p, x, cos, sin, moe: bool):
    x, _, aux = _one_layer(cfg, p, x, cos, sin, moe)
    return x, aux


def forward(cfg: LMConfig, params, batch: Dict):
    """batch: {'tokens': (B, L) int, optional 'patches' (B, P,
    frontend_dim) for the VLM family}.  Returns (logits (B, P + L,
    vocab_padded), aux_loss): aux is the MoE layers' router losses summed
    (0.0 for the other families).  With ``cfg.remat`` and grad on, each
    layer is checkpointed."""
    check_family(cfg.name, cfg.family)
    x = _with_patches(cfg, params, batch, _embed(cfg, params, batch["tokens"]))
    L = x.shape[1]
    cos, sin = _rope(cfg, torch.arange(L, device=x.device)[None, :])
    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    for p, moe in _layers(cfg, params):
        if remat:
            x, a = checkpoint(_layer_out, cfg, p, x, cos, sin, moe,
                              use_reentrant=False)
        else:
            x, a = _layer_out(cfg, p, x, cos, sin, moe)
        aux = aux + a
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x), aux


def loss_fn(cfg: LMConfig, params, batch: Dict, aux_weight: float = 0.01):
    """Next-token cross entropy of ``forward``: batch {'tokens', 'labels'}
    (B, L), labels -100 = ignore.  Returns a 0-d fp32 tensor."""
    logits, aux = forward(cfg, params, batch)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:    # VLM: drop the patch positions
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    return sharded_ce_loss(logits, labels.long(), aux, aux_weight)


# ------------------------------------------------------------------ serving
def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: DeviceLike = "cuda"):
    dev = resolve_device(device)
    shp = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shp, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shp, dtype=cfg.dtype, device=dev),
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill(cfg: LMConfig, params, batch: Dict, max_len: int):
    """Run the prompt, build the KV cache.  Returns (logits_last, cache).

    Optional ``batch["lengths"]`` (B,) marks the true prompt length of each
    row when prompts are right-padded to a shared bucket: logits are
    gathered at position length-1 and ``cache["len"]`` is set per row.
    Trailing pad is harmless: attention is causal (pad rows never feed real
    rows) and decode masks KV beyond ``len``.  A VLM batch's ``patches``
    go in front of the tokens and their positions extend the cache."""
    check_family(cfg.name, cfg.family)
    tokens = batch["tokens"]
    lengths = batch.get("lengths")
    x = _with_patches(cfg, params, batch, _embed(cfg, params, tokens))
    B, L, _ = x.shape
    max_len = max(max_len, L)          # VLM: the patch positions
    dev = x.device
    cos, sin = _rope(cfg, torch.arange(L, device=dev)[None, :])
    shp = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.hd)
    k = torch.zeros(shp, dtype=x.dtype, device=dev)
    v = torch.zeros(shp, dtype=x.dtype, device=dev)
    for i, (p, moe) in enumerate(_layers(cfg, params)):
        x, (k_l, v_l), _ = _one_layer(cfg, p, x, cos, sin, moe)
        k[i, :, :L] = k_l
        v[i, :, :L] = v_l
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
        idx = torch.clamp(lengths.long() - 1, 0, L - 1)
        x_last = x[torch.arange(B, device=dev), idx][:, None]
        cache_len = lengths
    else:
        x_last = x[:, -1:]
        cache_len = torch.full((B,), L, dtype=torch.int32, device=dev)
    logits = _unembed(cfg, params, x_last)
    return logits, {"k": k, "v": v, "len": cache_len}


def decode_step(cfg: LMConfig, params, tokens, cache):
    """One token per sequence: tokens (B, 1) -> (logits (B, 1, V), cache').

    ``cache["k"]``/``cache["v"]`` are updated in place (the new token's
    keys and values at each row's ``len``); the returned cache holds the
    same tensors and ``len + 1``."""
    check_family(cfg.name, cfg.family)
    x = _embed(cfg, params, tokens)
    cur = cache["len"]
    cos, sin = _rope(cfg, cur[:, None])
    kv_len = cur + 1
    for i, (p, moe) in enumerate(_layers(cfg, params)):
        x, _, _ = _one_layer(cfg, p, x, cos, sin, moe,
                             cache=(cache["k"][i], cache["v"][i]),
                             cache_at=cur, kv_len=kv_len)
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    logits = _unembed(cfg, params, x)
    return logits, {"k": cache["k"], "v": cache["v"], "len": cur + 1}
