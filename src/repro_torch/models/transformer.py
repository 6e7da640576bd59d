"""Decoder-only transformer LM, dense GQA family (llama/qwen/yi/phi3).

The torch counterpart of the dense path of ``repro.models.transformer`` on
one device:

  forward      — teacher-forced logits (evaluation)
  prefill      — forward + KV-cache construction (inference prefill)
  decode_step  — one token against a padded KV cache (inference decode)

Parameters are a plain dict with the reference's keys and stacked layout
(``params["layers"][name]`` has a leading ``n_layers`` axis); the layer loop
is a Python loop over that axis in place of ``lax.scan``.  Weights are kept
in ``cfg.param_dtype`` and cast to ``cfg.dtype`` where used, as the
reference does; :func:`cast_params` makes those casts once (same values),
which is what the serving engine runs on.  Attention goes through
``common.attention_any``: the flash-attention kernel (K2) on the card.

The MoE and VLM members of the reference's family dispatch raise
``NotImplementedError``: they come with their own slices.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models.common import (LMConfig, apply_rope, attention_any,
                                       check_family, dense_init, rms_norm,
                                       rope_tables)


def vocab_padded(cfg: LMConfig, mult: int = 256) -> int:
    return ((cfg.vocab + mult - 1) // mult) * mult


# ---------------------------------------------------------------- parameters
def _attn_shapes(cfg: LMConfig):
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d),
    }


def _layer_shapes(cfg: LMConfig):
    d = cfg.d_model
    shapes = {"ln1": (d,), "ln2": (d,), **_attn_shapes(cfg)}
    if cfg.qkv_bias:
        shapes.update({"bq": (cfg.n_heads * cfg.hd,),
                       "bk": (cfg.n_kv_heads * cfg.hd,),
                       "bv": (cfg.n_kv_heads * cfg.hd,)})
    shapes.update({"w13": (d, 2 * cfg.d_ff), "w2": (cfg.d_ff, d)})
    return shapes


def _stack_init(gen: torch.Generator, shapes: Dict[str, tuple], n: int,
                dtype, dev) -> Dict[str, torch.Tensor]:
    """The reference's ``_stack_init``: norms ones, biases zeros, matrices
    Normal(0, 1/sqrt(fan_in)) with fan_in = shape[-2]."""
    out = {}
    for name, shp in shapes.items():
        if name.startswith("ln"):
            out[name] = torch.ones((n,) + shp, dtype=dtype, device=dev)
        elif name.startswith("b"):
            out[name] = torch.zeros((n,) + shp, dtype=dtype, device=dev)
        else:
            std = (shp[-2] if len(shp) > 1 else shp[-1]) ** -0.5
            flat = torch.randn((n,) + shp, generator=gen, device=gen.device)
            out[name] = (flat * std).to(device=dev, dtype=dtype)
    return out


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
    params = {
        "embed": dense_init(gen, (vp, cfg.d_model), pdt, scale=0.02).to(dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=pdt, device=dev),
        "layers": _stack_init(gen, _layer_shapes(cfg), cfg.n_layers, pdt, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (cfg.d_model, vp), pdt,
                                       scale=0.02).to(dev)
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


def cast_params(cfg: LMConfig, params: Dict) -> Dict:
    """Every weight cast once to ``cfg.dtype``.  The values are those of the
    reference's per-use ``.astype(cfg.dtype)``, so results are unchanged;
    the model functions' own casts are then no-ops."""
    if isinstance(params, dict):
        return {k: cast_params(cfg, v) for k, v in params.items()}
    return params.to(cfg.dtype)


def _layer(params: Dict, i: int) -> Dict[str, torch.Tensor]:
    return {name: t[i] for name, t in params["layers"].items()}


# ------------------------------------------------------------------- blocks
def _attn(cfg: LMConfig, p, x, cos, sin, cache=None, cache_at=None,
          kv_len=None):
    """Attention block.  Returns (residual_out, (k, v)).

    With ``cache = (ck, cv)`` ((B, S, Hkv, hd) views of the stacked cache),
    the new keys and values are written into it IN PLACE at per-row offsets
    ``cache_at`` (B,), an ``index_put_``; the reference's update was
    functional (``.at[rows, cols].set``).  Attention then runs over the whole
    cache, masked to ``kv_len``."""
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
        rows = torch.arange(B, device=x.device)[:, None]
        cols = cache_at.long()[:, None] + torch.arange(L, device=x.device)
        ck[rows, cols] = k.to(ck.dtype)
        cv[rows, cols] = v.to(cv.dtype)
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


def _one_layer(cfg: LMConfig, p, x, cos, sin, cache=None, cache_at=None,
               kv_len=None):
    x, kv = _attn(cfg, p, x, cos, sin, cache, cache_at, kv_len)
    return _ffn_dense(cfg, p, x), kv


# ------------------------------------------------------------------ forward
def _embed(cfg: LMConfig, params, tokens):
    """Gather the rows, then cast: the same values as casting the whole
    table first, without a copy of the (vocab, d) table per call."""
    return params["embed"][tokens.long()].to(cfg.dtype)


def _unembed(cfg: LMConfig, params, x):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ w.to(cfg.dtype)


def _rope(cfg: LMConfig, positions):
    return rope_tables(positions, cfg.hd, cfg.rope_theta, cfg.dtype)


def forward(cfg: LMConfig, params, batch: Dict):
    """batch: {'tokens': (B, L) int}.  Returns (logits (B, L, vocab_padded),
    aux_loss = 0.0)."""
    check_family(cfg.name, cfg.family)
    x = _embed(cfg, params, batch["tokens"])
    L = x.shape[1]
    cos, sin = _rope(cfg, torch.arange(L, device=x.device)[None, :])
    for i in range(cfg.n_layers):
        x, _ = _one_layer(cfg, _layer(params, i), x, cos, sin)
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x), 0.0


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
    rows) and decode masks KV beyond ``len``."""
    check_family(cfg.name, cfg.family)
    tokens = batch["tokens"]
    lengths = batch.get("lengths")
    x = _embed(cfg, params, tokens)
    B, L, _ = x.shape
    max_len = max(max_len, L)
    dev = x.device
    cos, sin = _rope(cfg, torch.arange(L, device=dev)[None, :])
    shp = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.hd)
    k = torch.zeros(shp, dtype=x.dtype, device=dev)
    v = torch.zeros(shp, dtype=x.dtype, device=dev)
    for i in range(cfg.n_layers):
        x, (k_l, v_l) = _one_layer(cfg, _layer(params, i), x, cos, sin)
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
    for i in range(cfg.n_layers):
        x, _ = _one_layer(cfg, _layer(params, i), x, cos, sin,
                          cache=(cache["k"][i], cache["v"][i]), cache_at=cur,
                          kv_len=kv_len)
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    logits = _unembed(cfg, params, x)
    return logits, {"k": cache["k"], "v": cache["v"], "len": cur + 1}
