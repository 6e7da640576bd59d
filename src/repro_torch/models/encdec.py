"""Encoder-decoder backbone (seamless-m4t-medium).

The torch counterpart of ``repro.models.encdec`` on one device.  The audio
frontend is a stub: ``batch["frames"]`` (B, F, frontend_dim) are
precomputed frame embeddings, projected by ``frontend_proj`` and run
through a bidirectional encoder; the decoder stacks causal self-attention,
cross-attention over the encoder's output (no RoPE) and a SwiGLU FFN.
Decode keeps a growing self-attention KV cache (``k``/``v``, written in
place at each row's ``len``) and a static cross-attention KV (``xk``/
``xv``, computed once at prefill from the encoder's output).

  encode       — frames -> encoder memory (B, F, d)
  forward      — teacher-forced logits of the decoder
  loss_fn      — next-token cross entropy over ``forward``
  prefill      — encode + the decoder prompt, building both caches
  decode_step  — one token against both caches

Parameters are a plain dict with the reference's keys and stacked layout
(``params["encoder"]``, ``params["decoder"]``: a leading layer axis; the
decoder's cross-attention weights are ``x_wq`` .. ``x_wo`` beside
``ln_x``).  The layer loops are Python loops over those axes in place of
``lax.scan``; with ``cfg.remat`` and grad on, each layer is checkpointed
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).  Every
attention goes through ``common.attention_any``, which on the card is the
flash-attention kernel (K2): the encoder's (``causal=False``, Lq = Lk = F),
the decoder's causal self-attention and its cross-attention
(``causal=False``, Lq = prompt, Lk = F) at prefill, and at decode the
self-attention over the cache masked to ``len + 1`` and the
cross-attention over all F keys.

Under a mesh (``dist``) every entry point runs: the projections TP over
``model`` with the reference's constraints (``_mha_mesh``, ``_ffn``
through ``transformer._swiglu``, the frames' projection held whole), the
attention per shard over its heads, the cross-attention's ``xk``/``xv``
split by heads and the self-attention cache laid out by ``cache_specs``
(decode through ``transformer._attn_decode_mesh``).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models.common import (NO_DIST, Dist, LMConfig, P,
                                       checkpointed,
                                       apply_rope, attention_any,
                                       check_family, dense_init, local_device,
                                       rms_norm, sharded_ce_loss)
from repro_torch.models.transformer import (_attn_decode_mesh, _attn_shapes,
                                            _cache_layer, _embed, _from_local,
                                            _rope, _stack_init, _stack_layers,
                                            _swiglu, _unembed, unstack,
                                            vocab_padded, write_cache_rows)


# ---------------------------------------------------------------- parameters
def _enc_layer_shapes(cfg: LMConfig):
    d = cfg.d_model
    return {"ln1": (d,), "ln2": (d,), **_attn_shapes(cfg),
            "w13": (d, 2 * cfg.d_ff), "w2": (cfg.d_ff, d)}


def _dec_layer_shapes(cfg: LMConfig):
    shapes = _enc_layer_shapes(cfg)
    shapes["ln_x"] = (cfg.d_model,)
    shapes.update({f"x_{k}": v for k, v in _attn_shapes(cfg).items()})
    return shapes


def init_params(cfg: LMConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = "cuda") -> Dict:
    """Random parameters with the reference's keys, stacked layout and
    per-shape scales (norms ones, matrices Normal(0, 1/sqrt(fan_in)), the
    embeddings 0.02), drawn on ``generator``'s device (a CPU generator with
    seed 0 when omitted).  The numbers differ from ``jax.random``'s; carry
    the reference's own weights across with
    ``transformer.params_from_jax``."""
    check_family(cfg.name, cfg.family)
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    vp, pdt, d = vocab_padded(cfg), cfg.param_dtype, cfg.d_model
    return {
        "embed": dense_init(gen, (vp, d), pdt, scale=0.02).to(dev),
        "unembed": dense_init(gen, (d, vp), pdt, scale=0.02).to(dev),
        "frontend_proj": dense_init(gen, (cfg.frontend_dim, d), pdt).to(dev),
        "enc_norm": torch.ones((d,), dtype=pdt, device=dev),
        "final_norm": torch.ones((d,), dtype=pdt, device=dev),
        "encoder": _stack_init(gen, _enc_layer_shapes(cfg), cfg.n_enc_layers,
                               pdt, dev),
        "decoder": _stack_init(gen, _dec_layer_shapes(cfg), cfg.n_layers,
                               pdt, dev),
    }


# ------------------------------------------------------------------- blocks
def param_specs(cfg: LMConfig, dist: Dist) -> Dict:
    """Each parameter's spec, the reference's leaf for leaf."""
    m, da = dist.model_axis, dist.data_axis
    att = {"wq": P(None, da, m), "wk": P(None, da, m), "wv": P(None, da, m),
           "wo": P(None, m, da)}
    enc = {"ln1": P(None, None), "ln2": P(None, None), **att,
           "w13": P(None, da, m), "w2": P(None, m, da)}
    dec = dict(enc)
    dec.update({"ln_x": P(None, None)})
    dec.update({f"x_{k}": v for k, v in att.items()})
    return {
        "embed": P(None, m), "unembed": P(da, m),
        "frontend_proj": P(None, m),
        "enc_norm": P(None), "final_norm": P(None),
        "encoder": enc, "decoder": dec,
    }


def _mha(cfg: LMConfig, p, prefix: str, x, kv_src, cos, sin, causal: bool,
         cache=None, cache_at=None, kv_len=None, rope: bool = True,
         dist: Dist = NO_DIST):
    """Attention with the weights ``prefix + "wq"`` ..; queries from ``x``,
    keys and values from ``kv_src`` (None: decode's cross-attention, whose
    keys and values are all in ``cache``).  With RoPE, queries and keys
    share ``cos``/``sin`` (self-attention only).  With ``cache = (ck, cv)``
    and ``kv_src`` given, the new keys and values are written into the
    cache in place at ``cache_at`` (``transformer.write_cache_rows``); the
    attention then runs over the whole cache, masked to ``kv_len``.
    Returns (out @ wo, (k, v)): the cache tensors, or the new keys and
    values.  Under ``dist.mesh`` (no cache): :func:`_mha_mesh`."""
    if dist.mesh is not None:
        return _mha_mesh(cfg, p, prefix, x, kv_src, cos, sin, causal, rope,
                         dist)
    B, L, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def w(name):
        return p[prefix + name].to(x.dtype)
    q = (x @ w("wq")).reshape(B, L, H, hd)
    k = v = None
    if kv_src is not None:
        Lk = kv_src.shape[1]
        k = (kv_src @ w("wk")).reshape(B, Lk, Hkv, hd)
        v = (kv_src @ w("wv")).reshape(B, Lk, Hkv, hd)
    if rope:
        q = apply_rope(q, cos[:, :, None, :], sin[:, :, None, :])
        if k is not None:
            k = apply_rope(k, cos[:, :, None, :], sin[:, :, None, :])
    if cache is not None:
        ck, cv = cache
        if k is not None:                      # self-attention: append
            write_cache_rows(ck, cv, cache_at, k, v)
        # The reference's decode attends with its direct path at any cache
        # length: chunk = S keeps the CPU side off the chunked path.
        out = attention_any(q, ck.to(q.dtype), cv.to(q.dtype), causal=False,
                            chunk=ck.shape[1], kv_len=kv_len)
        kv = (ck, cv)
    else:
        out = attention_any(q, k, v, causal=causal, chunk=cfg.attn_chunk)
        kv = (k, v)
    return out.reshape(B, L, H * hd) @ w("wo"), kv


def _mha_local(cfg: LMConfig, cos, sin, causal: bool, rope: bool, q, k, v):
    """One shard's attention over its heads: q (B, L, Hl*hd), k/v (B, Lk,
    Hk*hd) -> (out (B, L, Hl*hd), k, v (B, Lk, Hk, hd), roped)."""
    B, L, _ = q.shape
    hd = cfg.hd
    q = q.reshape(B, L, -1, hd)
    k = k.reshape(B, k.shape[1], -1, hd)
    v = v.reshape(B, v.shape[1], -1, hd)
    if rope:
        q = apply_rope(q, cos[:, :, None, :], sin[:, :, None, :])
        k = apply_rope(k, cos[:, :, None, :], sin[:, :, None, :])
    out = attention_any(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    return out.reshape(B, L, -1), k, v


def _heads_axis(cfg: LMConfig, dist: Dist):
    """``model`` when it divides the q and the KV heads (each shard attends
    its heads), else None (each shard attends every head)."""
    m = dist.model_axis
    msize = dist.size(m)
    return m if cfg.n_heads % msize == 0 and cfg.n_kv_heads % msize == 0 \
        else None


def _mha_mesh(cfg: LMConfig, p, prefix: str, x, kv_src, cos, sin,
              causal: bool, rope: bool, dist: Dist):
    """:func:`_mha` under a mesh with no cache: the projections TP over
    ``model``, attention (K2 on the card) per shard over its heads in
    ``local_map``, the reference's constraint on the output
    (``encdec.py:127``) before ``wo`` and the partial sums reduced.
    Returns (out, (k, v)) with k, v (B, Lk, Hkv, hd) split by heads."""
    m, b = dist.model_axis, dist.batch
    ax = _heads_axis(cfg, dist)

    def proj(t, name):
        return dist.wsc(t @ dist.gathered(p[prefix + name]).to(x.dtype),
                        b, None, ax)
    q, k, v = proj(x, "wq"), proj(kv_src, "wk"), proj(kv_src, "wv")
    pl = dist.placements(b, None, ax)
    kv_pl = dist.placements(b, None, ax, None)
    out, k, v = dist.local_map(
        functools.partial(_mha_local, cfg, cos, sin, causal, rope),
        out=(pl, kv_pl, kv_pl), ins=(pl, pl, pl))(q, k, v)
    out = dist.wsc(out, b, None, m)
    y = out @ dist.gathered(p[prefix + "wo"]).to(x.dtype)
    return dist.wsc(y, b, None, None), (k, v)


def _xattn_local(layer: int, q, xk, xv):
    """One shard's decode cross-attention over layer ``layer`` of its
    cross-attention cache (B, F, Hk, hd): every key, no mask."""
    B = q.shape[0]
    xk, xv = xk[layer], xv[layer]
    q = q.reshape(B, 1, -1, xk.shape[-1])
    out = attention_any(q, xk.to(q.dtype), xv.to(q.dtype), causal=False,
                        chunk=xk.shape[1])
    return out.reshape(B, 1, -1)


def _xattn_decode_mesh(cfg: LMConfig, p, h, xk, xv, layer: int,
                       dist: Dist):
    """The decode cross-attention under a mesh, over the stacked ``xk``/
    ``xv`` caches laid out by ``cache_specs`` (split by heads over
    ``model`` where it divides them)."""
    from repro_torch.models.transformer import cache_layout
    m, b = dist.model_axis, dist.batch
    _, ax = cache_layout(xk, dist)
    q = dist.wsc(h @ dist.gathered(p["x_wq"]).to(h.dtype), b, None, ax)
    pl = dist.placements(b, None, ax)
    c_pl = list(xk.placements)
    out = dist.local_map(functools.partial(_xattn_local, layer), out=pl,
                         ins=(pl, c_pl, c_pl))(q, xk, xv)
    out = dist.wsc(out, b, None, m)
    y = out @ dist.gathered(p["x_wo"]).to(h.dtype)
    return dist.wsc(y, b, None, None)


def _ffn(cfg: LMConfig, p, x, dist: Dist = NO_DIST):
    if dist.mesh is not None:
        return _swiglu(cfg, x, p["w13"], p["w2"], dist)
    g, u = (x @ p["w13"].to(x.dtype)).chunk(2, dim=-1)
    act = (F.silu(g.float()) * u.float()).to(x.dtype)
    return act @ p["w2"].to(x.dtype)


def _enc_layer(cfg: LMConfig, p, x, cos, sin, dist: Dist = NO_DIST):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, _ = _mha(cfg, p, "", h, h, cos, sin, causal=False, dist=dist)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(cfg, p, h, dist)


def encode(cfg: LMConfig, params, frames, dist: Dist = NO_DIST):
    """frames (B, F, frontend_dim) -> encoder memory (B, F, d).  Under
    ``dist.mesh`` the projection is held whole on ``model`` after it, as
    the reference constrains it (``encdec.py:143``)."""
    x = frames.to(cfg.dtype) @ dist.gathered(
        params["frontend_proj"]).to(cfg.dtype)
    x = dist.wsc(x, dist.batch, None, None)
    cos, sin = _rope(cfg, torch.arange(x.shape[1],
                                       device=local_device(x))[None])
    remat = cfg.remat and torch.is_grad_enabled()
    for p in unstack(params["encoder"]):
        if remat:
            x = checkpointed(_enc_layer, cfg, p, x, cos, sin, dist)
        else:
            x = _enc_layer(cfg, p, x, cos, sin, dist)
    return rms_norm(x, params["enc_norm"].to(cfg.dtype), cfg.norm_eps)


def _dec_layer(cfg: LMConfig, p, x, memory, cos, sin, cache=None,
               cache_at=None, kv_len=None, dist: Dist = NO_DIST):
    """One decoder layer.  Without ``cache``: causal self-attention, then
    cross-attention over ``memory``; returns (x', (k, v), (xk, xv)).  With
    ``cache = (ck, cv, xk, xv)`` (decode): the self-attention appends to
    ``ck``/``cv`` and the cross-attention reads ``xk``/``xv``; returns x'
    and the cache tensors.  Under ``dist.mesh`` a decode's ``cache`` is
    (the four stacked caches, the layer) and ``cache_at`` the positions
    placed by the batch: the self-attention is
    ``transformer._attn_decode_mesh`` (the cache split by sequence where
    ``cache_specs`` splits it), the cross-attention
    :func:`_xattn_decode_mesh`; returns x'."""
    if dist.mesh is not None and cache is not None:
        ck, cv, xk, xv, layer = cache
        x = _attn_decode_mesh(cfg, p, x, ck, cv, layer, cache_at, dist)
        h = rms_norm(x, p["ln_x"], cfg.norm_eps)
        x = x + _xattn_decode_mesh(cfg, p, h, xk, xv, layer, dist)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + _ffn(cfg, p, h, dist)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cache is not None:
        ck, cv, xk, xv = cache
        a, kv = _mha(cfg, p, "", h, h, cos, sin, causal=False,
                     cache=(ck, cv), cache_at=cache_at, kv_len=kv_len)
    else:
        a, kv = _mha(cfg, p, "", h, h, cos, sin, causal=True, dist=dist)
    x = x + a
    h = rms_norm(x, p["ln_x"], cfg.norm_eps)
    if cache is not None:
        a, xkv = _mha(cfg, p, "x_", h, None, None, None, causal=False,
                      cache=(xk, xv), rope=False)
    else:
        a, xkv = _mha(cfg, p, "x_", h, memory, None, None, causal=False,
                      rope=False, dist=dist)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(cfg, p, h, dist), kv, xkv


def _dec_out(cfg: LMConfig, p, x, memory, cos, sin, dist: Dist = NO_DIST):
    return _dec_layer(cfg, p, x, memory, cos, sin, dist=dist)[0]


def _decoder_stack(cfg: LMConfig, params, x, memory, cos, sin, keep_kv: bool,
                   dist: Dist = NO_DIST):
    """The decoder layers over the prompt ``x`` (no cache).  Returns x and,
    with ``keep_kv``, each layer's ((k, v), (xk, xv)).  Without it, under
    ``cfg.remat`` and grad, each layer is checkpointed."""
    remat = not keep_kv and cfg.remat and torch.is_grad_enabled()
    kvs = []
    for p in unstack(params["decoder"]):
        if remat:
            x = checkpointed(_dec_out, cfg, p, x, memory, cos, sin, dist)
        else:
            x, kv, xkv = _dec_layer(cfg, p, x, memory, cos, sin, dist=dist)
            if keep_kv:
                kvs.append((kv, xkv))
    return x, kvs


# ------------------------------------------------------------------ forward
def forward(cfg: LMConfig, params, batch: Dict, dist: Dist = NO_DIST):
    """batch: {'frames': (B, F, frontend_dim), 'tokens': (B, L) int} ->
    (logits (B, L, vocab_padded), 0.0).  Under ``dist.mesh`` params and
    batch are DTensors laid out by :func:`param_specs` and
    ``launch.sharding``."""
    check_family(cfg.name, cfg.family)
    memory = encode(cfg, params, batch["frames"], dist)
    x = _embed(cfg, params, batch["tokens"], dist)
    cos, sin = _rope(cfg, torch.arange(x.shape[1],
                                       device=local_device(x))[None])
    x, _ = _decoder_stack(cfg, params, x, memory, cos, sin, keep_kv=False,
                          dist=dist)
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x, dist), 0.0


def loss_fn(cfg: LMConfig, params, batch: Dict, dist: Dist = NO_DIST):
    """Next-token cross entropy of ``forward``: batch {'frames', 'tokens',
    'labels'}, labels -100 = ignore.  Returns a 0-d fp32 tensor."""
    logits, _ = forward(cfg, params, batch, dist)
    return sharded_ce_loss(logits, batch["labels"].long())


# ------------------------------------------------------------------ serving
def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: DeviceLike = "cuda"):
    """The self-attention cache grows to ``max_len``; the cross-attention
    KV is sized by the (stub) frontend length.  ``xlen`` is kept for the
    reference's key set; nothing reads it."""
    dev = resolve_device(device)
    Fm = cfg.frontend_len
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    xkv = (cfg.n_layers, batch, Fm, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(kv, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(kv, dtype=cfg.dtype, device=dev),
        "xk": torch.zeros(xkv, dtype=cfg.dtype, device=dev),
        "xv": torch.zeros(xkv, dtype=cfg.dtype, device=dev),
        "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "xlen": torch.full((batch,), Fm, dtype=torch.int32, device=dev),
    }


def prefill(cfg: LMConfig, params, batch: Dict, max_len: int,
            dist: Dist = NO_DIST):
    """Encode the frames and run the decoder prompt; build the self- and
    cross-attention caches.  Returns (logits of the last position, cache).
    As in the reference, every row's prompt has the batch's length L (no
    ``lengths``): ``len`` is L for every row.  Under ``dist.mesh``:
    :func:`_prefill_mesh`."""
    check_family(cfg.name, cfg.family)
    if dist.mesh is not None:
        return _prefill_mesh(cfg, params, batch, max_len, dist)
    memory = encode(cfg, params, batch["frames"])
    x = _embed(cfg, params, batch["tokens"])
    B, L, _ = x.shape
    Fm = memory.shape[1]
    dev = x.device
    cos, sin = _rope(cfg, torch.arange(L, device=dev)[None])
    x, kvs = _decoder_stack(cfg, params, x, memory, cos, sin, keep_kv=True)
    shp = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.hd)
    k = torch.zeros(shp, dtype=x.dtype, device=dev)
    v = torch.zeros(shp, dtype=x.dtype, device=dev)
    for i, ((k_l, v_l), _) in enumerate(kvs):
        k[i, :, :L] = k_l
        v[i, :, :L] = v_l
    xk = torch.stack([xkv[0] for _, xkv in kvs])
    xv = torch.stack([xkv[1] for _, xkv in kvs])
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    logits = _unembed(cfg, params, x[:, -1:])
    return logits, {
        "k": k, "v": v, "xk": xk, "xv": xv,
        "len": torch.full((B,), L, dtype=torch.int32, device=dev),
        "xlen": torch.full((B,), Fm, dtype=torch.int32, device=dev)}


def decode_step(cfg: LMConfig, params, tokens, cache, dist: Dist = NO_DIST):
    """One token per sequence: tokens (B, 1) -> (logits (B, 1, V), cache').

    ``cache["k"]``/``cache["v"]`` are updated in place (the new token's
    keys and values at each row's ``len``; a row at or past the cache's
    end writes nothing, as in the reference); the returned cache holds the
    same tensors and ``len + 1``.  Under ``dist.mesh`` the caches are laid
    out by ``launch.sharding.cache_specs`` and written shard by shard."""
    check_family(cfg.name, cfg.family)
    if dist.mesh is not None:
        x = _embed(cfg, params, tokens, dist)
        cur = dist.wsc(cache["len"], dist.batch)
        for i, p in enumerate(unstack(params["decoder"])):
            x = _dec_layer(cfg, p, x, None, None, None, cache=(
                cache["k"], cache["v"], cache["xk"], cache["xv"], i),
                cache_at=cur, dist=dist)
        x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
        return _unembed(cfg, params, x, dist), {**cache,
                                                "len": cache["len"] + 1}
    x = _embed(cfg, params, tokens)
    cur = cache["len"]
    cos, sin = _rope(cfg, cur[:, None])
    kv_len = cur + 1
    for i, p in enumerate(unstack(params["decoder"])):
        x, _, _ = _dec_layer(cfg, p, x, None, cos, sin, cache=(
            cache["k"][i], cache["v"][i], cache["xk"][i], cache["xv"][i]),
            cache_at=cur, kv_len=kv_len)
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x), {**cache, "len": cur + 1}


def _prefill_mesh(cfg: LMConfig, params, batch: Dict, max_len: int,
                  dist: Dist):
    """:func:`prefill` under a mesh: the caches laid out by
    ``launch.sharding.cache_specs`` for this batch and ``max_len``, ``len``
    and ``xlen`` replicated."""
    from torch.distributed.tensor import Replicate
    from repro_torch.launch.sharding import cache_specs
    from repro_torch.models.common import ShapeCfg
    memory = encode(cfg, params, batch["frames"], dist)
    x = _embed(cfg, params, batch["tokens"], dist)
    B, L, _ = x.shape
    Fm = memory.shape[1]
    dev = local_device(x)
    cos, sin = _rope(cfg, torch.arange(L, device=dev)[None])
    x, kvs = _decoder_stack(cfg, params, x, memory, cos, sin, keep_kv=True,
                            dist=dist)
    specs = cache_specs(cfg, ShapeCfg("prefill", max_len, B, "prefill"),
                        dist)
    cache = {
        "k": _stack_layers(dist, [_cache_layer(kv[0], max_len,
                                               specs["k"][1:], dist)
                                  for kv, _ in kvs], specs["k"]),
        "v": _stack_layers(dist, [_cache_layer(kv[1], max_len,
                                               specs["v"][1:], dist)
                                  for kv, _ in kvs], specs["v"]),
        "xk": _stack_layers(dist, [xkv[0] for _, xkv in kvs], specs["xk"]),
        "xv": _stack_layers(dist, [xkv[1] for _, xkv in kvs], specs["xv"])}
    rep = [Replicate()] * dist.mesh.ndim
    for key, n in (("len", L), ("xlen", Fm)):
        cache[key] = _from_local(dist, torch.full(
            (B,), n, dtype=torch.int32, device=dev), (B,), rep)
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x[:, -1:], dist), cache
