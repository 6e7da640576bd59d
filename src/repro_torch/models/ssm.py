"""Mamba2 (SSD) blocks and the Zamba2-style hybrid stack on one device.

The torch counterpart of ``repro.models.ssm``.  A Mamba2 layer is in_proj ->
causal depthwise conv over (x, B, C) -> selective SSM with one decay per
head (the SSD form) -> gated out_proj.  A prompt runs the chunkwise SSD scan
(:func:`_ssd_chunked`: quadratic inside a chunk of ``SSD_CHUNK`` steps, a
recurrence over chunks); a decode step updates the recurrent state
``(B, H, N, P)`` and the conv tail, O(1) per token.

Zamba2: a stack of Mamba2 layers with ONE shared attention + MLP block
(weights reused) after every ``attn_every``-th layer, on concat(hidden,
embedding) (arXiv:2411.15242).  Its attention is ``transformer._attn``, so
on the card it runs the flash-attention kernel (K2); each invocation site
keeps its own KV cache.

Serving state (``init_cache``): ``ssm`` (n_layers, B, H, N, P) fp32 -- the
layout the scan returns and decodes (the reference labels the axes (H, P,
N), the same shape while P == N) -- ``conv`` (n_layers, B, K - 1, conv_ch),
``k``/``v`` (sites, B, max_len, Hkv, hd) and ``len``.  ``decode_step``
updates the tensors of the cache it is given in place and returns them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models.common import (Dist, LMConfig, P, dense_init,
                                       rms_norm, sharded_ce_loss)
from repro_torch.models.transformer import (_attn, _embed, _ffn_dense,
                                            _rope, _unembed, vocab_padded)

SSD_CHUNK = 128


# ------------------------------------------------------------- mamba2 (SSD)
def _mamba_dims(cfg: LMConfig):
    din = cfg.ssm_expand * cfg.d_model
    H = din // cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_ch = din + 2 * N
    return din, H, N, conv_ch


def mamba_layer_shapes(cfg: LMConfig):
    d = cfg.d_model
    din, H, N, conv_ch = _mamba_dims(cfg)
    return {
        "norm": (d,),
        "in_proj": (d, 2 * din + 2 * N + H),
        "conv_w": (cfg.ssm_conv, conv_ch),
        "conv_b": (conv_ch,),
        "A_log": (H,),
        "D": (H,),
        "dt_bias": (H,),
        "out_proj": (din, d),
    }


def _pad_steps(t, pad: int):
    """``t`` (B, L, ...) with ``pad`` zero steps appended on axis 1."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def _ssd_chunked(xbar, loga, Bm, Cm, state0=None, chunk: int = SSD_CHUNK):
    """Chunkwise SSD scan with one group: xbar (B, L, H, P) dt-scaled
    inputs, loga (B, L, H) per-step log decay, Bm/Cm (B, L, N) input and
    output projections shared by the heads.  Returns (y (B, L, H, P),
    final state (B, H, N, P)): :func:`_ssd_chunked_heads` with B and C
    broadcast over the heads."""
    H = xbar.shape[2]
    keys, queries = (t[:, :, None].expand(-1, -1, H, -1) for t in (Bm, Cm))
    return _ssd_chunked_heads(xbar, loga, keys, queries, state0, chunk)


def _ssd_chunked_heads(xbar, loga, keys, queries, state0=None,
                       chunk: int = SSD_CHUNK):
    """Chunkwise SSD scan with per-head B and C (keys/queries (B, L, H,
    N)): quadratic inside each chunk of ``chunk`` steps, a recurrence over
    the chunks.  xbar (B, L, H, P), loga (B, L, H).  Returns (y (B, L, H,
    P), final state (B, H, N, P)).  The prompt is padded to whole chunks;
    a pad step has log decay 0 and zero input, so it carries the state
    unchanged."""
    Bsz, L, H, Pd = xbar.shape
    N = keys.shape[-1]
    pad = (-L) % chunk
    if pad:
        xbar, keys, queries, loga = (_pad_steps(t, pad)
                                     for t in (xbar, keys, queries, loga))
    C_ = xbar.shape[1] // chunk
    xb = xbar.reshape(Bsz, C_, chunk, H, Pd)
    la = loga.reshape(Bsz, C_, chunk, H)
    Kc = keys.reshape(Bsz, C_, chunk, H, N)
    Qc = queries.reshape(Bsz, C_, chunk, H, N)

    cum = torch.cumsum(la, dim=2)                              # (B,C,Q,H)
    total = cum[:, :, -1]                                      # (B,C,H)
    # Intra-chunk: scores[t,s] = (q_t . k_s) exp(cum[t]-cum[s]) [s<=t]; the
    # mask goes in before exp, so a masked entry is exp(-inf) = 0.
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B,C,Q,S,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xbar.device))
    dec = torch.exp(seg.masked_fill(~tri[None, None, :, :, None],
                                    float("-inf")))
    qk = torch.einsum("bcqhn,bcshn->bcqsh", Qc, Kc)
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", qk * dec, xb)
    # Chunk-local states: S_c = sum_s exp(total - cum[s]) k_s (x) xbar[s]
    w = torch.exp(total[:, :, None, :] - cum)                  # (B,C,Q,H)
    S_loc = torch.einsum("bcshn,bcshp->bchnp", Kc * w[..., None], xb)

    # Inter-chunk recurrence, one chunk at a time.
    S = (torch.zeros((Bsz, H, N, Pd), dtype=xbar.dtype, device=xbar.device)
         if state0 is None else state0)
    prevs = []
    for c in range(C_):
        prevs.append(S)
        S = S * torch.exp(total[:, c])[:, :, None, None] + S_loc[:, c]
    S_prevs = torch.stack(prevs, dim=1)                        # (B,C,H,N,P)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           Qc * torch.exp(cum)[..., None], S_prevs)
    y = (y_intra + y_inter).reshape(Bsz, C_ * chunk, H, Pd)
    return y[:, :L], S


def mamba_forward(cfg: LMConfig, p, x, state=None, conv_tail=None):
    """One Mamba2 block.  x (B, L, d) -> (out, (ssm_state, conv_tail)).

    With ``state`` (B, H, N, P) and L == 1, the recurrent step; otherwise
    the chunked scan from ``state`` (zeros when None).  ``conv_tail`` (B,
    K - 1, conv_ch) is the last K - 1 conv inputs before ``x``."""
    Bsz, L, d = x.shape
    din, H, N, conv_ch = _mamba_dims(cfg)
    h = rms_norm(x, p["norm"].to(x.dtype), cfg.norm_eps)
    zxbcdt = h @ p["in_proj"].to(h.dtype)
    z, xin, Bm, Cm, dt = torch.split(zxbcdt, [din, din, N, N, H], dim=-1)

    conv_in = torch.cat([xin, Bm, Cm], dim=-1)                 # (B,L,conv_ch)
    K = cfg.ssm_conv
    if conv_tail is not None:
        ctx = torch.cat([conv_tail, conv_in], dim=1)
    else:
        ctx = F.pad(conv_in, (0, 0, K - 1, 0))
    new_tail = ctx[:, -(K - 1):]
    # Depthwise causal conv: K shifted products summed in the reference's
    # order (Python's sum, from 0), then the bias.
    conv_w = p["conv_w"].to(x.dtype)
    conv = ctx[:, 0:L] * conv_w[0][None, None]
    for k in range(1, K):
        conv = conv + ctx[:, k:k + L] * conv_w[k][None, None]
    conv = F.silu(conv + p["conv_b"].to(x.dtype))
    xin, Bm, Cm = torch.split(conv, [din, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"].float())         # (B,L,H)
    A = -torch.exp(p["A_log"].float())                         # (H,) < 0
    loga = dt * A[None, None]                                  # (B,L,H)
    xh = xin.reshape(Bsz, L, H, cfg.ssm_head_dim)
    xbar = xh * dt[..., None].to(xh.dtype)

    if state is not None and L == 1:
        # Recurrent step: S' = exp(loga) S + B (x) xbar; y = C . S'
        Sn = (state * torch.exp(loga)[:, 0, :, None, None]
              + torch.einsum("bn,bhp->bhnp", Bm[:, 0].float(),
                             xbar[:, 0].float()))
        y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), Sn)[:, None]
        S_final = Sn
    else:
        y, S_final = _ssd_chunked(xbar.float(), loga, Bm.float(), Cm.float(),
                                  state0=state)
    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(Bsz, L, din).to(x.dtype)
    y = y * F.silu(z)
    return x + y @ p["out_proj"].to(x.dtype), (S_final, new_tail)


# --------------------------------------------------------------- zamba2 stack
def init_params(cfg: LMConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = "cuda") -> Dict:
    """Random parameters with the reference's keys, shapes and scales:
    norms and ``D`` ones, ``conv_b`` and ``dt_bias`` zeros, ``A_log`` =
    log(linspace(1, 16, H)) in every layer, ``conv_w`` Normal(0, 0.1), the
    other matrices Normal(0, 1/sqrt(fan_in)).  Each layer's slice is drawn
    in fp32 on ``generator``'s device and cast into the stack, so a
    full-width stack never exists in fp32 twice.  The numbers differ from
    ``jax.random``'s; carry the reference's across with
    ``transformer.params_from_jax``."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    vp, pdt, n = vocab_padded(cfg), cfg.param_dtype, cfg.n_layers
    stack = {}
    for name, shp in mamba_layer_shapes(cfg).items():
        if name in ("norm", "D"):
            stack[name] = torch.ones((n,) + shp, dtype=pdt, device=dev)
        elif name in ("conv_b", "dt_bias"):
            stack[name] = torch.zeros((n,) + shp, dtype=pdt, device=dev)
        elif name == "A_log":
            a0 = torch.log(torch.linspace(1.0, 16.0, shp[0]))
            stack[name] = a0[None].repeat(n, 1).to(dev, pdt)
        else:
            std = 0.1 if name == "conv_w" else shp[0] ** -0.5
            stack[name] = torch.empty((n,) + shp, dtype=pdt, device=dev)
            for i in range(n):
                stack[name][i] = torch.randn(shp, generator=gen,
                                             device=gen.device).mul_(std)
    params = {
        "embed": dense_init(gen, (vp, cfg.d_model), pdt, scale=0.02).to(dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=pdt, device=dev),
        "mamba": stack,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (cfg.d_model, vp), pdt,
                                       scale=0.02).to(dev)
    if cfg.attn_every:
        d, hd = cfg.d_model, cfg.hd
        shapes = {"concat_proj": (2 * d, d),
                  "wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
                  "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d),
                  "w13": (d, 2 * cfg.d_ff), "w2": (cfg.d_ff, d)}
        shared = {name: dense_init(gen, shp, pdt).to(dev)
                  for name, shp in shapes.items()}
        shared["ln1"] = torch.ones((d,), dtype=pdt, device=dev)
        shared["ln2"] = torch.ones((d,), dtype=pdt, device=dev)
        params["shared"] = shared
    return params


def param_specs(cfg: LMConfig, dist: Dist) -> Dict:
    """Each parameter's spec, the reference's leaf for leaf."""
    m, da = dist.model_axis, dist.data_axis
    stack = {
        "norm": P(None, None),
        "in_proj": P(None, da, m),
        "conv_w": P(None, None, m),
        "conv_b": P(None, m),
        "A_log": P(None, None), "D": P(None, None), "dt_bias": P(None, None),
        "out_proj": P(None, m, da),
    }
    specs = {"embed": P(None, m), "final_norm": P(None), "mamba": stack}
    if not cfg.tie_embeddings:
        specs["unembed"] = P(da, m)
    if cfg.attn_every:
        specs["shared"] = {
            "concat_proj": P(da, m),
            "ln1": P(None), "ln2": P(None),
            "wq": P(da, m), "wk": P(da, m), "wv": P(da, m), "wo": P(m, da),
            "w13": P(da, m), "w2": P(m, da),
        }
    return specs


def _shared_block(cfg: LMConfig, sp, x, x0, cos, sin, cache=None,
                  cache_at=None, kv_len=None):
    """Zamba2's shared attention + MLP on concat(hidden, embedding).  With
    ``cache`` the site's KV cache is written in place (``transformer._attn``)."""
    h = torch.cat([x, x0], dim=-1) @ sp["concat_proj"].to(x.dtype)
    h, kv = _attn(cfg, sp, h, cos, sin, cache, cache_at, kv_len)
    h = _ffn_dense(cfg, sp, h)
    return x + h, kv


def num_shared_calls(cfg: LMConfig) -> int:
    if not cfg.attn_every:
        return 0
    return sum(1 for i in range(cfg.n_layers)
               if (i + 1) % cfg.attn_every == 0)


def _layers(params, n: int):
    """Each Mamba layer's weights, the stack unbound once."""
    split = {name: t.unbind(0) for name, t in params["mamba"].items()}
    return [{name: t[i] for name, t in split.items()} for i in range(n)]


def _has_site(cfg: LMConfig, params, i: int) -> bool:
    """Whether the shared block runs after Mamba layer ``i``."""
    return "shared" in params and (i + 1) % cfg.attn_every == 0


def _mamba_out(cfg, p, x):
    return mamba_forward(cfg, p, x)[0]


def forward(cfg: LMConfig, params, batch: Dict):
    """Teacher-forced logits (B, L, vocab_padded) and aux 0.0.  With
    ``cfg.remat`` and grad on, each Mamba layer is checkpointed."""
    x = _embed(cfg, params, batch["tokens"])
    x0 = x
    L = x.shape[1]
    cos, sin = _rope(cfg, torch.arange(L, device=x.device)[None, :])
    remat = cfg.remat and torch.is_grad_enabled()
    for i, p in enumerate(_layers(params, cfg.n_layers)):
        x = (checkpoint(_mamba_out, cfg, p, x, use_reentrant=False) if remat
             else _mamba_out(cfg, p, x))
        if _has_site(cfg, params, i):
            x = _shared_block(cfg, params["shared"], x, x0, cos, sin)[0]
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x), 0.0


def loss_fn(cfg: LMConfig, params, batch: Dict):
    logits, _ = forward(cfg, params, batch)
    return sharded_ce_loss(logits, batch["labels"].long())


# ------------------------------------------------------------------ serving
def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: DeviceLike = "cuda"):
    dev = resolve_device(device)
    din, H, N, conv_ch = _mamba_dims(cfg)
    nsh = num_shared_calls(cfg)
    cache = {
        "ssm": torch.zeros((cfg.n_layers, batch, H, N, cfg.ssm_head_dim),
                           dtype=torch.float32, device=dev),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_ch),
                            dtype=cfg.dtype, device=dev),
        "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }
    if nsh:
        shp = (nsh, batch, max_len, cfg.n_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shp, dtype=cfg.dtype, device=dev)
        cache["v"] = torch.zeros(shp, dtype=cfg.dtype, device=dev)
    return cache


def decode_step(cfg: LMConfig, params, tokens, cache):
    """tokens (B, 1) against the recurrent state and the shared block's KV
    caches -> (logits (B, 1, V), cache').  The cache's tensors are updated
    in place; the returned cache holds them and ``len + 1``."""
    x = _embed(cfg, params, tokens)
    x0 = x
    cur = cache["len"]                         # per-row offsets (ragged slots)
    cos, sin = _rope(cfg, cur[:, None])
    kv_len = cur + 1
    site = 0
    for i, p in enumerate(_layers(params, cfg.n_layers)):
        x, (S, tail) = mamba_forward(cfg, p, x, state=cache["ssm"][i],
                                     conv_tail=cache["conv"][i])
        cache["ssm"][i] = S
        cache["conv"][i] = tail
        if _has_site(cfg, params, i):
            x, _ = _shared_block(cfg, params["shared"], x, x0, cos, sin,
                                 cache=(cache["k"][site], cache["v"][site]),
                                 cache_at=cur, kv_len=kv_len)
            site += 1
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x), {**cache, "len": cur + 1}


def prefill(cfg: LMConfig, params, batch: Dict, max_len: int):
    """The prompt at its exact length through the chunked scan -> (logits
    of its last position, decode-ready cache).  There is no ``lengths``:
    a pad token would pass through the recurrent state."""
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens)
    x0 = x
    B, L, _ = x.shape
    dev = x.device
    cos, sin = _rope(cfg, torch.arange(L, device=dev)[None, :])
    cache = init_cache(cfg, B, max(max_len, L), device=dev)
    site = 0
    for i, p in enumerate(_layers(params, cfg.n_layers)):
        x, (S, tail) = mamba_forward(cfg, p, x)
        cache["ssm"][i] = S
        cache["conv"][i] = tail
        if _has_site(cfg, params, i):
            x, (k, v) = _shared_block(cfg, params["shared"], x, x0, cos, sin)
            cache["k"][site, :, :L] = k
            cache["v"][site, :, :L] = v
            site += 1
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    cache["len"].fill_(L)
    return _unembed(cfg, params, x[:, -1:]), cache
