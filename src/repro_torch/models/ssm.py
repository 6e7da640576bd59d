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

Under a mesh (``dist``) every entry point runs: a Mamba2 block keeps the
reference's two constraints (its in_proj output split over ``model``,
then y before out_proj), and each shard runs its heads' part between the
projections (:func:`_mamba_mesh`: its x and z columns, all of B and C, its
state, split by heads as ``cache_specs`` lays the ``ssm`` cache); the
shared block's attention is ``transformer._attn_mesh`` at prefill and
``_attn_decode_mesh`` at decode.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models.common import (NO_DIST, Dist, LMConfig, P,
                                       checkpointed,
                                       dense_init, local_device, rms_norm,
                                       sharded_ce_loss)
from repro_torch.models.transformer import (_attn, _attn_decode_mesh,
                                            _attn_mesh, _cache_layer, _embed,
                                            _ffn_dense, _from_local, _rope,
                                            _stack_layers, _unembed,
                                            vocab_padded)

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
                       chunk: int = SSD_CHUNK, qk=None):
    """Chunkwise SSD scan with per-head B and C (keys/queries (B, L, H,
    N)): quadratic inside each chunk of ``chunk`` steps, a recurrence over
    the chunks.  xbar (B, L, H, P), loga (B, L, H).  Returns (y (B, L, H,
    P), final state (B, H, N, P)).  The prompt is padded to whole chunks;
    a pad step has log decay 0 and zero input, so it carries the state
    unchanged.  ``qk`` is the chunks' (B, C, Q, S, H) query-key products
    when the caller has them (:func:`chunk_qk`), else they are formed
    here."""
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
    if qk is None:
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


def _mamba_core(cfg: LMConfig, zxbcdt, conv_w, conv_b, A_log, Dw, dt_bias,
                state=None, conv_tail=None, heads=None):
    """A Mamba2 block between its two projections: ``zxbcdt`` (B, L,
    2 din + 2N + H) the in_proj output, the conv and SSM weights as stored
    (cast here as the reference casts them).  ``heads`` = (h0, hl) keeps
    heads h0 .. h0 + hl - 1 only: their x and z columns, dt, decay, skip
    and state, the conv over their x channels and all of B and C (a shard
    of the mesh path); None keeps every head.  Returns (y (B, L, hl*P)
    gated, final state (B, hl, N, P), the conv tail of every channel)."""
    Bsz, L, _ = zxbcdt.shape
    din, H, N, conv_ch = _mamba_dims(cfg)
    Pd = cfg.ssm_head_dim
    z, xin, Bm, Cm, dt = torch.split(zxbcdt, [din, din, N, N, H], dim=-1)

    conv_in = torch.cat([xin, Bm, Cm], dim=-1)                 # (B,L,conv_ch)
    K = cfg.ssm_conv
    if conv_tail is not None:
        ctx = torch.cat([conv_tail, conv_in], dim=1)
    else:
        ctx = F.pad(conv_in, (0, 0, K - 1, 0))
    # A copy: a view would keep the whole padded context alive with the
    # state (a prompt's (B, L + K - 1, conv_ch) in every layer).
    new_tail = ctx[:, -(K - 1):].clone()
    conv_w, conv_b = conv_w.to(zxbcdt.dtype), conv_b.to(zxbcdt.dtype)
    A_log, Dw, dt_bias = A_log.float(), Dw.float(), dt_bias.float()
    hl = H
    if heads is not None and heads[1] < H:
        h0, hl = heads
        cols = slice(h0 * Pd, (h0 + hl) * Pd)
        chans = torch.cat([torch.arange(cols.start, cols.stop),
                           torch.arange(din, conv_ch)]).to(ctx.device)
        ctx, conv_w, conv_b = ctx[..., chans], conv_w[:, chans], conv_b[chans]
        z, dt = z[..., cols], dt[..., h0:h0 + hl]
        A_log, Dw, dt_bias = (t[h0:h0 + hl] for t in (A_log, Dw, dt_bias))
        if state is not None and state.shape[1] != hl:
            state = state[:, h0:h0 + hl]
    # Depthwise causal conv: K shifted products summed in the reference's
    # order (Python's sum, from 0), then the bias.
    conv = ctx[:, 0:L] * conv_w[0][None, None]
    for k in range(1, K):
        conv = conv + ctx[:, k:k + L] * conv_w[k][None, None]
    conv = F.silu(conv + conv_b)
    xin, Bm, Cm = torch.split(conv, [hl * Pd, N, N], dim=-1)

    dt = F.softplus(dt.float() + dt_bias)                      # (B,L,H)
    A = -torch.exp(A_log)                                      # (H,) < 0
    loga = dt * A[None, None]                                  # (B,L,H)
    xh = xin.reshape(Bsz, L, hl, Pd)
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
    y = y + xh.float() * Dw[None, None, :, None]
    y = y.reshape(Bsz, L, hl * Pd).to(zxbcdt.dtype)
    return y * F.silu(z), S_final, new_tail


def chunk_qk(keys, queries, chunk: int = SSD_CHUNK):
    """The query-key products :func:`_ssd_chunked_heads` forms inside each
    chunk, (B, C, Q, S, H), from keys/queries (B, L, H, N): N may be a
    part of the contraction, whose partial products then sum."""
    Bsz, L, H, N = keys.shape
    pad = (-L) % chunk
    if pad:
        keys, queries = (_pad_steps(t, pad) for t in (keys, queries))
    C_ = keys.shape[1] // chunk
    return torch.einsum("bcqhn,bcshn->bcqsh",
                        queries.reshape(Bsz, C_, chunk, H, N),
                        keys.reshape(Bsz, C_, chunk, H, N))


def mamba_forward(cfg: LMConfig, p, x, state=None, conv_tail=None,
                  dist: Dist = NO_DIST, site=None):
    """One Mamba2 block.  x (B, L, d) -> (out, (ssm_state, conv_tail)).

    With ``state`` (B, H, N, P) and L == 1, the recurrent step; otherwise
    the chunked scan from ``state`` (zeros when None).  ``conv_tail`` (B,
    K - 1, conv_ch) is the last K - 1 conv inputs before ``x``.  Under
    ``dist.mesh``: :func:`_mamba_mesh` (``state``/``conv_tail`` then the
    stacked caches and ``site`` the layer)."""
    if dist.mesh is not None:
        return _mamba_mesh(cfg, p, x, dist, state, conv_tail, site)
    h = rms_norm(x, p["norm"].to(x.dtype), cfg.norm_eps)
    zxbcdt = h @ p["in_proj"].to(h.dtype)
    y, S_final, new_tail = _mamba_core(
        cfg, zxbcdt, p["conv_w"], p["conv_b"], p["A_log"], p["D"],
        p["dt_bias"], state, conv_tail)
    return x + y @ p["out_proj"].to(x.dtype), (S_final, new_tail)


_SMALL = ("conv_w", "conv_b", "A_log", "D", "dt_bias")


def _mamba_local(cfg: LMConfig, heads, layer, zx, conv_w, conv_b, A_log, Dw,
                 dt_bias, state=None, tails=None):
    """One shard's :func:`_mamba_core`.  With the stacked caches (``state``
    this shard's (n, B, hl, N, P), ``tails`` (n, B, K - 1, conv_ch) whole
    on ``model``), layer ``layer``'s state and tail are read and the new
    ones written IN PLACE."""
    if state is None:
        return _mamba_core(cfg, zx, conv_w, conv_b, A_log, Dw, dt_bias,
                           heads=heads)
    y, S, tail = _mamba_core(cfg, zx, conv_w, conv_b, A_log, Dw, dt_bias,
                             state[layer], tails[layer], heads)
    state[layer] = S
    tails[layer] = tail
    return y


def _mamba_mesh(cfg: LMConfig, p, x, dist: Dist, state=None, tails=None,
                layer=None):
    """A Mamba2 block under a mesh, the reference's two constraints
    (``ssm.py:117``, ``:158``): in_proj TP over ``model`` (its output split
    by columns), then gathered whole, and each shard runs its heads
    (``model`` divides H; else every head) through :func:`_mamba_core` in
    ``local_map``: its x and z columns, all of B and C, its state; y split
    by heads over ``model`` into out_proj, whose rows are split the same
    way, and the partial sums reduced.  Without caches returns (out,
    (state, tail)) as DTensors: the state split by heads as
    ``cache_specs`` lays it, the tail whole on ``model``.  With the
    stacked caches (decode) they are updated in place and (out, None)
    returned."""
    from torch.distributed.tensor import Partial, Replicate
    m, b = dist.model_axis, dist.batch
    din, H, N, conv_ch = _mamba_dims(cfg)
    msize = dist.size(m)
    split = H % msize == 0 and msize > 1
    heads = (dist.rank(m) * (H // msize), H // msize) if split else None
    h = rms_norm(x, p["norm"].to(x.dtype), cfg.norm_eps)
    zx = h @ dist.gathered(p["in_proj"]).to(h.dtype)
    zx = dist.wsc(dist.wsc(zx, b, None, m), b, None, None)
    rep = [Replicate()] * dist.mesh.ndim
    small = [dist.gathered(p[k]).redistribute(dist.mesh, rep)
             for k in _SMALL]
    zx_pl = dist.placements(b, None, None)
    y_pl = dist.placements(b, None, m if split else None)
    # What a shard uses a part of gets a partial gradient over the axes
    # whose shards use different parts.
    zx_grad = dist.swap(zx_pl, (m,), Partial()) if split else zx_pl
    small_grad = dist.batch_partial(rep)
    if split:
        small_grad = dist.swap(small_grad, (m,), Partial())
    fn = functools.partial(_mamba_local, cfg, heads, layer)
    if state is None:
        s_pl = dist.placements(b, m if split else None, None, None)
        y, S, tail = dist.local_map(
            fn, out=(y_pl, s_pl, zx_pl), ins=[zx_pl] + [rep] * 5,
            grads=[zx_grad] + [small_grad] * 5)(zx, *small)
        kept = (S, tail)
    else:
        y = dist.local_map(
            fn, out=y_pl, ins=[zx_pl] + [rep] * 5
            + [list(state.placements), list(tails.placements)])(
                zx, *small, state, tails)
        kept = None
    y = dist.wsc(y, b, None, m)
    out = y @ dist.gathered(p["out_proj"]).to(x.dtype)
    return x + dist.wsc(out, b, None, None), kept


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
                  cache_at=None, kv_len=None, dist: Dist = NO_DIST):
    """Zamba2's shared attention + MLP on concat(hidden, embedding).  With
    ``cache`` the site's KV cache is written in place (``transformer._attn``).
    Under ``dist.mesh`` the attention is ``transformer._attn_mesh``, or in
    decode (``cache`` = (stacked k, stacked v, site), ``cache_at`` the
    positions) ``transformer._attn_decode_mesh``."""
    h = torch.cat([x, x0], dim=-1) @ dist.gathered(
        sp["concat_proj"]).to(x.dtype)
    if dist.mesh is None:
        h, kv = _attn(cfg, sp, h, cos, sin, cache, cache_at, kv_len)
    else:
        h = dist.wsc(h, dist.batch, None, None)
        if cache is None:
            h, kv = _attn_mesh(cfg, sp, h, cos, sin, dist)
        else:
            h, kv = _attn_decode_mesh(cfg, sp, h, *cache, cache_at,
                                      dist), None
    h = _ffn_dense(cfg, sp, h, dist)
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


def _mamba_out(cfg, p, x, dist=NO_DIST):
    return mamba_forward(cfg, p, x, dist=dist)[0]


def forward(cfg: LMConfig, params, batch: Dict, dist: Dist = NO_DIST):
    """Teacher-forced logits (B, L, vocab_padded) and aux 0.0.  With
    ``cfg.remat`` and grad on, each Mamba layer is checkpointed.  Under
    ``dist.mesh`` params and batch are DTensors laid out by
    :func:`param_specs` and ``launch.sharding``."""
    x = _embed(cfg, params, batch["tokens"], dist)
    x0 = x
    L = x.shape[1]
    cos, sin = _rope(cfg, torch.arange(L, device=local_device(x))[None, :])
    remat = cfg.remat and torch.is_grad_enabled()
    for i, p in enumerate(_layers(params, cfg.n_layers)):
        x = (checkpointed(_mamba_out, cfg, p, x, dist) if remat
             else _mamba_out(cfg, p, x, dist))
        if _has_site(cfg, params, i):
            x = _shared_block(cfg, params["shared"], x, x0, cos, sin,
                              dist=dist)[0]
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x, dist), 0.0


def loss_fn(cfg: LMConfig, params, batch: Dict, dist: Dist = NO_DIST):
    logits, _ = forward(cfg, params, batch, dist)
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


def decode_step(cfg: LMConfig, params, tokens, cache, dist: Dist = NO_DIST):
    """tokens (B, 1) against the recurrent state and the shared block's KV
    caches -> (logits (B, 1, V), cache').  The cache's tensors are updated
    in place; the returned cache holds them and ``len + 1``.  Under
    ``dist.mesh``: :func:`_decode_mesh`."""
    if dist.mesh is not None:
        return _decode_mesh(cfg, params, tokens, cache, dist)
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


def _decode_mesh(cfg: LMConfig, params, tokens, cache, dist: Dist):
    """:func:`decode_step` under a mesh: the SSM state (split by heads) and
    the shared block's KV caches updated in place shard by shard, the conv
    tails through a copy whole on ``model`` (``cache_specs`` splits them by
    channels, and a shard reads all of B's and C's), written back."""
    x = _embed(cfg, params, tokens, dist)
    x0 = x
    cur = dist.wsc(cache["len"], dist.batch)
    conv = cache["conv"]
    tails = dist.wsc(conv, None, dist.batch, None, None)
    site = 0
    for i, p in enumerate(_layers(params, cfg.n_layers)):
        x, _ = mamba_forward(cfg, p, x, cache["ssm"], tails, dist, i)
        if _has_site(cfg, params, i):
            x, _ = _shared_block(cfg, params["shared"], x, x0, None, None,
                                 cache=(cache["k"], cache["v"], site),
                                 cache_at=cur, dist=dist)
            site += 1
    conv.to_local().copy_(tails.redistribute(
        dist.mesh, list(conv.placements)).to_local())
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x, dist), {**cache,
                                            "len": cache["len"] + 1}


def prefill(cfg: LMConfig, params, batch: Dict, max_len: int,
            dist: Dist = NO_DIST):
    """The prompt at its exact length through the chunked scan -> (logits
    of its last position, decode-ready cache).  There is no ``lengths``:
    a pad token would pass through the recurrent state.  Under
    ``dist.mesh``: :func:`_prefill_mesh`."""
    if dist.mesh is not None:
        return _prefill_mesh(cfg, params, batch, max_len, dist)
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


def _prefill_mesh(cfg: LMConfig, params, batch: Dict, max_len: int,
                  dist: Dist):
    """:func:`prefill` under a mesh: every cache key laid out by
    ``launch.sharding.cache_specs`` for this batch and ``max_len``,
    ``len`` replicated."""
    from torch.distributed.tensor import Replicate
    from repro_torch.launch.sharding import cache_specs
    from repro_torch.models.common import ShapeCfg
    x = _embed(cfg, params, batch["tokens"], dist)
    x0 = x
    B, L, _ = x.shape
    max_len = max(max_len, L)
    dev = local_device(x)
    cos, sin = _rope(cfg, torch.arange(L, device=dev)[None, :])
    specs = cache_specs(cfg, ShapeCfg("prefill", max_len, B, "prefill"),
                        dist)
    Ss, tails, ks, vs = [], [], [], []
    for i, p in enumerate(_layers(params, cfg.n_layers)):
        x, (S, tail) = mamba_forward(cfg, p, x, dist=dist)
        Ss.append(S)
        tails.append(tail)
        if _has_site(cfg, params, i):
            x, (k, v) = _shared_block(cfg, params["shared"], x, x0, cos, sin,
                                      dist=dist)
            ks.append(_cache_layer(k, max_len, specs["k"][1:], dist))
            vs.append(_cache_layer(v, max_len, specs["v"][1:], dist))
    cache = {"ssm": _stack_layers(dist, Ss, specs["ssm"]),
             "conv": _stack_layers(dist, tails, specs["conv"]),
             "len": _from_local(dist, torch.full((B,), L, dtype=torch.int32,
                                                 device=dev), (B,),
                                [Replicate()] * dist.mesh.ndim)}
    if ks:
        cache["k"] = _stack_layers(dist, ks, specs["k"])
        cache["v"] = _stack_layers(dist, vs, specs["v"])
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x[:, -1:], dist), cache
