"""Decoder-only transformer LM: dense GQA (llama/qwen/yi/phi3),
fine-grained MoE (deepseek/kimi) and the VLM backbone (internvl2).

The torch counterpart of ``repro.models.transformer``:

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

Under a mesh (``dist``: ``Dist`` over a ``DeviceMesh``), ``forward``,
``loss_fn`` and ``prefill`` take parameters and batch as DTensors laid out
by :func:`param_specs` and ``launch.sharding``: the projections TP over
``model`` (the KV heads all-gathered where they do not divide it, the
gate/up weight relaid per shard), weights gathered over the other axes
where used (ZeRO-3), K2 per shard through ``Dist.local_map``, the MoE
layer expert parallel with its capacity (``moe``), the prefill's cache
laid out by ``launch.sharding.cache_specs``.  ``decode_step`` under a
mesh writes the new token into the cache shard that holds its position;
where the cache is split by sequence, each shard runs K2's decode with
stats over its slice and the slices are merged in order
(:func:`_attn_decode_mesh`).  Heads that do not divide ``model`` are cut
into head groups (:func:`_attn_layout`).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (NO_DIST, Dist, LMConfig, P,
                                       checkpointed,
                                       apply_rope, attention_any,
                                       check_family, dense_init, local_device,
                                       rms_norm, rope_tables, sharded_ce_loss)




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


def abstract_params(cfg: LMConfig, dtype=None) -> Dict:
    """The tree of :func:`init_params` as ``meta`` tensors (shapes and
    dtypes, no storage; ``dtype`` replaces ``cfg.param_dtype``): what the
    dry-run lays out over a mesh without drawing a weight."""
    pdt = dtype or cfg.param_dtype

    def stack(shapes, n):
        return {k: torch.empty((n,) + shp, dtype=pdt, device="meta")
                for k, shp in shapes.items()}
    vp, n_dense = vocab_padded(cfg), _n_dense(cfg)
    params = {
        "embed": torch.empty((vp, cfg.d_model), dtype=pdt, device="meta"),
        "final_norm": torch.empty((cfg.d_model,), dtype=pdt, device="meta"),
        "layers": stack(_layer_shapes(cfg, bool(cfg.n_experts)),
                        cfg.n_layers - n_dense),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = torch.empty((cfg.d_model, vp), dtype=pdt,
                                        device="meta")
    if n_dense:
        params["dense_layers"] = stack(_layer_shapes(cfg, False), n_dense)
    if cfg.family == "vlm":
        params["patch_proj"] = torch.empty((cfg.frontend_dim, cfg.d_model),
                                           dtype=pdt, device="meta")
    return params


def _layer_specs(cfg: LMConfig, moe: bool, dist: Dist) -> Dict[str, P]:
    m, d = dist.model_axis, dist.fsdp
    specs = {
        "ln1": P(None, None), "ln2": P(None, None),
        "wq": P(None, d, m), "wk": P(None, d, m), "wv": P(None, d, m),
        "wo": P(None, m, d),
    }
    if cfg.qkv_bias:
        specs.update({"bq": P(None, m), "bk": P(None, m), "bv": P(None, m)})
    if moe:
        specs.update({
            "router": P(None, d, None),
            "moe_w13": P(None, m, d, None),
            "moe_w2": P(None, m, None, d),
        })
        if cfg.n_shared_experts:
            specs.update({"shared_w13": P(None, d, m),
                          "shared_w2": P(None, m, d)})
    else:
        specs.update({"w13": P(None, d, m), "w2": P(None, m, d)})
    return specs


def param_specs(cfg: LMConfig, dist: Dist) -> Dict:
    """Each parameter's spec, the reference's leaf for leaf: layers TP over
    ``model``, FSDP over ``dist.fsdp``.  A tied table is vocab-sharded, so
    the logits stay sharded on the vocabulary and the lookup pays one
    (B, L, d) reduction."""
    m, d = dist.model_axis, dist.fsdp
    specs = {
        "embed": P(m, None) if cfg.tie_embeddings else P(None, m),
        "final_norm": P(None),
        "layers": _layer_specs(cfg, moe=bool(cfg.n_experts), dist=dist),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = P(d, m)
    if cfg.n_experts and cfg.first_dense_layers:
        specs["dense_layers"] = _layer_specs(cfg, moe=False, dist=dist)
    if cfg.family == "vlm":
        specs["patch_proj"] = P(None, m)
    return specs


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
    nor land anywhere.  A negative column is dropped too: under a mesh a
    shard holding a later slice of the positions is given offsets
    relative to its slice.  The drop stays on the device (no host read, so a
    decode step can be captured in a CUDA graph): the column is clamped to
    S - 1 and the value already there is written back.  Callers write one
    token a row (decode, L = 1), so a clamped column is its own row's and
    meets no other write of the same ``index_put_``."""
    B, L = k.shape[:2]
    S = ck.shape[1]
    rows = torch.arange(B, device=k.device)[:, None]
    cols = cache_at.long()[:, None] + torch.arange(L, device=k.device)
    keep = ((cols >= 0) & (cols < S))[:, :, None, None]
    cols = cols.clamp(0, S - 1)
    for cache, new in ((ck, k), (cv, v)):
        cache[rows, cols] = torch.where(keep, new.to(cache.dtype),
                                        cache[rows, cols])


# ------------------------------------------------------------------- blocks
def _attn(cfg: LMConfig, p, x, cos, sin, cache=None, cache_at=None,
          kv_len=None, dist: Dist = NO_DIST):
    """Attention block.  Returns (residual_out, (k, v)).

    With ``cache = (ck, cv)`` ((B, S, Hkv, hd) views of the stacked cache),
    the new keys and values are written into it IN PLACE at per-row offsets
    ``cache_at`` (B,) (:func:`write_cache_rows`; the reference's update was
    functional, ``.at[rows, cols].set``).  Attention then runs over the
    whole cache, masked to ``kv_len``.  Under a mesh: :func:`_attn_mesh`."""
    if dist.mesh is not None:
        return _attn_mesh(cfg, p, x, cos, sin, dist)
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


def _attn_local(cfg: LMConfig, cos, sin, kv_from, sel, q, k, v):
    """One shard's causal attention over its q heads: q (B, L, Hq*hd),
    k/v (B, L, Hk*hd) -> (out (B, L, Hl*hd) or its columns ``sel[2]``, k,
    v roped, (B, L, Hk, hd)).  ``kv_from`` is None when k/v hold exactly
    the KV heads of these q heads; else the first q head's global index,
    and k/v hold every KV head, of which the shard attends those its q
    heads read.  ``sel`` is None when q holds this shard's heads, else
    (heads, cols): q holds every head, the shard attends ``heads`` (a
    slice) and keeps the output columns ``cols`` (a slice)."""
    B, L, _ = q.shape
    hd = cfg.hd
    Hq, Hk = q.shape[-1] // hd, k.shape[-1] // hd
    q = q.reshape(B, L, Hq, hd)
    if sel is not None:
        q = q[:, :, sel[0]]
    Hl = q.shape[2]
    q = apply_rope(q, cos[:, :, None, :], sin[:, :, None, :])
    k = apply_rope(k.reshape(B, L, Hk, hd), cos[:, :, None, :],
                   sin[:, :, None, :])
    v = v.reshape(B, L, Hk, hd)
    ka, va = k, v
    if kv_from is not None:
        g = cfg.group
        lo, hi = kv_from // g, (kv_from + Hl - 1) // g + 1
        if Hl % (hi - lo):
            raise NotImplementedError(
                f"{cfg.name}: {Hl} q heads a shard do not share their "
                f"{hi - lo} KV heads evenly")
        ka, va = k[:, :, lo:hi], v[:, :, lo:hi]
    out = attention_any(q, ka, va, causal=True, chunk=cfg.attn_chunk)
    out = out.reshape(B, L, Hl * hd)
    if sel is not None:
        out = out[..., sel[1]]
    return out, k, v


def _attn_mesh(cfg: LMConfig, p, x, cos, sin, dist: Dist):
    """The attention block under a mesh: the projections TP over
    ``model``, attention (K2 on the card) per shard through
    ``dist.local_map``.  A shard holds whole q heads when ``model`` divides
    ``n_heads`` and whole KV heads when it also divides ``n_kv_heads``.
    Where the KV heads do not divide (llama3.2-1b's 8 on 16), k and v are
    all-gathered over ``model`` and each shard attends its q heads' KV
    group.  Where the q heads do not divide either (qwen2.5-32b's 40 on
    16), q, k and v are all-gathered, the heads are cut into G = gcd(heads,
    model) groups (8 of 5 heads), each group attended by model / G shards
    (2), and each shard keeps the output columns ``wo``'s rows expect of
    it, which lie in its group: GSPMD's layout of the reference's program,
    a device's attention 1/G of the whole.  Returns (x', (k, v)) with k, v
    (B, L, Hkv, hd) roped, placed as ``_attn_layout`` says."""
    from torch.distributed.tensor import Partial
    m, b = dist.model_axis, dist.batch
    q, k, v = _qkv_mesh(cfg, p, x, dist)
    q = dist.wsc(q, b, None, m)
    q_axis, kv_axis, kv_from, sel = _attn_layout(cfg, dist)
    q = dist.wsc(q, b, None, q_axis)
    k = dist.wsc(k, b, None, kv_axis)
    v = dist.wsc(v, b, None, kv_axis)
    q_pl = dist.placements(b, None, q_axis)
    kv_pl = dist.placements(b, None, kv_axis)
    out_pl = dist.placements(b, None, m if sel is not None else q_axis)
    # An input of which each shard reads a part: partial gradients.
    part = dist.swap(kv_pl, (m,), Partial())
    q_grad = part if sel is not None else q_pl
    kv_grad = part if kv_from is not None else kv_pl
    fn = functools.partial(_attn_local, cfg, cos, sin, kv_from, sel)
    out, k, v = dist.local_map(
        fn, out=(out_pl, kv_pl, kv_pl), ins=(q_pl, kv_pl, kv_pl),
        grads=(q_grad, kv_grad, kv_grad))(q, k, v)
    out = dist.wsc(out, b, None, m)
    y = out @ dist.gathered(p["wo"]).to(out.dtype)
    return x + dist.wsc(y, b, None, None), (k, v)


def _qkv_mesh(cfg: LMConfig, p, x, dist: Dist):
    """The attention block's normed input through the q, k and v
    projections (and biases), each weight gathered but over ``model``."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    out = [h @ dist.gathered(p[w]).to(h.dtype) for w in ("wq", "wk", "wv")]
    if cfg.qkv_bias:
        out = [t + dist.gathered(p[bias]).to(h.dtype)
               for t, bias in zip(out, ("bq", "bk", "bv"))]
    return out


def _attn_layout(cfg: LMConfig, dist: Dist):
    """(q's model axis, k/v's model axis, kv_from, sel) for
    :func:`_attn_mesh`: each axis None where that tensor is whole on
    ``model``; ``kv_from`` is the index of this shard's first q head when
    k/v are gathered, else None; ``sel`` is None, or (heads, cols) when q
    is whole and the shard attends one head group (:func:`_attn_local`)."""
    m = dist.model_axis
    msize = dist.size(m)
    if cfg.n_heads % msize:
        groups = math.gcd(cfg.n_heads, msize)
        per, share = cfg.n_heads // groups, msize // groups
        r = dist.rank(m)
        lo = (r // share) * per
        w = cfg.n_heads * cfg.hd // msize          # wo's rows on a shard
        c0 = (r % share) * w
        return None, None, lo, (slice(lo, lo + per), slice(c0, c0 + w))
    if cfg.n_kv_heads % msize:
        return m, None, dist.rank(m) * (cfg.n_heads // msize), None
    return m, m, None, None


def _gate_up_local(q: int, s: int, w):
    """Shard ``s``'s gate columns ``s*q .. (s+1)*q - 1`` then its up
    columns, from the whole ``[gate | up]`` weight."""
    f = w.shape[-1] // 2
    lo, hi = s * q, (s + 1) * q
    return torch.cat([w[:, lo:hi], w[:, f + lo:f + hi]], dim=-1)


def _swiglu(cfg: LMConfig, h, w13, w2, dist: Dist):
    """``silu(g) * u`` in fp32 over ``h @ w13 = [g | u]``, times ``w2``,
    under a mesh.  The stored ``w13`` is split by columns over ``model``,
    so a shard's columns are all gate or all up; the weight is gathered
    and each shard takes its gate columns and the same up columns, so one
    product gives it ``[g_s | u_s]`` and the activation stays split the
    way ``w2``'s rows are.  With ``model`` of size 1 the stored weight is
    already that layout and is used as it is."""
    from torch.distributed.tensor import Partial, Replicate
    m, b = dist.model_axis, dist.batch
    w = dist.gathered(w13)
    msize = dist.size(m)
    if msize > 1:
        whole = w.redistribute(dist.mesh, [Replicate()] * dist.mesh.ndim)
        q = w13.shape[-1] // 2 // msize
        rep = list(whole.placements)
        w = dist.local_map(
            functools.partial(_gate_up_local, q, dist.rank(m)),
            out=list(w.placements), ins=(rep,),
            grads=(dist.swap(rep, (m,), Partial()),))(whole)
    hh = dist.wsc(h @ w.to(h.dtype), b, None, m)
    pl = list(hh.placements)
    g, u = dist.local_map(lambda t: t.chunk(2, dim=-1), out=(pl, pl),
                          ins=(pl,))(hh)
    act = (F.silu(g.float()) * u.float()).to(h.dtype)
    return dist.wsc(act @ dist.gathered(w2).to(h.dtype), b, None, None)


def _ffn_dense(cfg: LMConfig, p, x, dist: Dist = NO_DIST):
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if dist.mesh is not None:
        return x + _swiglu(cfg, h, p["w13"], p["w2"], dist)
    g, u = (h @ p["w13"].to(h.dtype)).chunk(2, dim=-1)
    act = (F.silu(g.float()) * u.float()).to(h.dtype)
    return x + act @ p["w2"].to(h.dtype)


def _ffn_moe(cfg: LMConfig, p, x, dist: Dist = NO_DIST):
    """Routed experts (``moe.moe_ffn``: dropless without a mesh, expert
    parallel with its capacity under one) plus the shared experts as one
    dense SwiGLU over ``n_shared_experts * expert_d_ff``.  Returns
    (x', aux)."""
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    experts = {"router": p["router"], "w13": p["moe_w13"], "w2": p["moe_w2"]}
    if dist.mesh is not None:
        out, aux = moe_lib.moe_ffn(
            cfg, experts, h, dist.mesh, dist.batch_axes, dist.model_axis,
            dist.data_axis, fsdp_axes=dist.fsdp_axes or None)
        if cfg.n_shared_experts:
            out = out + _swiglu(cfg, h, p["shared_w13"], p["shared_w2"],
                                dist)
        return x + out, aux
    out, aux = moe_lib.moe_ffn(cfg, experts, h)
    if cfg.n_shared_experts:
        g, u = (h @ p["shared_w13"].to(h.dtype)).chunk(2, dim=-1)
        act = (F.silu(g.float()) * u.float()).to(h.dtype)
        out = out + act @ p["shared_w2"].to(h.dtype)
    return x + out, aux


def _one_layer(cfg: LMConfig, p, x, cos, sin, moe: bool, cache=None,
               cache_at=None, kv_len=None, dist: Dist = NO_DIST):
    """Returns (x', (k, v), aux); aux is 0.0 for a dense layer."""
    x, kv = _attn(cfg, p, x, cos, sin, cache, cache_at, kv_len, dist)
    if moe:
        x, aux = _ffn_moe(cfg, p, x, dist)
        return x, kv, aux
    return _ffn_dense(cfg, p, x, dist), kv, 0.0


# ------------------------------------------------------------------ forward
def _embed_local(offset, table, tokens):
    """Rows ``tokens - offset`` of one shard's slice of the table; a token
    outside the slice gives a zero row (another shard holds it)."""
    rows = tokens.long() - offset
    inside = (rows >= 0) & (rows < table.shape[0])
    out = table[rows.clamp(0, table.shape[0] - 1)]
    return torch.where(inside[..., None], out, 0.0)


def _embed(cfg: LMConfig, params, tokens, dist: Dist = NO_DIST):
    """Gather the rows, then cast: the same values as casting the whole
    table first, without a copy of the (vocab, d) table per call.  Under a
    mesh each shard gathers from its slice of the table (a tied table is
    split by vocabulary: the rows of other shards are zeros, summed over
    ``model``)."""
    if dist.mesh is None:
        return params["embed"][tokens.long()].to(cfg.dtype)
    from torch.distributed.tensor import Partial
    m, b = dist.model_axis, dist.batch
    table = params["embed"]
    tok_pl = dist.placements(b, None)
    if cfg.tie_embeddings:
        rows = table.shape[0] // dist.size(m)
        fn = functools.partial(_embed_local, dist.rank(m) * rows)
        out_pl = dist.swap(dist.placements(b, None, None), (m,), Partial())
        t_pl = dist.placements(m, None)
    else:
        fn = functools.partial(_embed_local, 0)
        out_pl = dist.placements(b, None, m)
        t_pl = dist.placements(None, m)
    x = dist.local_map(fn, out=out_pl, ins=(t_pl, tok_pl),
                       grads=(dist.batch_partial(t_pl), tok_pl))(table, tokens)
    return dist.wsc(x, b, None, None).to(cfg.dtype)


def _unembed(cfg: LMConfig, params, x, dist: Dist = NO_DIST):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = x @ dist.gathered(w).to(cfg.dtype)
    return dist.wsc(logits, dist.batch, None, dist.model_axis)


def _with_patches(cfg: LMConfig, params, batch: Dict, x,
                  dist: Dist = NO_DIST):
    """The VLM family: ``batch["patches"] @ patch_proj`` in front of the
    token embeddings ``x``; other families and text-only batches pass."""
    if cfg.family == "vlm" and "patches" in batch:
        pe = batch["patches"].to(cfg.dtype) @ dist.gathered(
            params["patch_proj"]).to(cfg.dtype)
        pe = dist.wsc(pe, dist.batch, None, None)
        x = torch.cat([pe, x], dim=1)
    return x


def _rope(cfg: LMConfig, positions):
    return rope_tables(positions, cfg.hd, cfg.rope_theta, cfg.dtype)


def _layer_out(cfg: LMConfig, p, x, cos, sin, moe: bool,
               dist: Dist = NO_DIST):
    x, _, aux = _one_layer(cfg, p, x, cos, sin, moe, dist=dist)
    return x, aux


def forward(cfg: LMConfig, params, batch: Dict, dist: Dist = NO_DIST):
    """batch: {'tokens': (B, L) int, optional 'patches' (B, P,
    frontend_dim) for the VLM family}.  Returns (logits (B, P + L,
    vocab_padded), aux_loss): aux is the MoE layers' router losses summed
    (0.0 for the other families).  With ``cfg.remat`` and grad on, each
    layer is checkpointed.  Under ``dist.mesh`` params and batch are
    DTensors laid out by ``param_specs`` and ``launch.sharding``."""
    check_family(cfg.name, cfg.family)
    x = _with_patches(cfg, params, batch,
                      _embed(cfg, params, batch["tokens"], dist), dist)
    L = x.shape[1]
    cos, sin = _rope(cfg, torch.arange(L, device=local_device(x))[None, :])
    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    for p, moe in _layers(cfg, params):
        if remat:
            x, a = checkpointed(_layer_out, cfg, p, x, cos, sin, moe, dist)
        else:
            x, a = _layer_out(cfg, p, x, cos, sin, moe, dist)
        aux = aux + a
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x, dist), aux


def loss_fn(cfg: LMConfig, params, batch: Dict, dist: Dist = NO_DIST,
            aux_weight: float = 0.01):
    """Next-token cross entropy of ``forward``: batch {'tokens', 'labels'}
    (B, L), labels -100 = ignore.  Returns a 0-d fp32 tensor (replicated
    under a mesh)."""
    logits, aux = forward(cfg, params, batch, dist)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:    # VLM: drop the patch positions
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    return sharded_ce_loss(logits, labels.long(), aux, aux_weight)


# ------------------------------------------------------------------ serving
def cache_spec(cfg: LMConfig, dist: Dist) -> P:
    """KV cache (n_layers, B, S, Hkv, hd) sharding: batch-sharded when B
    divides, sequence-sharded for long-context B=1 (the reference's)."""
    if dist.seq_shard:
        return P(None, None, dist.batch, None, None)
    return P(None, dist.batch, None, None, None)


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: DeviceLike = "cuda"):
    dev = resolve_device(device)
    shp = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shp, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shp, dtype=cfg.dtype, device=dev),
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def _from_local(dist: Dist, local, shape, pls):
    """A DTensor of global ``shape`` (contiguous) from this shard's
    ``local`` part."""
    from torch.distributed.tensor import DTensor
    stride, n = [], 1
    for size in reversed(shape):
        stride.insert(0, n)
        n *= size
    return DTensor.from_local(local, dist.mesh, pls, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _stack_layers(dist: Dist, parts, spec):
    """Per-layer DTensors ``parts`` (one layout) stacked on a new leading
    axis and laid out by ``spec`` (its first entry None)."""
    pls = [type(pl)(pl.dim + 1) if pl.is_shard() else pl
           for pl in parts[0].placements]
    stack = _from_local(dist, torch.stack([t.to_local() for t in parts]),
                        (len(parts),) + tuple(parts[0].shape), pls)
    return dist.wsc(stack, *spec)


def _cache_layer(k, max_len: int, spec, dist: Dist):
    """One layer's (B, L, Hkv, hd) keys padded to ``max_len`` positions and
    laid out by ``spec``."""
    pad = max_len - k.shape[1]
    pls = list(k.placements)
    k = dist.local_map(lambda t: F.pad(t, (0, 0, 0, 0, 0, pad)),
                       out=pls, ins=(pls,))(k)
    return dist.wsc(k, *spec)


def _last_rows(x, idx):
    return x[torch.arange(x.shape[0], device=x.device), idx.long()][:, None]


def _prefill_mesh(cfg: LMConfig, params, batch: Dict, max_len: int,
                  dist: Dist):
    """:func:`prefill` under a mesh.  The cache's k and v are laid out by
    ``launch.sharding.cache_specs`` for this batch and ``max_len`` (by
    sequence over ``model`` where the KV heads do not divide it), ``len``
    replicated."""
    from torch.distributed.tensor import Replicate
    from repro_torch.launch.sharding import cache_specs
    from repro_torch.models.common import ShapeCfg
    x = _with_patches(cfg, params, batch,
                      _embed(cfg, params, batch["tokens"], dist), dist)
    B, L, _ = x.shape
    max_len = max(max_len, L)          # VLM: the patch positions
    dev = local_device(x)
    cos, sin = _rope(cfg, torch.arange(L, device=dev)[None, :])
    spec = cache_specs(cfg, ShapeCfg("prefill", max_len, B, "prefill"),
                       dist)["k"]
    ks, vs = [], []
    for p, moe in _layers(cfg, params):
        x, (k_l, v_l), _ = _one_layer(cfg, p, x, cos, sin, moe, dist=dist)
        ks.append(_cache_layer(k_l, max_len, spec[1:], dist))
        vs.append(_cache_layer(v_l, max_len, spec[1:], dist))
    k, v = _stack_layers(dist, ks, spec), _stack_layers(dist, vs, spec)
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    rep = [Replicate()] * dist.mesh.ndim
    lengths = batch.get("lengths")
    if lengths is not None:
        lengths = dist.wsc(lengths, dist.batch)
        x_pl = dist.placements(dist.batch, None, None)
        x_last = dist.local_map(
            lambda xl, n: _last_rows(xl, torch.clamp(n.long() - 1, 0, L - 1)),
            out=x_pl, ins=(x_pl, dist.placements(dist.batch)))(x, lengths)
        cache_len = dist.wsc(lengths.to(torch.int32), None)
    else:
        x_last = x[:, -1:]
        cache_len = _from_local(dist, torch.full(
            (B,), L, dtype=torch.int32, device=dev), (B,), rep)
    logits = _unembed(cfg, params, x_last, dist)
    return logits, {"k": k, "v": v, "len": cache_len}


def prefill(cfg: LMConfig, params, batch: Dict, max_len: int,
            dist: Dist = NO_DIST):
    """Run the prompt, build the KV cache.  Returns (logits_last, cache).

    Optional ``batch["lengths"]`` (B,) marks the true prompt length of each
    row when prompts are right-padded to a shared bucket: logits are
    gathered at position length-1 and ``cache["len"]`` is set per row.
    Trailing pad is harmless: attention is causal (pad rows never feed real
    rows) and decode masks KV beyond ``len``.  A VLM batch's ``patches``
    go in front of the tokens and their positions extend the cache.  Under
    ``dist.mesh``: :func:`_prefill_mesh`."""
    check_family(cfg.name, cfg.family)
    if dist.mesh is not None:
        return _prefill_mesh(cfg, params, batch, max_len, dist)
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


def decode_step(cfg: LMConfig, params, tokens, cache, dist: Dist = NO_DIST):
    """One token per sequence: tokens (B, 1) -> (logits (B, 1, V), cache').

    ``cache["k"]``/``cache["v"]`` are updated in place (the new token's
    keys and values at each row's ``len``); the returned cache holds the
    same tensors and ``len + 1``.  Under ``dist.mesh``:
    :func:`_decode_mesh`."""
    check_family(cfg.name, cfg.family)
    if dist.mesh is not None:
        return _decode_mesh(cfg, params, tokens, cache, dist)
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


# ------------------------------------------------------- decode under a mesh
def cache_layout(cache_k, dist: Dist):
    """(seq axes, head axis) of a stacked KV cache (n, B, S, Hkv, hd)
    DTensor: the mesh axes that split its positions, in mesh order, and
    ``model`` when it splits its KV heads (else None)."""
    from torch.distributed.tensor import Shard
    seq, head = [], None
    for name, pl in zip(dist.mesh.mesh_dim_names, cache_k.placements):
        if isinstance(pl, Shard) and pl.dim == 2:
            seq.append(name)
        elif isinstance(pl, Shard) and pl.dim == 3:
            head = name
    return tuple(seq), head


def _seq_index(dist: Dist, axes) -> int:
    """This shard's index among the slices of a dimension split over
    ``axes`` (mesh order, major first): a cache's positions, a batch."""
    idx = 0
    for a in axes:
        idx = idx * dist.size(a) + dist.rank(a)
    return idx


def _decode_local(cfg: LMConfig, layer: int, offset: int, split: bool,
                  q, k, v, cur, ck, cv):
    """One shard's decode attention: q (B, 1, Hl*hd), k/v (B, 1, Hk*hd) of
    the new token, ``cur`` (B,) its position, ``ck``/``cv`` this shard's
    stacked cache (n, B, S_loc, Hk, hd), which holds positions ``offset``
    .. ``offset + S_loc - 1``.  The new keys and values are written IN
    PLACE into layer ``layer`` where their position falls in this slice
    (:func:`write_cache_rows`); attention runs over the slice masked to
    ``cur + 1``.  Without ``split`` (the slice is the whole cache) it
    returns the output (B, 1, Hl*hd); with it, K2's decode with stats:
    (out fp32, M, L) with a leading slice axis of 1, (1, B, Hl, 1, hd) and
    (1, B, Hl, 1)."""
    B = q.shape[0]
    hd = cfg.hd
    cos, sin = _rope(cfg, cur[:, None])
    q = apply_rope(q.reshape(B, 1, -1, hd), cos[:, :, None, :],
                   sin[:, :, None, :])
    k = apply_rope(k.reshape(B, 1, -1, hd), cos[:, :, None, :],
                   sin[:, :, None, :])
    v = v.reshape(B, 1, -1, hd)
    ck, cv = ck[layer], cv[layer]
    S = ck.shape[1]
    write_cache_rows(ck, cv, cur - offset, k, v)
    kv_len = torch.clamp(cur + 1 - offset, 0, S).to(torch.int32)
    if not split:
        out = attention_any(q, ck.to(q.dtype), cv.to(q.dtype), causal=False,
                            chunk=S, kv_len=kv_len)
        return out.reshape(B, 1, -1)
    from repro_torch.kernels.flash_attention import flash_attention
    o, M, L = flash_attention(q.transpose(1, 2), ck.to(q.dtype).transpose(1, 2),
                              cv.to(q.dtype).transpose(1, 2), kv_len,
                              causal=False, return_stats=True)
    return o[None], M[None], L[None]


def _combine_local(dtype, o, M, L):
    """Merge the gathered slices (n, B, H, 1, hd) in slice order
    (``flash_attention.combine_decode_partials``) -> (B, 1, H*hd)."""
    from repro_torch.kernels.flash_attention import combine_decode_partials
    out = combine_decode_partials(o.unbind(0), M.unbind(0), L.unbind(0))
    B, H, _, hd = out.shape
    return out.transpose(1, 2).reshape(B, 1, H * hd).to(dtype)


def _attn_decode_mesh(cfg: LMConfig, p, x, cache_k, cache_v, layer: int,
                      cur, dist: Dist):
    """The attention block of one decode step under a mesh, against the
    stacked cache laid out by ``launch.sharding.cache_specs``.  Where the
    cache splits the KV heads over ``model``, each shard attends its heads
    over its cache.  Where it splits the positions (over ``model`` when
    the KV heads do not divide it, over ``data`` too when the batch does
    not), q, k and v are whole on those axes; each shard writes the new
    token into the slice that holds its position, runs K2's decode with
    stats over its slice, and the (out, M, L) of every slice are
    all-gathered and merged in slice order, so every shard holds the same
    bits.  ``cur`` is the positions, placed by the batch."""
    from torch.distributed.tensor import Replicate, Shard
    m, b = dist.model_axis, dist.batch
    seq, head = cache_layout(cache_k, dist)
    q, k, v = _qkv_mesh(cfg, p, x, dist)
    q = dist.wsc(q, b, None, head)
    k = dist.wsc(k, b, None, head)
    v = dist.wsc(v, b, None, head)
    pl = dist.placements(b, None, head)
    c_pl = list(cache_k.placements)
    cur_pl = dist.placements(b)
    slices = math.prod(dist.size(a) for a in seq)
    split = slices > 1
    offset = _seq_index(dist, seq) * (cache_k.shape[2] // slices)
    fn = functools.partial(_decode_local, cfg, layer, offset, split)
    ins = (pl, pl, pl, cur_pl, c_pl, c_pl)
    if not split:
        out = dist.local_map(fn, out=pl, ins=ins)(q, k, v, cur, cache_k,
                                                  cache_v)
    else:
        # (slice, batch, head, ...): the slice axis split over the
        # sequence axes, then gathered whole.
        names = dist.mesh.mesh_dim_names
        stat = [Shard(0) if a in seq else Shard(1) if a in dist.batch_axes
                else Shard(2) if a == head else Replicate() for a in names]
        o, M, L = dist.local_map(fn, out=(stat, stat, stat), ins=ins)(
            q, k, v, cur, cache_k, cache_v)
        whole = [Replicate() if a in seq else pl_
                 for a, pl_ in zip(names, stat)]
        o, M, L = (t.redistribute(dist.mesh, whole) for t in (o, M, L))
        out = dist.local_map(functools.partial(_combine_local, q.dtype),
                             out=pl, ins=(whole, whole, whole))(o, M, L)
    out = dist.wsc(out, b, None, m)
    y = out @ dist.gathered(p["wo"]).to(out.dtype)
    return x + dist.wsc(y, b, None, None)


def _decode_mesh(cfg: LMConfig, params, tokens, cache, dist: Dist):
    """:func:`decode_step` under a mesh: tokens placed by the batch, the
    cache laid out by ``launch.sharding.cache_specs`` (its k and v written
    in place, shard by shard), ``len`` replicated."""
    x = _embed(cfg, params, tokens, dist)
    cur = dist.wsc(cache["len"], dist.batch)
    for i, (p, moe) in enumerate(_layers(cfg, params)):
        x = _attn_decode_mesh(cfg, p, x, cache["k"], cache["v"], i, cur,
                              dist)
        if moe:
            x, _ = _ffn_moe(cfg, p, x, dist)
        else:
            x = _ffn_dense(cfg, p, x, dist)
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    logits = _unembed(cfg, params, x, dist)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "len": cache["len"] + 1}
