"""Shared LM substrate: config, shape table and core blocks.

The torch counterpart of ``repro.models.common``.  The reference's GSPMD
vocabulary becomes :class:`P` (a ``PartitionSpec`` as a plain tuple: one
entry per tensor dimension, each None, a mesh axis name or a tuple of
names), :func:`placements`, which turns a spec into the placements of a
``torch.distributed.tensor`` DTensor over a ``DeviceMesh``, and
:class:`Dist` with its ``wsc`` (defined here so that ``moe`` can use it;
``transformer`` exports it, as the reference's does).  The reference's
``scan_layers`` and ``analysis_unroll`` have no counterpart: the port's
layer loop is a Python loop, eager, so every layer runs and is counted.

Attention keeps the reference's ``(B, L, H, D)`` layout.  On a CUDA tensor
:func:`attention_any` calls ``kernels.ops.attention``, the hand-written
Hopper flash-attention kernel (K2), for prefill and decode alike, and in
training its hand-written backward.  On a CPU
tensor it takes the plain path the reference would take:
:func:`chunked_attention` (a Python loop over KV chunks in place of
``lax.scan``) when the KV extent exceeds two chunks, else
:func:`full_attention`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops

_MASKED = -1e30                    # the reference's masking constant

# The reference's families, all ported; none is queued for a later slice.
PORTED_FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "encdec")
QUEUED_FAMILIES: dict = {}


def check_family(name: str, family: str) -> None:
    """Raise ``NotImplementedError`` for a family the reference does not
    have; the reference's families pass."""
    if family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{name}: family {family!r} is not a family of the reference "
            f"({', '.join(PORTED_FAMILIES)})")


# ------------------------------------------------------------------ sharding
class P(tuple):
    """``jax.sharding.PartitionSpec`` without JAX: ``P(None, "data",
    "model")``.  An entry is None (replicated), a mesh axis name, or a tuple
    of names (one tensor dimension split over several mesh axes)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry, as a tuple (() for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh) -> list:
    """The DTensor placements over ``mesh`` (a ``DeviceMesh`` with
    ``mesh_dim_names``) of a tensor laid out by ``spec``: ``Shard(i)`` on
    each mesh axis that splits dimension i, ``Replicate()`` on the others.
    A dimension split over several axes is split in the mesh's order of
    those axes (major first), which is the spec's order whenever the spec
    lists them as the mesh does."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        for axis in spec_axes(entry):
            out[names.index(axis)] = Shard(dim)
    return out


def local_device(x) -> torch.device:
    """The device of ``x``'s data: a DTensor's local shard's, or x's."""
    return x.to_local().device if hasattr(x, "to_local") else x.device


class _CotangentAs(torch.autograd.Function):
    """The identity on a DTensor whose gradient is laid out as the DTensor
    is.  Without it a gradient that arrives partial over ``model`` stays
    partial, and DTensor then gathers a weight whole to multiply it (the
    same product on every shard) rather than reduce the gradient once."""

    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.device_mesh, x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.layout)


@dataclasses.dataclass(frozen=True)
class Dist:
    """Distribution context threaded through the model functions, the
    reference's ``Dist``.  ``mesh`` is a ``torch.distributed``
    ``DeviceMesh`` with named axes, or None: without a mesh every function
    is the one-device function and ``wsc`` is the identity.  With a mesh
    the tensors are DTensors laid out by the specs (``param_specs``,
    ``launch/sharding.py``), ``wsc`` redistributes to a spec, and a weight
    is all-gathered over every axis but ``model_axis`` where it is used
    (:meth:`gathered`: ZeRO-3, its gradient reduce-scattered back)."""
    mesh: Any = None
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    data_axis: str = "data"
    seq_shard: bool = False        # long-context: shard KV sequence dim
    fsdp_axes: Tuple[str, ...] = ()   # () -> (data_axis,); kimi adds 'pod'

    @property
    def fsdp(self):
        axes = self.fsdp_axes or (self.data_axis,)
        return axes if len(axes) > 1 else axes[0]

    @property
    def batch(self):
        if not self.batch_axes:
            return None                # tiny-batch shapes: replicate batch dim
        if len(self.batch_axes) > 1:
            return self.batch_axes
        return self.batch_axes[0]

    def placements(self, *spec):
        return placements(P(*spec), self.mesh)

    def wsc(self, x, *spec):
        """``x`` redistributed to ``P(*spec)``, and its gradient held to the
        same spec (a partial gradient is reduced there, as GSPMD constrains
        the cotangent of a sharding constraint); the identity without a
        mesh."""
        if self.mesh is None:
            return x
        return _CotangentAs.apply(
            x.redistribute(self.mesh, self.placements(*spec)))

    def size(self, axis: str) -> int:
        return self.mesh.size(list(self.mesh.mesh_dim_names).index(axis))

    def rank(self, axis: str) -> int:
        """This process's coordinate on mesh axis ``axis``."""
        return self.mesh.get_local_rank(axis)

    def swap(self, pls, axes, placement) -> list:
        """Placements ``pls`` with ``placement`` on the mesh axes
        ``axes``."""
        return [placement if name in axes else pl
                for name, pl in zip(self.mesh.mesh_dim_names, pls)]

    def batch_partial(self, pls) -> list:
        """The placements of the gradient of a tensor placed ``pls`` that
        each batch shard uses whole: partial over the batch axes."""
        from torch.distributed.tensor import Partial
        return self.swap(pls, self.batch_axes, Partial())

    def gathered(self, w):
        """Weight ``w`` whole on every mesh axis but ``model_axis``; the
        identity without a mesh."""
        if self.mesh is None:
            return w
        from torch.distributed.tensor import Replicate
        keep = [pl if name == self.model_axis else Replicate()
                for name, pl in zip(self.mesh.mesh_dim_names, w.placements)]
        return w.redistribute(self.mesh, keep)

    def local_map(self, fn, out, ins, grads=None):
        """``fn`` over the local shards of its DTensor arguments (the
        port's ``shard_map``): ``ins``/``out`` are the arguments' and
        results' placements, ``grads`` the placements of the arguments'
        gradients where they differ from ``ins`` (a replicated input that
        each shard uses in part gets a partial gradient)."""
        from torch.distributed.tensor.experimental import local_map
        return local_map(fn, out_placements=out, in_placements=ins,
                         in_grad_placements=grads or ins,
                         device_mesh=self.mesh)


NO_DIST = Dist()


# ------------------------------------------------------------------- configs
@dataclasses.dataclass(frozen=True)
class LMConfig:
    """One assigned architecture.  Fields cover every family; unused ones
    stay at their defaults (e.g. MoE fields for dense archs).  The same
    fields as the reference's, with torch dtypes."""

    name: str
    family: str                    # dense | moe | hybrid | encdec | vlm | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False         # qwen-style
    rope_theta: float = 500_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 2.0

    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_every: int = 0

    # xLSTM
    slstm_every: int = 0

    # enc-dec
    n_enc_layers: int = 0
    frontend_dim: int = 0
    frontend_len: int = 0

    # numerics / execution
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    attn_chunk: int = 1024
    optimizer: str = "adamw"
    fsdp_over_pod: bool = False
    train_microbatches: int = 0
    analysis_unroll: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads

    def params_count(self) -> int:
        """Analytic parameter count (for 6ND roofline accounting)."""
        d, hd = self.d_model, self.hd
        att = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.family in ("ssm",):
            att = 0
        mlp_dense = 3 * d * self.d_ff if self.d_ff else 0
        per_layer = att + mlp_dense + 2 * d
        total = self.n_layers * per_layer
        if self.n_experts:
            moe_layers = self.n_layers - self.first_dense_layers
            per_exp = 3 * d * self.expert_d_ff
            total = (
                self.first_dense_layers * (att + mlp_dense + 2 * d)
                + moe_layers * (att + 2 * d
                                + (self.n_experts + self.n_shared_experts)
                                * per_exp
                                + d * self.n_experts)
            )
        if self.family == "ssm":
            din = self.ssm_expand * d
            per = d * 2 * din + din * d + 2 * d
            total = self.n_layers * per
        if self.family == "hybrid":
            din = self.ssm_expand * d
            nh = din // self.ssm_head_dim
            mamba = (d * (2 * din + 2 * self.ssm_state + nh) + din * d + 2 * d)
            shared = att + 3 * d * self.d_ff + 2 * d
            total = self.n_layers * mamba + shared
        if self.n_enc_layers:
            total += self.n_enc_layers * (att + 3 * d * self.d_ff + 2 * d) \
                + self.n_layers * (att + 2 * d)
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(total)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode
    microbatches: int = 1


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train", microbatches=4),
    "prefill_32k": ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524_288, 1, "decode"),
}


# ------------------------------------------------------------- building blocks
def checkpointed(fn, *args):
    """``fn(*args)`` checkpointed (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint``): run again in the backward.  The
    models draw no random numbers, so the RNG state is not saved: saving
    it reads the CUDA generator, which a CUDA graph's capture refuses."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def rms_norm(x, g, eps: float):
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * g.to(x.dtype)


def rope_tables(positions, hd: int, theta: float, dtype=torch.float32):
    """positions (...,) -> cos/sin (..., hd//2); angles in fp32, then cast."""
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x (..., L, H, hd); cos/sin (..., L, 1, hd//2) broadcastable."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _dtype_scale(scale: float, dtype) -> float:
    """``scale`` rounded to ``dtype``, as ``jnp.asarray(scale, dtype)``."""
    return float(torch.tensor(scale, dtype=dtype))


def chunked_attention(q, k, v, *, causal: bool, chunk: int = 1024,
                      kv_len=None, scale: Optional[float] = None):
    """Online-softmax attention over KV chunks, O(Lq * chunk) memory.

    q (B, Lq, Hq, D); k/v (B, Lk, Hkv, D); kv_len (B,) live KV prefix.
    GQA folds q heads onto kv heads without materializing repeats."""
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = (q.reshape(B, Lq, Hkv, g, D) * _dtype_scale(scale, q.dtype)).float()

    nchunks = (Lk + chunk - 1) // chunk
    pad = nchunks * chunk - Lk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    live = (torch.full((B,), Lk, dtype=torch.int32, device=dev)
            if kv_len is None else kv_len)
    q_pos = torch.arange(Lq, device=dev) + (Lk - Lq)

    m = torch.full((B, Lq, Hkv, g), _MASKED, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Lq, Hkv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Lq, Hkv, g, D), dtype=torch.float32, device=dev)
    for j in range(nchunks):
        kb = k[:, j * chunk:(j + 1) * chunk]
        vb = v[:, j * chunk:(j + 1) * chunk]
        s = torch.einsum("blhgd,bchd->blhgc", qg, kb.float())
        k_pos = j * chunk + torch.arange(chunk, device=dev)
        mask = k_pos[None, :] < live[:, None]                  # (B, chunk)
        if causal:
            cm = k_pos[None, :] <= q_pos[:, None]              # (Lq, chunk)
            mask = (mask[:, None, :] & cm[None])[:, :, None, None, :]
        else:
            mask = mask[:, None, None, None, :]
        s = torch.where(mask, s, _MASKED)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("blhgc,bchd->blhgd", p.to(vb.dtype).float(),
                          vb.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Lq, Hq, D).to(q.dtype)


def full_attention(q, k, v, *, causal: bool, kv_len=None,
                   scale: Optional[float] = None):
    """Direct einsum attention for short L (decode steps, smoke tests)."""
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Lq, Hkv, g, D)
    s = torch.einsum("blhgd,bkhd->blhgk", qg.float(), k.float()) * scale
    dev = q.device
    q_pos = torch.arange(Lq, device=dev) + (Lk - Lq)
    k_pos = torch.arange(Lk, device=dev)
    if causal:
        cm = k_pos[None, :] <= q_pos[:, None]
        s = torch.where(cm[None, :, None, None, :], s, _MASKED)
    if kv_len is not None:
        lm = k_pos[None, :] < kv_len[:, None]
        s = torch.where(lm[:, None, None, None, :], s, _MASKED)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("blhgk,bkhd->blhgd", w.to(v.dtype).float(), v.float())
    return out.reshape(B, Lq, Hq, D).to(q.dtype)


def attention_any(q, k, v, *, causal: bool, chunk: int, kv_len=None):
    """q (B, Lq, Hq, D), k/v (B, Lk, Hkv, D) -> (B, Lq, Hq, D).

    CUDA tensors go to the flash-attention kernel (K2), which takes the
    ``(B, H, L, D)`` views of these tensors with no copy.  CPU tensors take
    the reference's plain choice: the chunked path when the KV extent
    exceeds ``2 * chunk``, else the direct one."""
    if q.device.type == "cuda":
        out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), kv_len, causal=causal)
        return out.transpose(1, 2)
    if k.shape[1] > 2 * chunk:
        return chunked_attention(q, k, v, causal=causal, chunk=chunk,
                                 kv_len=kv_len)
    return full_attention(q, k, v, causal=causal, kv_len=kv_len)


# --------------------------------------------------------------------- loss
def vocab_iota(logits):
    """``arange(V)`` over the last dimension of ``logits``; for DTensor
    logits a DTensor split as that dimension is, taken locally."""
    V = logits.shape[-1]
    if not hasattr(logits, "placements"):
        return torch.arange(V, device=logits.device)
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    local = logits.to_local()
    pls = [Shard(0) if isinstance(pl, Shard) and pl.dim == logits.ndim - 1
           else Replicate() for pl in logits.placements]
    return distribute_tensor(torch.arange(V, device=local.device),
                             logits.device_mesh, pls, src_data_rank=None)


def sharded_ce_loss(logits, labels, aux=0.0, aux_weight: float = 0.0):
    """Next-token cross entropy in the reference's formulation (labels
    -100 = ignore): fp32 logits, a detached max, the log-sum-exp as local
    max plus local sum, and the gold logit as a masked sum over the vocab,
    not a gather.  With DTensor logits (sharded on the vocabulary over
    ``model``) the max, the sum and the gold logit reduce across shards."""
    mask = (labels >= 0).float()
    labels = labels.clamp_min(0)
    l32 = logits.float()
    m = l32.amax(-1).detach()
    lse = m + torch.log(torch.exp(l32 - m[..., None]).sum(-1))
    iota = vocab_iota(l32)
    gold = torch.where(iota == labels[..., None], l32, 0.0).sum(-1)
    nll = (lse - gold) * mask
    loss = nll.sum() / mask.sum().clamp_min(1.0)
    return loss + aux_weight * aux


# --------------------------------------------------------------- param utils
def dense_init(generator: torch.Generator, shape, dtype,
               scale: Optional[float] = None):
    """Normal(0, std) draws on the generator's device; std = ``scale`` or
    1/sqrt(fan_in)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * std).to(dtype)
