"""Shared LM substrate: config, shape table and core blocks.

The torch counterpart of ``repro.models.common`` for one device.  The
reference's GSPMD vocabulary (``wsc``, ``batch_spec``, ``scan_layers``,
``Dist``) has no counterpart here: the port runs on one card and returns to
it with the multi-device slice.

Attention keeps the reference's ``(B, L, H, D)`` layout.  On a CUDA tensor
:func:`attention_any` calls ``kernels.ops.attention``, the hand-written
Hopper flash-attention kernel (K2), for prefill and decode alike.  On a CPU
tensor it takes the plain path the reference would take:
:func:`chunked_attention` (a Python loop over KV chunks in place of
``lax.scan``) when the KV extent exceeds two chunks, else
:func:`full_attention`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

_MASKED = -1e30                    # the reference's masking constant

# Families of the reference the port does not run yet -> the slice that
# brings each (ROADMAP.md).
QUEUED_FAMILIES = {
    "moe": "the MoE family slice (grouped matmul)",
    "vlm": "the VLM family slice (patch frontend)",
    "hybrid": "the SSM/hybrid family slice (Mamba2 SSD)",
    "ssm": "the xLSTM family slice",
    "encdec": "the enc-dec family slice",
}


def check_family(name: str, family: str) -> None:
    """Raise ``NotImplementedError`` naming the slice queued for a family
    the port does not run yet; the dense family passes."""
    if family != "dense":
        raise NotImplementedError(
            f"{name}: family {family!r} is not ported yet; it comes with "
            f"{QUEUED_FAMILIES.get(family, 'a later slice')} (ROADMAP.md)")


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


# --------------------------------------------------------------- param utils
def dense_init(generator: torch.Generator, shape, dtype,
               scale: Optional[float] = None):
    """Normal(0, std) draws on the generator's device; std = ``scale`` or
    1/sqrt(fan_in)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * std).to(dtype)
