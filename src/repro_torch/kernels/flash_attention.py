"""Flash attention on the card: blockwise online softmax, GQA-aware.

The counterpart of ``repro/kernels/flash_attention.py``, in the reference's
``(B, H, L, D)`` index order:

  q      (B, Hq, Lq, D)   f32 or bf16, any strides
  k, v   (B, Hkv, Lk, D)  same dtype; query head h reads kv head h // group
  kv_len (B,) int32       optional live KV length per batch row
  out    (B, Hq, Lq, D)   q's dtype

Causal masking is aligned bottom-right (query row r sits at position
r + Lk - Lq), keys at or past ``kv_len`` are masked, and a fully masked row
gives 0 (the kernel's denominator is clamped at 1e-30), not NaN.

Kernel.  :func:`flash_attention` replaces the Pallas TPU kernel
``flash_attention`` (``src/repro/kernels/flash_attention.py:84-144``,
``pallas_call`` at line 117) with ``csrc/flash_attention.cu``, written by
hand for Hopper (``sm_90a``).  The TPU kernel walks a sequential kv grid
axis with its running max, sum and accumulator in VMEM scratch; here the kv
loop runs inside the CTA with those in fp32 registers.  One CTA serves one
(batch, kv head) and 32 rows of the flattened (query position, group head)
space, so every K/V tile it stages in shared memory is read once for all
query heads of the GQA group; in decode (Lq = 1) one CTA serves the whole
group.  The loop stops at the CTA's causal diagonal and at ``kv_len``, as
the TPU kernel's ``pl.when`` does.  Products are CUDA-core ``fmaf`` in fp32;
no atomics and no split-KV, so the same inputs give the same bits.

Bound.  At the main path's shapes (prefill Lq = Lk <= 1024, decode Lq = 1
against a 2048-position cache) both terms are microseconds: the causal
product's 4 * Hq * D * sum(live keys) operations at the bf16 tensor-core
rate, and the bytes of q, the live K/V rows and the output at HBM rate.
The kernel is latency-bound far above that (``PERF.md``); ``wgmma``, TMA and
warp specialisation are later work.

Dispatch.  A CPU tensor goes to :func:`flash_attention_plain`.  A CUDA
tensor goes to the kernel or the call raises; there is no fallback.
``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_attention_plain(q, k, v, kv_len: Optional[torch.Tensor] = None,
                          causal: bool = True,
                          scale: Optional[float] = None):
    """Plain torch version of what the kernel computes: fp32 scores of the
    scaled q, bottom-right causal mask, ``kv_len`` mask, softmax with the
    denominator clamped at 1e-30 (a fully masked row gives 0), output in
    q's dtype."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, g, Lq, D) * scale
    s = qf @ k.float()[:, :, None].transpose(-1, -2)      # (B,Hkv,g,Lq,Lk)
    k_pos = torch.arange(Lk, device=q.device)
    mask = torch.ones((1, 1, 1, Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = torch.arange(Lq, device=q.device) + (Lk - Lq)
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if kv_len is not None:
        live = k_pos[None, :] < kv_len.to(q.device)[:, None]    # (B, Lk)
        mask = mask & live[:, None, None, None, :]
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m)
    out = (p @ v.float()[:, :, None]) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, Hq, Lq, D).to(q.dtype)


def flash_attention(q, k, v, kv_len: Optional[torch.Tensor] = None, *,
                    causal: bool = True, scale: Optional[float] = None):
    """Blockwise attention, (B, Hq, Lq, D) -> (B, Hq, Lq, D).  CPU tensors
    take :func:`flash_attention_plain`; CUDA tensors launch the
    ``flash_attention`` kernel or raise."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_len, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _flash_cuda(q, k, v, kv_len, causal, scale)


flash_attention.launches = 0


def _flash_cuda(q, k, v, kv_len, causal: bool, scale):
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: {q.dtype}; the kernel takes "
                        f"{list(_DTYPES)}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be 4-D (B, H, L, D)")
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, Lk, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} is not a multiple of "
                         f"Hkv={Hkv}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    if B > 65535 or Hkv > 65535:
        raise ValueError(f"flash_attention: B={B} or Hkv={Hkv} > 65535")
    if kv_len is not None:
        if (kv_len.device != q.device or kv_len.dtype != torch.int32
                or kv_len.shape != (B,) or not kv_len.is_contiguous()):
            raise ValueError("flash_attention: kv_len must be a contiguous "
                             f"int32 ({B},) tensor on {q.device}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 16)(*q.stride(), *k.stride(), *v.stride(),
                                    *out.stride())
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(), strides,
            B, Hq, Hkv, Lq, Lk, D, int(bool(causal)), float(scale),
            _DTYPES[q.dtype], stream)
    _build.check(lib, err, "flash_attention launch")
    flash_attention.launches += 1
    return out
