"""Flash attention on the card: blockwise online softmax, GQA-aware.

The counterpart of ``repro/kernels/flash_attention.py``, in the reference's
``(B, H, L, D)`` index order:

  q      (B, Hq, Lq, D)   f32 or bf16, any strides
  k, v   (B, Hkv, Lk, D)  same dtype; query head h reads kv head h // group
  kv_len (B,) int32       optional live KV length per batch row
  out    (B, Hq, Lq, D)   q's dtype

Causal masking is aligned bottom-right (query row r sits at position
r + Lk - Lq), keys at or past ``kv_len`` (clamped to [0, Lk]) are masked,
and a fully masked row gives 0 (the denominator is clamped at 1e-30), not
NaN.  Running max and sum are fp32.

Kernels.  :func:`flash_attention` replaces the Pallas TPU kernel
``flash_attention`` (``src/repro/kernels/flash_attention.py:84-144``,
``pallas_call`` at line 117) with ``csrc/flash_attention.cu``, written by
hand for Hopper (``sm_90a``).  Three kernels sit behind this one wrapper;
:func:`kernel_path` picks one by shape, dtype and strides alone, never by
data.  The two vector kernels read 16-byte chunks, so they take only
tensors whose last dim is contiguous and whose rows are 16-byte aligned
(:func:`aligned16`; the model's transposed (B, L, H, D) views and cache
slices are):

* ``"decode"`` when ``Lq * group <= 16`` (group = Hq / Hkv) and a head row
  is a whole number of 16-byte chunks (D % 8 == 0 in bf16, D % 4 == 0 in
  f32): the keys are split across CTAs, ``decode_split(D, dtype)`` keys
  each (128 for rows up to 256 bytes), and the last CTA of each (batch, kv
  head) combines the partials in split order in the same launch.  Bound by
  bytes.
* ``"prefill_tc"`` for the other bf16 calls with D in {32, 64, 96, 128}:
  ``mma.sync`` bf16 tensor-core products over cp.async-staged 64-key K/V
  tiles, 64 rows of the flattened (position, group head) space per CTA, P
  rounded to bf16 before P V.  Bound by operations.
* ``"general"`` for everything else (fp32 prefill, other head dims,
  unaligned views): the CUDA-core fp32 kernel, any strides.  TF32 would
  break the reference's 2e-5 fp32 tolerance.

No path depends on B or on the other batch rows, and none uses float
atomics: the same inputs give the same bits, and a batch row decodes to
the same bits alone or in a batch.

Dispatch.  A CPU tensor goes to :func:`flash_attention_plain`, which
autograd differentiates.  A CUDA tensor launches one kernel or the call
raises; there is no fallback.  The kernels have no backward: in grad mode a
CUDA call where q, k or v requires grad raises.
``flash_attention.launches`` counts launches, one per call, and
``flash_attention.launches_by_path`` the same launches by kernel.

:func:`flash_decode_split_plain` and :func:`flash_prefill_tiles_plain`
mirror the two vector kernels' order of work (per-split partials combined in
split order; 64-key tiles with P rounded to v's dtype) in plain torch; only
the tests use them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = (32, 64, 96, 128)   # the tensor-core prefill's templates
TC_TILE = 64                       # keys per staged K/V tile
DECODE_MAX_ROWS = 16               # Lq * group on the split decode path
LOG2E = 1.4426950408889634


def decode_split(D: int, dtype: torch.dtype) -> int:
    """Keys per CTA on the decode path: 128, fewer for rows past 256 bytes
    so a split's K and V stay within 64 KB of shared memory."""
    row = D * torch.empty((), dtype=dtype).element_size()
    return 128 if row <= 256 else 64 if row <= 512 else 32


def kernel_path(dtype: torch.dtype, Hq: int, Hkv: int, Lq: int, D: int,
                aligned: bool = True) -> str:
    """Which kernel a CUDA call takes: "decode", "prefill_tc" or
    "general" (the module docstring gives the rule); ``aligned`` says
    whether every tensor passes :func:`aligned16`."""
    esize = torch.empty((), dtype=dtype).element_size()
    if not aligned:
        return "general"
    if Lq * (Hq // Hkv) <= DECODE_MAX_ROWS and (D * esize) % 16 == 0:
        return "decode"
    if dtype == torch.bfloat16 and D in TC_HEAD_DIMS:
        return "prefill_tc"
    return "general"


def aligned16(t: torch.Tensor) -> bool:
    """The vector paths' layout: base and every stride a multiple of 16
    bytes, last dim contiguous."""
    es = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and all(s * es % 16 == 0 for s in t.stride()[:-1]))


def _masked_scores(q, k, kv_len, causal, scale):
    """fp32 scores (B, Hkv, g, Lq, Lk) in the log2 domain, as the vector
    kernels form them (q . k, then times scale * log2 e), masked to -inf."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale_log2 = float(np.float32(scale) * np.float32(LOG2E))
    s = (q.float().reshape(B, Hkv, g, Lq, D)
         @ k.float()[:, :, None].transpose(-1, -2)) * scale_log2
    k_pos = torch.arange(Lk, device=q.device)
    mask = torch.ones((1, 1, 1, Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = torch.arange(Lq, device=q.device) + (Lk - Lq)
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if kv_len is not None:
        live = k_pos[None, :] < kv_len.to(q.device)[:, None]    # (B, Lk)
        mask = mask & live[:, None, None, None, :]
    return s.masked_fill(~mask, float("-inf"))


def _exp2_shifted(s, m):
    """exp2(s - m) with a row max of -inf read as 0 (every key masked)."""
    m_use = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    return torch.exp2(s - m_use[..., None]), m_use


def flash_attention_plain(q, k, v, kv_len: Optional[torch.Tensor] = None,
                          causal: bool = True,
                          scale: Optional[float] = None):
    """Plain torch version of what the kernels compute: fp32 scores of the
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


def flash_decode_split_plain(q, k, v, kv_len: Optional[torch.Tensor] = None,
                             split: int = 128, causal: bool = True,
                             scale: Optional[float] = None):
    """The decode kernel's order of work in plain torch: the keys cut into
    splits of ``split``, a partial (row max m, sum l, fp32 sum of p v) per
    split, then the partials combined in split order with a running max.
    Used by the tests only."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = _masked_scores(q, k, kv_len, causal, scale)      # (B,Hkv,g,Lq,Lk)
    n = max(1, -(-Lk // split))
    pad = n * split - Lk
    s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    s = s.reshape(*s.shape[:-1], n, split)
    vf = vf.reshape(B, Hkv, 1, n, split, D)
    m = s.amax(-1)                                       # (B,Hkv,g,Lq,n)
    p, _ = _exp2_shifted(s, m)
    l = p.sum(-1)
    acc = torch.einsum("bhgqsk,bhxskd->bhgqsd", p, vf)
    M = torch.full_like(m[..., 0], float("-inf"))
    L = torch.zeros_like(l[..., 0])
    out = torch.zeros_like(acc[..., 0, :])
    for t in range(n):                                   # split order
        mt = m[..., t]
        live = mt != float("-inf")          # a split with no live key: skip
        mn = torch.where(live, torch.maximum(M, mt), M)
        a = torch.where(live, torch.exp2(M - mn), torch.ones_like(M))
        w = torch.where(live, torch.exp2(mt - mn), torch.zeros_like(M))
        L = L * a + l[..., t] * w
        out = out * a[..., None] + acc[..., t, :] * w[..., None]
        M = mn
    out = out / L.clamp_min(1e-30)[..., None]
    return out.reshape(B, Hq, Lq, D).to(q.dtype)


def flash_prefill_tiles_plain(q, k, v, kv_len: Optional[torch.Tensor] = None,
                              causal: bool = True,
                              scale: Optional[float] = None):
    """The tensor-core prefill's order of work in plain torch: an online
    softmax over ``TC_TILE``-key tiles in the log2 domain, p rounded to v's
    dtype before P V, as the kernel rounds P to bf16 in registers.  Used by
    the tests only."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = _masked_scores(q, k, kv_len, causal, scale)      # (B,Hkv,g,Lq,Lk)
    m = torch.full(s.shape[:-1], float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((*s.shape[:-1], D), device=q.device)
    for j0 in range(0, Lk, TC_TILE):
        st = s[..., j0:j0 + TC_TILE]
        m_new = torch.maximum(m, st.amax(-1))
        p, m_use = _exp2_shifted(st, m_new)
        corr = torch.exp2(m - m_use)
        l = l * corr + p.sum(-1)
        pv = p.to(v.dtype).float() @ v.float()[:, :, None, j0:j0 + TC_TILE]
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Hq, Lq, D).to(q.dtype)


def flash_attention(q, k, v, kv_len: Optional[torch.Tensor] = None, *,
                    causal: bool = True, scale: Optional[float] = None):
    """Blockwise attention, (B, Hq, Lq, D) -> (B, Hq, Lq, D).  CPU tensors
    take :func:`flash_attention_plain`; CUDA tensors launch the kernel that
    :func:`kernel_path` names, or raise.  The kernel has no backward: on
    CUDA tensors, a call in grad mode where q, k or v requires grad
    raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_len, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the CUDA kernel (K2) has no backward yet (it "
            "comes with LM training); call it under torch.no_grad() or on "
            "tensors that do not require grad")
    return _flash_cuda(q, k, v, kv_len, causal, scale)


flash_attention.launches = 0
flash_attention.launches_by_path = {"decode": 0, "prefill_tc": 0,
                                    "general": 0}

# The decode path's (batch, kv head) arrival counters, one buffer per
# (device, stream), zeroed once on that stream; each launch leaves them at
# 0.  Launches in one stream run in order, so they never share a counter;
# launches on two streams get two buffers.
_COUNTERS: dict = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    buf = _COUNTERS.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = buf
    return buf


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
    path = kernel_path(q.dtype, Hq, Hkv, Lq, D,
                       all(aligned16(t) for t in (q, k, v, out)))
    strides = (ctypes.c_int64 * 16)(*q.stride(), *k.stride(), *v.stride(),
                                    *out.stride())
    kl = None if kv_len is None else kv_len.data_ptr()
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), kl,
                strides, B, Hq, Hkv, Lq, Lk, D, int(bool(causal)),
                float(scale))
        if path == "decode":
            split = decode_split(D, q.dtype)
            slots = B * Hkv * max(1, -(-Lk // split)) * Lq * (Hq // Hkv)
            part = torch.empty(slots * (D + 2), dtype=torch.float32,
                               device=q.device)
            err = lib.flash_attention_decode(
                *ptrs, _DTYPES[q.dtype], split, part.data_ptr(),
                _counters(q.device, stream, B * Hkv).data_ptr(), stream)
        elif path == "prefill_tc":
            err = lib.flash_attention_prefill_bf16(*ptrs, stream)
        else:
            err = lib.flash_attention_fwd(*ptrs, _DTYPES[q.dtype], stream)
    _build.check(lib, err, f"flash_attention launch ({path})")
    flash_attention.launches += 1
    flash_attention.launches_by_path[path] += 1
    return out
