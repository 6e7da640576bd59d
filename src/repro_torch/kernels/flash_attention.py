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

Backward.  In grad mode, when q, k or v requires grad, the call goes
through ``_FlashAttention`` (a ``torch.autograd.Function``): its forward
launches the kernel :func:`kernel_path` names, as above, and saves q, k, v,
the output and ``kv_len``; its backward is :func:`flash_attention_bwd`,
which launches two more kernels on CUDA tensors: a dq kernel (it recomputes
each row's log-sum-exp and Delta = rowsum(dO o) into an fp32 (B, Hq, Lq)
scratch, then dQ over the key tiles) and, after it on the same stream, a
dkdv kernel (a CTA per 64 keys sums dK and dV over the group's query heads
and the query tiles in order).  The reference puts no ``custom_vjp`` on its
Pallas call, so they follow the flash-attention backward's formulas
(:func:`flash_attention_bwd_plain` writes them out in plain fp32 torch),
without atomics: a launch repeats bit for bit.  ``kv_len`` gets no
gradient.  :func:`backward_path` picks the pair by dtype, head dim and
strides alone, never by data:

* ``"tc"`` for bf16 with D in ``TC_HEAD_DIMS`` when all eight tensors (q,
  k, v, out, dout, dq, dk, dv) pass :func:`aligned16`:
  ``csrc/flash_attention_bwd_tc.cu``, ``mma.sync`` bf16 tensor-core
  products over cp.async-staged 64-row tiles, P and dS rounded to bf16 in
  registers before their products.
* ``"general"`` otherwise (fp32, other head dims, unaligned views): the
  CUDA-core fp32 kernels of ``csrc/flash_attention.cu``, any strides.  TF32
  would break the fp32 gate (1e-4 of max|ref|).

Neither copies an input: ``dout`` and the model's views are read through
their strides.

Dispatch.  A CPU tensor goes to :func:`flash_attention_plain` (and, in the
backward, to :func:`flash_attention_bwd_plain`).  A CUDA tensor launches a
kernel or the call raises; there is no fallback.
``flash_attention.launches`` counts forward launches, one per call, and
``flash_attention.launches_by_path`` the same launches by kernel;
``flash_attention.backward_launches`` counts the backward's launches by
kernel (``"dq"``, ``"dkdv"``), one each per backward, and
``flash_attention.backward_launches_by_path`` counts backwards by path
(``"tc"``, ``"general"``), one per backward.

Decode with stats.  ``flash_attention(..., return_stats=True)`` takes
the decode kernel and also writes, per row, the normalised output in fp32
and the row's max M (log2 domain) and sum L, so that attention over key
slices held apart (a KV cache split by sequence over a mesh) merges in
:func:`combine_decode_partials`; ``flash_attention.stats_launches``
counts those launches (inside the ``decode`` count).  Without stats the
kernel's output is the same bits as before.

:func:`flash_decode_split_plain`, :func:`flash_prefill_tiles_plain` and
:func:`flash_bwd_tc_tiles_plain` mirror the vector kernels' order of work
(per-split partials combined in split order; 64-key tiles with P rounded to
v's dtype; the tensor-core backward's tiles and bf16 roundings) in plain
torch; only the tests use them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import tracing
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


def backward_path(dtype: torch.dtype, Hq: int, Hkv: int, Lq: int, D: int,
                  aligned: bool = True) -> str:
    """Which backward kernels a CUDA call takes: "tc" or "general" (the
    module docstring gives the rule).  Like :func:`kernel_path` it takes the
    call's shape, but only the dtype, the head dim and ``aligned`` (every
    one of the eight tensors passes :func:`aligned16`) decide: the
    tensor-core kernels take any group and any Lq."""
    if aligned and dtype == torch.bfloat16 and D in TC_HEAD_DIMS:
        return "tc"
    return "general"


def aligned16(t: torch.Tensor) -> bool:
    """The vector paths' layout: base and every stride a multiple of 16
    bytes, last dim contiguous."""
    es = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and all(s * es % 16 == 0 for s in t.stride()[:-1]))


def _live_mask(Lq, Lk, kv_len, causal, device):
    """The keys each query row sees, (1 or B, 1, 1, Lq, Lk) bool: bottom-right
    causal alignment and the ``kv_len`` mask."""
    k_pos = torch.arange(Lk, device=device)
    mask = torch.ones((1, 1, 1, Lq, Lk), dtype=torch.bool, device=device)
    if causal:
        q_pos = torch.arange(Lq, device=device) + (Lk - Lq)
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if kv_len is not None:
        live = k_pos[None, :] < kv_len.to(device)[:, None]      # (B, Lk)
        mask = mask & live[:, None, None, None, :]
    return mask


def _masked_scores(q, k, kv_len, causal, scale):
    """fp32 scores (B, Hkv, g, Lq, Lk) in the log2 domain, as the vector
    kernels form them (q . k, then times scale * log2 e), masked to -inf."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale_log2 = float(np.float32(scale) * np.float32(LOG2E))
    s = (q.float().reshape(B, Hkv, g, Lq, D)
         @ k.float()[:, :, None].transpose(-1, -2)) * scale_log2
    mask = _live_mask(Lq, Lk, kv_len, causal, q.device)
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
    s = s.masked_fill(~_live_mask(Lq, Lk, kv_len, causal, q.device),
                      float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m)
    out = (p @ v.float()[:, :, None]) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, Hq, Lq, D).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, out, dout,
                              kv_len: Optional[torch.Tensor] = None,
                              causal: bool = True,
                              scale: Optional[float] = None):
    """Plain torch version of the backward kernels: (dq, dk, dv) of
    :func:`flash_attention_plain` at ``(q, k, v)`` for the output gradient
    ``dout``, from the saved output ``out``, written out in fp32:
    P = softmax of the masked scores (0 on a fully masked row),
    dV = Pᵀ dO and dK = scale dSᵀ Q summed over the group's query heads,
    dP = dO Vᵀ, Delta = rowsum(dO o), dS = P (dP - Delta),
    dQ = scale dS K.  Each gradient in its input's dtype."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, g, Lq, D)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    s = (qf @ kf.transpose(-1, -2)) * scale                # (B,Hkv,g,Lq,Lk)
    s = s.masked_fill(~_live_mask(Lq, Lk, kv_len, causal, q.device),
                      float("-inf"))
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    p = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    do = dout.float().reshape(B, Hkv, g, Lq, D)
    delta = (do * out.float().reshape(B, Hkv, g, Lq, D)).sum(-1,
                                                             keepdim=True)
    ds = p * (do @ vf.transpose(-1, -2) - delta)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf).sum(2) * scale
    dv = (p.transpose(-1, -2) @ do).sum(2)
    return (dq.reshape(B, Hq, Lq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_decode_split_plain(q, k, v, kv_len: Optional[torch.Tensor] = None,
                             split: int = 128, causal: bool = True,
                             scale: Optional[float] = None,
                             return_stats: bool = False):
    """The decode kernel's order of work in plain torch: the keys cut into
    splits of ``split``, a partial (row max m, sum l, fp32 sum of p v) per
    split, then the partials combined in split order with a running max.
    With ``return_stats`` it returns what the kernel writes with stats:
    (the normalised output in fp32 (B, Hq, Lq, D), each row's max M in the
    log2 domain and its sum L, (B, Hq, Lq) each); a row with no live key
    has M = -inf, L = 0 and output 0.  The CPU side of
    ``flash_attention(..., return_stats=True)``."""
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
    if return_stats:
        return (out.reshape(B, Hq, Lq, D), M.reshape(B, Hq, Lq),
                L.reshape(B, Hq, Lq))
    return out.reshape(B, Hq, Lq, D).to(q.dtype)


def combine_decode_partials(outs, Ms, Ls):
    """Attention over the union of disjoint key slices from each slice's
    ``flash_attention(..., return_stats=True)``: ``outs`` the normalised
    fp32 outputs (..., D), ``Ms``/``Ls`` the row maxima (log2 domain) and
    sums (...).  The row's max and sum run over the slices in the given
    (fixed) order with the kernel's running-max formula; then each
    slice's output is weighted by its share of the sum, L_i 2^(M_i - M) /
    L, and the weighted outputs add in the same order, so one slice comes
    back unchanged.  A row that no slice sees stays exactly 0.  Returns
    the fp32 output."""
    M = torch.full_like(Ms[0], float("-inf"))
    L = torch.zeros_like(Ls[0])
    for mt, lt in zip(Ms, Ls):
        live = mt != float("-inf")
        mn = torch.where(live, torch.maximum(M, mt), M)
        a = torch.where(live, torch.exp2(M - mn), torch.ones_like(M))
        w = torch.where(live, torch.exp2(mt - mn), torch.zeros_like(M))
        L = L * a + lt * w
        M = mn
    out = torch.zeros_like(outs[0])
    for o, mt, lt in zip(outs, Ms, Ls):
        live = mt != float("-inf")
        share = torch.where(live, lt * torch.exp2(mt - M), 0.0) \
            / L.clamp_min(1e-30)
        out = out + o * share[..., None]
    return out


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


def flash_bwd_tc_tiles_plain(q, k, v, out, dout,
                             kv_len: Optional[torch.Tensor] = None,
                             causal: bool = True,
                             scale: Optional[float] = None):
    """The tensor-core backward's order of work in plain torch: each row's
    LSE from an online softmax over ``TC_TILE``-key tiles in the log2
    domain (the dq kernel's pass 1), P = exp2(S - LSE), dS = P (dP - Delta)
    in fp32, P and dS rounded to q's dtype before their products (as the
    kernels round them to bf16 in registers), dQ summed over the key tiles
    in ascending order, dK and dV over (group head, query tile) in order.
    Used by the tests only."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    T = TC_TILE
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = _masked_scores(q, k, kv_len, causal, scale)      # (B,Hkv,g,Lq,Lk)
    m = torch.full(s.shape[:-1], float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    for j0 in range(0, Lk, T):
        m_new = torch.maximum(m, s[..., j0:j0 + T].amax(-1))
        p, m_use = _exp2_shifted(s[..., j0:j0 + T], m_new)
        l = l * torch.exp2(m - m_use) + p.sum(-1)
        m = m_new
    lse = torch.where(l > 0, m + torch.log2(l), float("inf"))
    qf = q.float().reshape(B, Hkv, g, Lq, D)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    do = dout.float().reshape(B, Hkv, g, Lq, D)
    delta = (do * out.float().reshape(B, Hkv, g, Lq, D)).sum(-1)
    p = torch.exp2(s - lse[..., None])            # masked or dead rows: 0
    ds = p * (do @ vf.transpose(-1, -2) - delta[..., None])
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dq = torch.zeros_like(qf)
    for j0 in range(0, Lk, T):
        dq += ds[..., j0:j0 + T] @ kf[..., j0:j0 + T, :]
    dk = torch.zeros((B, Hkv, Lk, D), device=q.device)
    dv = torch.zeros_like(dk)
    for hh in range(g):
        for i0 in range(0, Lq, T):
            rows = slice(i0, i0 + T)
            dv += p[:, :, hh, rows].transpose(-1, -2) @ do[:, :, hh, rows]
            dk += ds[:, :, hh, rows].transpose(-1, -2) @ qf[:, :, hh, rows]
    return ((dq * scale).reshape(B, Hq, Lq, D).to(q.dtype),
            (dk * scale).to(k.dtype), dv.to(v.dtype))


def flash_attention(q, k, v, kv_len: Optional[torch.Tensor] = None, *,
                    causal: bool = True, scale: Optional[float] = None,
                    return_stats: bool = False):
    """Blockwise attention, (B, Hq, Lq, D) -> (B, Hq, Lq, D).  CPU tensors
    take :func:`flash_attention_plain`; CUDA tensors launch the kernel that
    :func:`kernel_path` names, or raise.  In grad mode, when q, k or v
    requires grad, the call is differentiable in all three: its backward is
    :func:`flash_attention_bwd` (the two backward kernels on CUDA
    tensors).

    ``return_stats`` (the decode path only, no gradient) returns (out fp32
    (B, Hq, Lq, D), M, L (B, Hq, Lq)): the normalised output and each
    row's max (log2 domain) and sum, so that attention over several key
    slices merges with :func:`combine_decode_partials`.  CPU tensors take
    :func:`flash_decode_split_plain`; CUDA tensors launch the decode
    kernel, which writes them beside its output, or raise."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if return_stats:
        return _decode_stats(q, k, v, kv_len, causal, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, kv_len, causal, scale)
    return _forward(q, k, v, kv_len, causal, scale)


flash_attention.launches = 0
flash_attention.launches_by_path = {"decode": 0, "prefill_tc": 0,
                                    "general": 0}
flash_attention.stats_launches = 0       # decode launches with stats
flash_attention.backward_launches = {"dq": 0, "dkdv": 0}
flash_attention.backward_launches_by_path = {"tc": 0, "general": 0}
for _attr in ("launches", "launches_by_path", "stats_launches",
              "backward_launches", "backward_launches_by_path"):
    tracing.register(flash_attention, _attr)


class _FlashAttention(torch.autograd.Function):
    """The forward through :func:`_forward`, the backward through
    :func:`flash_attention_bwd`; no gradient for ``kv_len``."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, scale):
        out = _forward(q, k, v, kv_len, causal, scale)
        ctx.save_for_backward(q, k, v, out, kv_len)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, kv_len = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, kv_len,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def _decode_stats(q, k, v, kv_len, causal: bool, scale):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention: return_stats has no gradient")
    if q.device.type == "cpu":
        return flash_decode_split_plain(
            q, k, v, kv_len, decode_split(q.shape[-1], q.dtype), causal,
            scale, return_stats=True)
    return _flash_cuda(q, k, v, kv_len, causal, scale, stats=True)


def _forward(q, k, v, kv_len, causal: bool, scale):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_len, causal, scale)
    return _flash_cuda(q, k, v, kv_len, causal, scale)


def flash_attention_bwd(q, k, v, out, dout,
                        kv_len: Optional[torch.Tensor] = None,
                        causal: bool = True, scale: Optional[float] = None):
    """(dq, dk, dv) of :func:`flash_attention` at ``(q, k, v)``, given its
    output ``out`` and the output gradient ``dout``.  CPU tensors take
    :func:`flash_attention_bwd_plain`; CUDA tensors launch the two backward
    kernels that :func:`backward_path` names, or raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, kv_len, causal,
                                         scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    return _flash_bwd_cuda(q, k, v, out, dout, kv_len, causal, scale)

# The decode path's (batch, kv head) arrival counters, one buffer per
# (device, stream), zeroed once on that stream; each launch leaves them at
# 0.  Launches in one stream run in order, so they never share a counter;
# launches on two streams get two buffers.  A launch captured into a CUDA
# graph gets a buffer of its own instead, allocated from the graph's pool
# and zeroed by a memset captured with it: every replay starts it at 0,
# and no two graphs (which share the capture stream) share one, whatever
# streams they are replayed on.  The per-call ``part`` buffer is the
# graph's own allocation in the same way.
_COUNTERS: dict = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    buf = _COUNTERS.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = buf
    return buf


def _check_inputs(q, k, v, kv_len):
    """Raise on what the kernels do not take; returns (B, Hq, Hkv, Lq, Lk,
    D)."""
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
    return B, Hq, Hkv, Lq, Lk, D


def _flash_cuda(q, k, v, kv_len, causal: bool, scale, stats: bool = False):
    B, Hq, Hkv, Lq, Lk, D = _check_inputs(q, k, v, kv_len)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    path = kernel_path(q.dtype, Hq, Hkv, Lq, D,
                       all(aligned16(t) for t in (q, k, v, out)))
    out32 = ml = None
    if stats:
        if path != "decode":
            raise ValueError(
                f"flash_attention: return_stats needs the decode kernel; "
                f"this call takes {path!r}")
        out32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        ml = torch.empty((2, B, Hq, Lq), dtype=torch.float32,
                         device=q.device)
    if out.numel() == 0:
        return (out32, ml[0], ml[1]) if stats else out
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
                _counters(q.device, stream, B * Hkv).data_ptr(),
                None if out32 is None else out32.data_ptr(),
                None if ml is None else ml.data_ptr(), stream)
        elif path == "prefill_tc":
            err = lib.flash_attention_prefill_bf16(*ptrs, stream)
        else:
            err = lib.flash_attention_fwd(*ptrs, _DTYPES[q.dtype], stream)
    _build.check(lib, err, f"flash_attention launch ({path})")
    flash_attention.launches += 1
    flash_attention.launches_by_path[path] += 1
    if stats:
        flash_attention.stats_launches += 1
        return out32, ml[0], ml[1]
    return out


def _flash_bwd_cuda(q, k, v, out, dout, kv_len, causal: bool, scale):
    B, Hq, Hkv, Lq, Lk, D = _check_inputs(q, k, v, kv_len)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}, q "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # The row statistics the dq kernel writes and the dkdv kernel reads.
    lse = torch.empty((B, Hq, Lq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    tensors = (q, k, v, out, dout, dq, dk, dv)
    path = backward_path(q.dtype, Hq, Hkv, Lq, D,
                         all(aligned16(t) for t in tensors))
    strides = (ctypes.c_int64 * 32)(*(s for t in tensors for s in t.stride()))
    kl = None if kv_len is None else kv_len.data_ptr()
    dims = (strides, B, Hq, Hkv, Lq, Lk, D, int(bool(causal)), float(scale))
    if path == "general":
        dims += (_DTYPES[q.dtype],)
    lib = _build.load_library()
    dq_fn, dkdv_fn = ((lib.flash_attention_bwd_tc_dq,
                       lib.flash_attention_bwd_tc_dkdv) if path == "tc" else
                      (lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkdv))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = dq_fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            kl, *dims, stream)
        _build.check(lib, err, f"flash_attention backward launch (dq, {path})")
        flash_attention.backward_launches["dq"] += 1
        err = dkdv_fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            kl, *dims, stream)
        _build.check(lib, err,
                     f"flash_attention backward launch (dkdv, {path})")
        flash_attention.backward_launches["dkdv"] += 1
    flash_attention.backward_launches_by_path[path] += 1
    return dq, dk, dv
