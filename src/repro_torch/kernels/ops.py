"""Public wrappers around the port's kernels.

The counterpart of ``repro/kernels/ops.py`` for both kernels: attention (K2)
and the block-sparse aggregation (K1).  The wrappers are the only entry
points the rest of the port uses, so swapping the execution path never
touches model code.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_plain)
from repro_torch.kernels.gnn_aggregate import (
    build_bsr, pack_bsr, spmm_packed, spmm_plain, transpose_packed)

_IMPLS = ("auto", "kernel", "plain", "ref")


# ----------------------------------------------------------------- attention
def attention(q, k, v, kv_len=None, *, causal: bool = True,
              scale: Optional[float] = None, impl: str = "auto"):
    """q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D) -> (B, Hq, Lq, D).

    ``impl``: 'kernel' (K2; CUDA tensors only), 'plain' (its torch version),
    'ref' (the repeat-then-softmax oracle, NaN on a fully masked row), or
    'auto' (the kernel for CUDA tensors, plain for CPU tensors)."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {_IMPLS}")
    if impl == "kernel" and q.device.type != "cuda":
        raise ValueError("impl='kernel' needs a CUDA tensor")
    if impl in ("auto", "kernel"):
        return flash_attention(q, k, v, kv_len, causal=causal, scale=scale)
    if impl == "plain":
        return flash_attention_plain(q, k, v, kv_len, causal, scale)
    return _ref.attention_ref(q, k, v, causal=causal, scale=scale,
                              kv_len=kv_len)


# --------------------------------------------------------------- aggregation
class BSRAggregate:
    """Precompiled block-sparse aggregation bound to a fixed graph.

    Usage: build once per (graph, ordering), then call on feature matrices
    (weights=1: plain neighbour sum).  The dense BSR tables, their packed
    nonzeros (:func:`pack_bsr`) and the transpose of those over the
    ``n_src_pad``-row feature table (the backward's operand,
    :func:`transpose_packed`), made once here, live on ``device``.
    """

    def __init__(self, src_dst: np.ndarray, n: int, bm: int = 8,
                 bk: int = 128, weights: Optional[np.ndarray] = None,
                 device: DeviceLike = "cuda"):
        self.n = n
        self.bm, self.bk = bm, bk
        self.device = resolve_device(device)
        vals, cols, self.n_dst_pad, self.n_src_pad = build_bsr(
            np.asarray(src_dst), weights, n, bm, bk)
        self.values = torch.from_numpy(vals).to(self.device)
        self.block_cols = torch.from_numpy(cols).to(self.device)
        packed = pack_bsr(vals, cols, bm, bk)
        self.packed = packed.to(self.device)
        self.packed_t = transpose_packed(packed, self.n_src_pad).to(
            self.device)
        self.stored_blocks = int(cols.size)
        self.nnz_density = float((vals != 0).mean())

    def __call__(self, feats: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        """feats (n, d) -> (n, d) aggregated by incoming links.

        ``impl``: 'kernel' (the CUDA kernel on the packed nonzeros; CUDA
        tensors only), 'plain' (the vectorised torch execution of the dense
        BSR layout), 'ref' (the per-block oracle loop), or 'auto' (the
        kernel for CUDA tensors, the packed layout's plain version for CPU
        tensors).  Ragged ``d`` needs no padding: the kernel masks it."""
        if impl not in _IMPLS:
            raise ValueError(f"unknown impl {impl!r}; expected one of {_IMPLS}")
        if impl == "kernel" and feats.device.type != "cuda":
            raise ValueError("impl='kernel' needs a CUDA tensor")
        x = feats.new_zeros((self.n_src_pad, feats.shape[1]))
        x[: feats.shape[0]] = feats
        if impl in ("auto", "kernel"):
            out = spmm_packed(self.packed, x, self.packed_t)
        elif impl == "plain":
            out = spmm_plain(self.values, self.block_cols, x, self.bm, self.bk)
        else:
            out = _ref.spmm_ref(self.values, self.block_cols, x,
                                self.bm, self.bk)
        return out[: self.n]


def aggregate_features(src_dst: np.ndarray, feats: torch.Tensor, n: int,
                       impl: str = "auto") -> torch.Tensor:
    """One-shot neighbour sum of features, on the device of ``feats``:
    sum_{u in N_v} h_u for all v."""
    agg = BSRAggregate(np.asarray(src_dst), n, device=feats.device)
    return agg(feats, impl=impl)
