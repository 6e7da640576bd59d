"""Plain torch oracles for the port's kernels (the correctness contract).

Loop-for-loop copies of ``repro.kernels.ref``: slow, obviously right, and
independent of the kernels and of their vectorised plain versions.
"""
from __future__ import annotations

import torch


# ------------------------------------------------------- gnn_aggregate (SpMM)
def spmm_ref(values, block_cols, feats, bm: int, bk: int):
    """Block-sparse A @ H oracle.

    values:     (n_dst_blocks * max_blocks, bm, bk) dense link blocks
    block_cols: (n_dst_blocks, max_blocks) source block-row ids (0 pad; padded
                entries have all-zero values so they contribute nothing)
    feats:      (n_src_blocks * bk, d)
    Returns (n_dst_blocks * bm, d).
    """
    n_dst_blocks, max_blocks = block_cols.shape
    d = feats.shape[1]
    out = feats.new_zeros((n_dst_blocks * bm, d))
    vals = values.reshape(n_dst_blocks, max_blocks, bm, bk)
    for i in range(n_dst_blocks):
        acc = torch.zeros((bm, d), dtype=torch.float32, device=feats.device)
        for j in range(max_blocks):
            src = int(block_cols[i, j])
            blk = feats[src * bk:(src + 1) * bk]
            acc = acc + vals[i, j].to(torch.float32) @ blk.to(torch.float32)
        out[i * bm:(i + 1) * bm] = acc.to(feats.dtype)
    return out


def segment_sum_ref(messages, dst, n: int):
    """Edge-list aggregation oracle: sum messages per destination."""
    out = messages.new_zeros((n,) + tuple(messages.shape[1:]))
    return out.index_add_(0, dst.long(), messages)


# -------------------------------------------------------------- flash attention
def attention_ref(q, k, v, causal: bool = True, scale: float | None = None,
                  kv_len: torch.Tensor | None = None):
    """Reference softmax attention.

    q: (B, Hq, Lq, D); k/v: (B, Hkv, Lk, D).  GQA: Hq % Hkv == 0, each kv head
    serves Hq/Hkv query heads.  ``kv_len`` optionally masks the KV suffix
    (decode with a padded cache).  A fully masked row gives NaN, as the
    reference's does; the kernel and its plain version give 0 there.
    """
    B, Hq, Lq, D = q.shape
    Hkv = k.shape[1]
    rep = Hq // Hkv
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    Lk = k.shape[2]
    if causal:
        qi = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
        ki = torch.arange(Lk, device=q.device)[None, :]
        logits = torch.where(ki <= qi, logits, float("-inf"))
    if kv_len is not None:
        ki = torch.arange(Lk, device=q.device)
        mask = ki[None, None, None, :] < kv_len[:, None, None, None]
        logits = torch.where(mask, logits, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)
