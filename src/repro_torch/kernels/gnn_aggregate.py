"""Block-sparse SpMM: the GNN neighbour sum on the card.

The counterpart of ``repro/kernels/gnn_aggregate.py``.  The adjacency is
chopped into dense (bm, bk) link blocks; only nonempty blocks are stored,
each one multiplied against the (bk, d) feature tile its ``block_cols`` entry
names.  GLAD's layout and the plan's hub-first slotting concentrate links in
few blocks, so block density is a function of layout quality.

Layout (a leading partition axis P is optional everywhere):
  values     (P, n_dst_blocks * max_blocks, bm, bk) f32  dense link blocks
  block_cols (P, n_dst_blocks, max_blocks) int32         source block-row
                                                         (0 pad; pad values 0)
  feats      (P, n_src_blocks * bk, d) f32
  out        (P, n_dst_blocks * bm, d) f32

Kernel.  :func:`spmm` replaces the Pallas TPU kernel ``spmm``
(``src/repro/kernels/gnn_aggregate.py:54-94``, ``pallas_call`` at line 77)
with ``csrc/spmm_bsr.cu``, written by hand for Hopper (``sm_90a``): one CTA
per (destination block-row, 64-column d-tile, partition), the sequential
block loop inside the CTA with an fp32 register accumulator, fixed block and
k order (deterministic bit for bit), ragged ``d`` masked in the kernel.  Its
least time is set by bytes: the stored ``values``, read once; the operations
the sparse product needs (2 * nnz * d) are far below the fp32 rate.

Dispatch.  A CPU tensor goes to :func:`spmm_plain`, the vectorised torch
mirror of the reference's ``spmm_jnp``.  A CUDA tensor goes to the kernel or
the call raises; there is no fallback.  ``spmm.launches`` counts kernel
launches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build


def spmm_plain(values, block_cols, feats, bm: int, bk: int):
    """Plain torch execution of the BSR layout: one gather of (bk, d)
    feature tiles by ``block_cols`` and one fp32 einsum (the mirror of the
    reference's ``spmm_jnp``).  It may differ from the kernel only in
    summation order."""
    batched = block_cols.dim() == 3
    if not batched:
        values, block_cols, feats = values[None], block_cols[None], feats[None]
    P, n_dst_blocks, max_blocks = block_cols.shape
    d = feats.shape[-1]
    if feats.shape[1] % bk:
        raise ValueError(f"feats rows {feats.shape[1]} not a multiple of {bk}")
    tiles = feats.reshape(P, -1, bk, d)
    part = torch.arange(P, device=feats.device)[:, None, None]
    gathered = tiles[part, block_cols.long()]      # (P, nb, maxb, bk, d)
    vals = values.reshape(P, n_dst_blocks, max_blocks, bm, bk)
    out = torch.einsum("pnmbk,pnmkd->pnbd", vals.to(torch.float32),
                       gathered.to(torch.float32))
    out = out.reshape(P, n_dst_blocks * bm, d).to(feats.dtype)
    return out if batched else out[0]


def spmm(values, block_cols, feats, bm: int, bk: int):
    """Block-sparse A @ H.  CPU tensors take :func:`spmm_plain`; CUDA tensors
    launch the ``spmm_bsr`` kernel (one launch for all partitions) or
    raise."""
    if feats.device.type == "cpu":
        return spmm_plain(values, block_cols, feats, bm, bk)
    if feats.device.type != "cuda":
        raise ValueError(f"spmm: unsupported device {feats.device}")
    return _spmm_cuda(values, block_cols, feats, bm, bk)


spmm.launches = 0


def _spmm_cuda(values, block_cols, feats, bm: int, bk: int):
    batched = block_cols.dim() == 3
    if not batched:
        values, block_cols, feats = values[None], block_cols[None], feats[None]
    for name, t, dtype in (("values", values, torch.float32),
                           ("block_cols", block_cols, torch.int32),
                           ("feats", feats, torch.float32)):
        if t.device != feats.device:
            raise ValueError(f"spmm: {name} on {t.device}, feats on "
                             f"{feats.device}")
        if t.dtype != dtype:
            raise TypeError(f"spmm: {name} is {t.dtype}, kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"spmm: {name} is not contiguous")
    if block_cols.dim() != 3 or feats.dim() != 3:
        raise ValueError("spmm: block_cols and feats must both be batched "
                         "(3-D) or both unbatched (2-D)")
    P, nb, maxb = block_cols.shape
    src_rows, d = feats.shape[1], feats.shape[2]
    if values.shape != (P, nb * maxb, bm, bk):
        raise ValueError(f"spmm: values {tuple(values.shape)} != "
                         f"{(P, nb * maxb, bm, bk)}")
    if feats.shape[0] != P or src_rows % bk or not 1 <= bm <= 32:
        raise ValueError(f"spmm: feats {tuple(feats.shape)}, bm={bm}, bk={bk}")
    out = torch.empty((P, nb * bm, d), dtype=torch.float32,
                      device=feats.device)
    if out.numel():
        lib = _build.load_library()
        with torch.cuda.device(feats.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.spmm_bsr_f32(values.data_ptr(), block_cols.data_ptr(),
                                   feats.data_ptr(), out.data_ptr(), P, nb,
                                   maxb, bm, bk, src_rows, d, stream)
        _build.check(lib, err, "spmm_bsr launch")
        spmm.launches += 1
    return out if batched else out[0]


# --------------------------------------------------------------- host packing
def build_bsr(
    src_dst: np.ndarray,
    weights: np.ndarray | None,
    n: int,
    bm: int = 8,
    bk: int = 128,
):
    """Pack a directed edge list into the kernel's BSR layout.

    Returns (values, block_cols, n_pad) where n_pad = rows padded to
    lcm-friendly multiples of bm (dst) and bk (src).  Padded blocks carry
    zero weights and column 0 — they multiply the first feature tile by zero,
    keeping the grid rectangular with no masking logic in the kernel.
    """
    if weights is None:
        weights = np.ones(len(src_dst), dtype=np.float32)
    n_dst_pad = max(bm, ((n + bm - 1) // bm) * bm)
    n_src_pad = max(bk, ((n + bk - 1) // bk) * bk)
    n_dst_blocks = n_dst_pad // bm

    by_block: dict[tuple[int, int], np.ndarray] = {}
    if len(src_dst):
        ib = src_dst[:, 1] // bm           # dst block
        jb = src_dst[:, 0] // bk           # src block
        order = np.lexsort((jb, ib))
        s = src_dst[order]
        w = weights[order]
        ib, jb = ib[order], jb[order]
        bounds = np.flatnonzero(np.diff(ib * (n_src_pad // bk + 1) + jb)) + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [len(s)]])
        for a, b in zip(starts, ends):
            key = (int(ib[a]), int(jb[a]))
            blk = np.zeros((bm, bk), np.float32)
            rows = s[a:b, 1] - key[0] * bm
            cols = s[a:b, 0] - key[1] * bk
            np.add.at(blk, (rows, cols), w[a:b])
            by_block[key] = blk

    per_row: list[list[tuple[int, np.ndarray]]] = [[] for _ in range(n_dst_blocks)]
    for (i, j), blk in by_block.items():
        per_row[i].append((j, blk))
    max_blocks = max(1, max((len(r) for r in per_row), default=1))

    values = np.zeros((n_dst_blocks * max_blocks, bm, bk), np.float32)
    block_cols = np.zeros((n_dst_blocks, max_blocks), np.int32)
    for i, row in enumerate(per_row):
        for k, (j, blk) in enumerate(sorted(row)):
            values[i * max_blocks + k] = blk
            block_cols[i, k] = j
    return values, block_cols, n_dst_pad, n_src_pad


def bsr_density(block_cols: np.ndarray, values: np.ndarray) -> float:
    """Fraction of nonzero entries within stored blocks (MXU efficiency)."""
    stored = values.size
    nnz = int((values != 0).sum())
    return nnz / max(stored, 1)
