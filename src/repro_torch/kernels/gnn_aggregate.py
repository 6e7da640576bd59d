"""Sparse neighbour sum: the GNN aggregation (K1) on the card.

The counterpart of ``repro/kernels/gnn_aggregate.py``.  The reference chops
the adjacency into dense (bm, bk) link blocks; only nonempty blocks are
stored, each multiplied against the (bk, d) feature tile its ``block_cols``
entry names.  GLAD's layout and the plan's hub-first slotting concentrate
links in few blocks, so block density is a function of layout quality.

Dense layout (a leading partition axis P is optional everywhere):
  values     (P, n_dst_blocks * max_blocks, bm, bk) f32  dense link blocks
  block_cols (P, n_dst_blocks, max_blocks) int32         source block-row
                                                         (0 pad; pad values 0)
  feats      (P, n_src_blocks * bk, d) f32
  out        (P, n_dst_blocks * bm, d) f32

Packed layout (:class:`PackedBSR`, made by :func:`pack_bsr`): the same
matrix with only its nonzeros, row-compressed per partition.  Within a
destination row the nonzeros keep the order in which the dense product
visits them (stored block ``j``, then ``k`` ascending); exact zeros and
padded blocks are dropped.

Kernel.  :func:`spmm_packed` replaces the Pallas TPU kernel ``spmm``
(``src/repro/kernels/gnn_aggregate.py:54-94``, ``pallas_call`` at line 77)
with ``csrc/spmm_csr.cu``, written by hand for Hopper (``sm_90a``).  A
random layout leaves the stored blocks 99.9% zeros, so the kernel multiplies
the packed nonzeros only: one warp per destination row, a lane per feature
column, the feature rows of a batch of nonzeros loaded before any is
consumed.  Each output element is one thread's fmaf chain in the packed
order: no atomics, the same bits run to run.  Its least time is set by
bytes: the nonzeros, the row pointers, the feature table and the output,
each once; the operations (2 * nnz * d) are far below the fp32 rate.

Backward.  :func:`spmm_packed` is a ``torch.autograd.Function``.  Its
gradient with respect to the features is Aᵀ·g: the same product over the
transposed operand (:func:`transpose_packed`, made on the host once per
operand; the caller may pass it in), so on the card it is the same kernel
and, like the forward, a fixed fmaf chain per output element with no
atomics.  The link weights are constants of the plan: a ``w`` that requires
grad raises.

Dispatch.  :func:`spmm_packed` and :func:`spmm` send a CPU tensor to the
plain version (:func:`spmm_packed_plain`, :func:`spmm_plain`), in both
directions.  A CUDA tensor goes to the kernel or the call raises; there is
no fallback.  On the card :func:`spmm` packs (on the host) and then launches
the kernel.  ``spmm.launches`` counts kernel launches, and
``spmm.launches_by_dir`` splits them into forward (``"fwd"``) and backward
(``"bwd"``) products.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels import _build


def spmm_plain(values, block_cols, feats, bm: int, bk: int):
    """Plain torch execution of the dense BSR layout: one gather of (bk, d)
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
    """Block-sparse A @ H on the dense layout (the reference's ``spmm``).
    CPU tensors take :func:`spmm_plain`; CUDA tensors are packed by
    :func:`pack_bsr` and go through :func:`spmm_packed` (one launch for all
    partitions), or the call raises."""
    if feats.device.type == "cpu":
        return spmm_plain(values, block_cols, feats, bm, bk)
    if feats.device.type != "cuda":
        raise ValueError(f"spmm: unsupported device {feats.device}")
    for name, t in (("values", values), ("block_cols", block_cols)):
        if t.device != feats.device:
            raise ValueError(f"spmm: {name} on {t.device}, feats on "
                             f"{feats.device}")
    if block_cols.dim() != feats.dim() or feats.dim() not in (2, 3):
        raise ValueError("spmm: block_cols and feats must both be batched "
                         "(3-D) or both unbatched (2-D)")
    lead = tuple(block_cols.shape[:-2])
    nb, maxb = block_cols.shape[-2:]
    if tuple(values.shape) != lead + (nb * maxb, bm, bk):
        raise ValueError(f"spmm: values {tuple(values.shape)} != "
                         f"{lead + (nb * maxb, bm, bk)}")
    if feats.shape[-2] % bk:
        raise ValueError(f"spmm: feats rows {feats.shape[-2]} not a multiple "
                         f"of bk={bk}")
    return spmm_packed(pack_bsr(values, block_cols, bm, bk), feats)


spmm.launches = 0
spmm.launches_by_dir = {"fwd": 0, "bwd": 0}
tracing.register(spmm, "launches")
tracing.register(spmm, "launches_by_dir")


# ------------------------------------------------------------ packed operand
@dataclasses.dataclass
class PackedBSR:
    """A BSR's nonzeros, row-compressed per partition (the kernel's operand).

    Row ``r`` of partition ``p`` owns entries ``row_ptr[p, r]`` up to
    ``row_ptr[p, r + 1]`` of ``col``/``w``; entries past ``row_ptr[p, -1]``
    are ``col = 0``, ``w = 0`` and are never read.  Fields are numpy arrays
    or torch tensors, as :func:`pack_bsr` was given."""

    row_ptr: Any            # (P, n_rows + 1) int32
    col: Any                # (P, nnz_cap) int32: feature-table row
    w: Any                  # (P, nnz_cap) f32: link weight
    src_rows: int           # the feature table needs at least these rows
    n_rows: int             # destination rows per partition

    @property
    def nnz_cap(self) -> int:
        return int(self.col.shape[1])

    def to(self, device) -> "PackedBSR":
        """The same operand as torch tensors on ``device``."""
        return dataclasses.replace(
            self, **{f: torch.as_tensor(getattr(self, f)).to(device)
                     for f in ("row_ptr", "col", "w")})


def pack_bsr(values, block_cols, bm: int, bk: int,
             nnz_cap: Optional[int] = None) -> PackedBSR:
    """Pack a dense-layout BSR (numpy arrays or torch tensors, with or
    without the leading P axis) into a :class:`PackedBSR` of the same kind,
    always with a P axis.  ``nnz_cap`` (default: the largest partition's
    nonzero count) sets the entry arrays' width; a partition with more
    nonzeros raises.  Tensors are packed on the host and the operand goes
    back to their device: the pack runs once per plan or graph, not per
    product."""
    if isinstance(values, torch.Tensor):
        return _pack_numpy(values.cpu().numpy(),
                           torch.as_tensor(block_cols).cpu().numpy(), bm, bk,
                           nnz_cap).to(values.device)
    return _pack_numpy(np.asarray(values), np.asarray(block_cols), bm, bk,
                       nnz_cap)


def _pack_numpy(values, block_cols, bm, bk, nnz_cap):
    if block_cols.ndim == 2:
        values, block_cols = values[None], block_cols[None]
    P, nb, maxb = block_cols.shape
    n_rows = nb * bm
    vals = np.ascontiguousarray(values).reshape(P, nb, maxb, bm, bk)
    # The scan over every stored entry is the pack's cost.  numpy finds the
    # set entries of a boolean mask about ten times as fast as the nonzeros
    # of a float array, and a mask of 1M entries at a time is reused from
    # the heap, where one of the whole array is faulted in afresh per call.
    flat, step = vals.reshape(-1), 1 << 20
    hits = np.concatenate([np.zeros(0, np.intp)] + [
        np.flatnonzero(flat[s:s + step] != 0) + s
        for s in range(0, flat.size, step)])
    p, i, j, r, k = np.unravel_index(hits, vals.shape)
    row = (p * nb + i) * bm + r
    order = np.argsort(row, kind="stable")        # keeps (j, k) in a row
    p, i, j, r, k, row = (a[order] for a in (p, i, j, r, k, row))
    counts = np.bincount(row, minlength=P * n_rows).reshape(P, n_rows)
    per_part = counts.sum(axis=1)
    cap = _nnz_cap(per_part, nnz_cap)
    row_ptr = np.zeros((P, n_rows + 1), np.int32)
    np.cumsum(counts, axis=1, out=row_ptr[:, 1:])
    e = np.arange(len(row)) - np.concatenate([[0], np.cumsum(per_part)])[p]
    col = np.zeros((P, cap), np.int32)
    w = np.zeros((P, cap), np.float32)
    col[p, e] = block_cols[p, i, j].astype(np.int64) * bk + k
    w[p, e] = vals[p, i, j, r, k]
    return PackedBSR(row_ptr, col, w, _src_rows(block_cols, bk), n_rows)


def _nnz_cap(per_part: np.ndarray, nnz_cap: Optional[int]) -> int:
    need = int(per_part.max()) if per_part.size else 0
    if nnz_cap is None:
        return need
    if need > nnz_cap:
        raise ValueError(f"pack_bsr: a partition holds {need} nonzeros, "
                         f"more than nnz_cap={nnz_cap}")
    return int(nnz_cap)


def _src_rows(block_cols, bk: int) -> int:
    """Feature-table rows the operand may read: through the last block
    that ``block_cols`` names."""
    flat = block_cols.reshape(-1)
    return (int(flat.max()) + 1) * bk if len(flat) else bk


def spmm_packed_plain(packed: PackedBSR, feats):
    """Plain torch execution of the packed layout: an ``index_select`` of
    the feature rows by ``col``, times ``w``, then a sum per destination
    row.  The entries are already sorted by row, so the sum is
    ``segment_reduce`` over the row lengths, the deterministic segment sum
    of ``gnn.models.sorted_segment_sum`` without its sort.  Entries past
    ``row_ptr[p, -1]`` are never read.  It sums in fp32, or in fp64 for
    fp64 features."""
    batched = feats.dim() == 3
    if not batched:
        feats = feats[None]
    P, src_rows, d = feats.shape
    row_ptr, col, w = (torch.as_tensor(a).to(feats.device)
                       for a in (packed.row_ptr, packed.col, packed.w))
    live = (torch.arange(col.shape[1], device=feats.device)[None, :]
            < row_ptr[:, -1:])
    part = torch.arange(P, device=feats.device)[:, None]
    src = (part * src_rows + col.long())[live]
    acc = torch.promote_types(feats.dtype, torch.float32)
    msgs = (feats.reshape(P * src_rows, d).to(acc).index_select(0, src)
            * w[live].to(acc)[:, None])
    lengths = (row_ptr[:, 1:] - row_ptr[:, :-1]).reshape(-1).long()
    out = torch.segment_reduce(msgs, "sum", lengths=lengths, axis=0)
    out = out.reshape(P, packed.n_rows, d).to(feats.dtype)
    return out if batched else out[0]


def spmm_packed(packed: PackedBSR, feats,
                transposed: Optional[PackedBSR] = None):
    """out[p, r] = sum over row r's entries e of w[p, e] * feats[p, col[p, e]].

    ``feats`` is (P, rows, d), or (rows, d) for a P = 1 operand, with
    ``rows >= packed.src_rows``.  CPU tensors take
    :func:`spmm_packed_plain`; CUDA tensors launch the ``spmm_csr`` kernel
    (one launch for all partitions) or raise.  Differentiable in ``feats``:
    the backward is the same product over ``transposed``
    (:func:`transpose_packed` of ``packed`` at ``rows`` rows), made from
    ``packed`` when the backward first needs it if not given."""
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spmm_packed: unsupported device {feats.device}")
    if (torch.is_grad_enabled() and isinstance(packed.w, torch.Tensor)
            and packed.w.requires_grad):
        raise RuntimeError("spmm_packed: no gradient with respect to the "
                           "link weights w (they are constants of the plan)")
    if transposed is not None and transposed.n_rows != feats.shape[-2]:
        raise ValueError(f"spmm_packed: the transposed operand has "
                         f"{transposed.n_rows} rows, feats {feats.shape[-2]}")
    return _SpmmPacked.apply(feats, packed, transposed)


class _SpmmPacked(torch.autograd.Function):
    """A·feats forward, Aᵀ·g backward, both through :func:`_product`."""

    @staticmethod
    def forward(ctx, feats, packed, transposed):
        ctx.packed, ctx.transposed = packed, transposed
        ctx.rows = feats.shape[-2]
        return _product(packed, feats, "fwd")

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        if ctx.transposed is None:
            ctx.transposed = transpose_packed(ctx.packed, ctx.rows)
        return _product(ctx.transposed, g.contiguous(), "bwd"), None, None


def _product(packed: PackedBSR, feats, direction: str):
    if feats.device.type == "cpu":
        return spmm_packed_plain(packed, feats)
    return _spmm_packed_cuda(packed, feats, direction)


def transpose_packed(packed: PackedBSR, n_rows: int) -> PackedBSR:
    """Aᵀ of a packed operand, of the same kind (numpy arrays, or tensors on
    the operand's device; made on the host).

    Its rows are the forward's feature-table rows: ``n_rows`` of them, the
    height of the table the forward is given (at least
    ``packed.src_rows``).  Its columns are the forward's destination rows,
    so it reads a (P, packed.n_rows, d) gradient.  Within each row the
    entries are sorted by destination row, which fixes the order of every
    sum; ``nnz_cap`` is unchanged, so an operand refreshed by a value-only
    patch keeps its shapes."""
    if n_rows < packed.src_rows:
        raise ValueError(f"transpose_packed: {n_rows} rows < the operand's "
                         f"src_rows {packed.src_rows}")
    if isinstance(packed.col, torch.Tensor):
        host = PackedBSR(*(getattr(packed, f).cpu().numpy()
                           for f in ("row_ptr", "col", "w")),
                         packed.src_rows, packed.n_rows)
        return transpose_packed(host, n_rows).to(packed.col.device)
    row_ptr, col, w = (np.asarray(a) for a in (packed.row_ptr, packed.col,
                                                packed.w))
    P, cap = col.shape
    p, e = np.nonzero(np.arange(cap)[None, :] < row_ptr[:, -1:])
    dst = np.repeat(np.tile(np.arange(packed.n_rows), P),
                    np.diff(row_ptr, axis=1).reshape(-1))   # entry's row
    c = col[p, e].astype(np.int64)
    if c.size and int(c.max()) >= n_rows:
        raise ValueError(f"transpose_packed: a column {int(c.max())} >= "
                         f"n_rows {n_rows}")
    order = np.argsort(p * n_rows + c, kind="stable")  # keeps dst order
    p, c, dst, wv = p[order], c[order], dst[order], w[p, e][order]
    counts = np.bincount(p * n_rows + c, minlength=P * n_rows).reshape(
        P, n_rows)
    row_ptr_t = np.zeros((P, n_rows + 1), np.int32)
    np.cumsum(counts, axis=1, out=row_ptr_t[:, 1:])
    per_part = row_ptr_t[:, -1].astype(np.int64)
    slot = np.arange(len(p)) - np.concatenate([[0], np.cumsum(per_part)])[p]
    col_t = np.zeros((P, cap), np.int32)
    w_t = np.zeros((P, cap), np.float32)
    col_t[p, slot] = dst
    w_t[p, slot] = wv
    return PackedBSR(row_ptr_t, col_t, w_t, packed.n_rows, n_rows)


def _spmm_packed_cuda(packed: PackedBSR, feats, direction: str):
    batched = feats.dim() == 3
    if not batched:
        feats = feats[None]
    if feats.dim() != 3:
        raise ValueError(f"spmm_packed: feats {tuple(feats.shape)} is not "
                         "(P, rows, d) or (rows, d)")
    for name, t, dtype in (("row_ptr", packed.row_ptr, torch.int32),
                           ("col", packed.col, torch.int32),
                           ("w", packed.w, torch.float32),
                           ("feats", feats, torch.float32)):
        if not isinstance(t, torch.Tensor) or t.device != feats.device:
            raise ValueError(f"spmm_packed: {name} is not a tensor on "
                             f"{feats.device}")
        if t.dtype != dtype:
            raise TypeError(f"spmm_packed: {name} is {t.dtype}, the kernel "
                            f"takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"spmm_packed: {name} is not contiguous")
    P, src_rows, d = feats.shape
    n_rows, cap = packed.n_rows, packed.nnz_cap
    if (packed.row_ptr.shape != (P, n_rows + 1)
            or packed.col.shape != (P, cap) or packed.w.shape != (P, cap)
            or src_rows < packed.src_rows):
        raise ValueError(
            f"spmm_packed: row_ptr {tuple(packed.row_ptr.shape)}, col "
            f"{tuple(packed.col.shape)}, w {tuple(packed.w.shape)} and feats "
            f"{tuple(feats.shape)} do not fit P={P}, n_rows={n_rows}, "
            f"src_rows>={packed.src_rows}")
    out = torch.empty((P, n_rows, d), dtype=torch.float32,
                      device=feats.device)
    if out.numel():
        lib = _build.load_library()
        with torch.cuda.device(feats.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.spmm_csr_f32(
                packed.row_ptr.data_ptr(), packed.col.data_ptr(),
                packed.w.data_ptr(), feats.data_ptr(), out.data_ptr(), P,
                n_rows, cap, src_rows, d, stream)
        _build.check(lib, err, "spmm_csr launch")
        spmm.launches += 1
        spmm.launches_by_dir[direction] += 1
    return out if batched else out[0]


# --------------------------------------------------------------- host packing
def build_bsr(
    src_dst: np.ndarray,
    weights: np.ndarray | None,
    n: int,
    bm: int = 8,
    bk: int = 128,
):
    """Pack a directed edge list into the dense BSR layout.

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
