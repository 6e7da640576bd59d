"""Sorted segment sum (K3): the GNN path's deterministic sum per destination.

Given a row per message and, for the messages' destinations ``dst``, the
stable argsort ``order``, the destinations in that order ``keys``
(ascending) and ``offsets`` (the exclusive prefix of the ``n`` segment
lengths, then their total ``E``), :func:`segment_sum` returns
``out[s] = sum of messages[order[j]] for j in [offsets[s], offsets[s+1])``,
(n, ...) for (E, ...) messages; an empty segment gives 0.  On the card it
is the segment sum of ``gnn.models.sorted_segment_sum``: the GAT layers'
sums over a plan's edge table and every ``gather_rows`` adjoint.

Kernel.  K3 replaces no TPU kernel: the reference sums with
``jax.ops.segment_sum``, which XLA lowers itself.  It was written because
the library's deterministic sum, ``torch.segment_reduce``, walks each
(segment, column) on one thread, and a plan's padded arcs put 33,000 to
100,000 messages into each partition's dummy segment.
``csrc/segment_sum.cu`` splits the sorted positions into tiles of
:data:`TILE` messages instead: a segment inside a tile is summed by one
owner (in sorted order, lanes on columns, for d >= 3; by a fixed segmented
scan over chunks of 32 messages, lanes on messages, for d <= 2), a segment
cut by tile boundaries leaves one partial per tile, and a second launch
adds those partials in tile order and writes the empty segments' zeros.
The association is fixed by E, d and :data:`TILE` alone, and there are no
atomics: the same bits run to run and in a CUDA graph's replays.  It reads
``messages[order[j]]`` directly (no sorted copy) and reads nothing back to
the host.  Its least time is set by bytes: each message row with its
order, the offsets and the output, each once; it reads ``keys`` besides,
which a search of ``offsets`` could replace but at more latency than the
bytes cost (``csrc/segment_sum.cu``).

Backward.  :func:`segment_sum` is a ``torch.autograd.Function``: the
adjoint of a sum over ``dst`` is the output's gradient gathered by
``dst``, a parallel gather with no sum.

Dispatch.  A CUDA tensor launches K3 or raises; there is no fallback.
Anything else takes the plain version (:func:`segment_sum_plain`, the
gather by ``order`` and ``segment_reduce``; meta tensors for shapes).
:func:`segment_sum_tiles_plain` repeats the kernel's association in plain
torch, for the tests.  ``segment_sum.launches`` counts the kernel's sums
(two launches each), ``segment_sum.launches_by_path`` splits them into
orders given by the caller (``"plan"``: made on the host by
``gnn.models.segment_order``) and orders sorted on the card (``"device"``).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch import tracing
from repro_torch.kernels import _build

TILE = 256          # sorted positions a tile (kTile in csrc/segment_sum.cu)
_PATHS = ("plan", "device")


def segment_sum_plain(messages, order, offsets):
    """Plain torch: the messages gathered by ``order``, then
    ``segment_reduce`` over ``offsets``, which sums each segment in sorted
    order."""
    return torch.segment_reduce(messages.index_select(0, order), "sum",
                                offsets=offsets, axis=0, unsafe=True)


def segment_sum_tiles_plain(messages, order, keys, offsets):
    """K3's association in plain torch: on float32 inputs its result is the
    kernel's bit for bit.  Tiles of :data:`TILE` sorted positions; in a tile
    each segment's run is summed in sorted order from 0 (d >= 3) or by the
    kernel's segmented scan over chunks of 32 positions, then the carry
    from the chunk before (d <= 2); each segment's runs are then added in
    tile order, from 0."""
    n, E = offsets.shape[0] - 1, order.shape[0]
    rest = tuple(messages.shape[1:])
    if E == 0:
        return messages.new_zeros((n,) + rest)
    x = messages.reshape(E, -1).index_select(0, order)
    d = x.shape[1]
    pos = torch.arange(E, device=x.device)
    prev = torch.cat([keys.new_full((1,), -1), keys[:-1]])
    nxt = torch.cat([keys[1:], keys.new_full((1,), -1)])
    start = torch.nonzero((pos % TILE == 0) | (prev != keys))[:, 0]
    end = (pos % TILE == TILE - 1) | (nxt != keys)
    if d > 2:
        lengths = torch.diff(start, append=start.new_full((1,), E))
        runs = torch.segment_reduce(x, "sum", lengths=lengths, axis=0)
    else:
        runs = _scanned(x, keys)[end]
    run_keys = keys[start]
    seg = torch.searchsorted(run_keys, torch.arange(n + 1, device=x.device))
    out = torch.segment_reduce(runs, "sum", offsets=seg, axis=0)
    return out.reshape((n,) + rest)


def _scanned(x, keys):
    """Every sorted position's value after the d <= 2 kernel's scan: the
    inclusive sum of its segment's positions so far in the tile."""
    E, d = x.shape
    tiles = -(-E // TILE)
    pad = tiles * TILE - E
    s = torch.cat([x, x.new_zeros((pad, d))]).reshape(tiles, -1, 32, d)
    k = torch.cat([keys, keys.new_full((pad,), -1)]).reshape(tiles, -1, 32)
    for dist in (1, 2, 4, 8, 16):
        y = torch.zeros_like(s)
        y[:, :, dist:] = s[:, :, :-dist]
        ky = torch.full_like(k, -2)
        ky[:, :, dist:] = k[:, :, :-dist]
        s = torch.where((ky == k)[..., None], s + y, s)
    for c in range(1, s.shape[1]):
        same = (k[:, c] == k[:, c - 1, 31:])[..., None]
        s[:, c] = torch.where(same, s[:, c] + s[:, c - 1, 31:], s[:, c])
    return s.reshape(-1, d)[:E]


def segment_sum(messages, dst, order, keys, offsets, path: str = "plan"):
    """Sum ``messages`` (E, ...) into the ``offsets.shape[0] - 1`` segments
    of ``dst``, given its stable argsort ``order``, the sorted ``keys`` and
    the segments' ``offsets`` (int64).  ``path`` names where the order was
    made (``"plan"``: the host; ``"device"``: a sort on the card), for the
    launch counts.  Differentiable in ``messages`` (a gather by ``dst``)."""
    if path not in _PATHS:
        raise ValueError(f"segment_sum: path {path!r} is not one of "
                         f"{_PATHS}")
    return _SegmentSum.apply(messages, dst, order, keys, offsets, path)


segment_sum.launches = 0
segment_sum.launches_by_path = dict.fromkeys(_PATHS, 0)
tracing.register(segment_sum, "launches")
tracing.register(segment_sum, "launches_by_path")


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, messages, dst, order, keys, offsets, path):
        ctx.save_for_backward(dst)
        if messages.device.type == "cuda":
            return _segment_sum_cuda(messages, order, keys, offsets, path)
        return segment_sum_plain(messages, order, offsets)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 6
        dst, = ctx.saved_tensors
        return (g.index_select(0, dst),) + (None,) * 5


@functools.cache
def load():
    """The kernel library, its tile checked against :data:`TILE`.  Called
    at the first eager call or ahead of it (the plan tensors on a card),
    never first inside a capture."""
    lib = _build.load_library()
    if lib.segment_sum_tile() != TILE:
        raise RuntimeError(f"segment_sum: the kernel's tile is "
                           f"{lib.segment_sum_tile()}, the wrapper's {TILE}")
    return lib


def check_operands(messages, order, keys, offsets):
    """The kernel's operands checked as it takes them: float32 messages
    (E, ...), int64 ``order`` and ``keys`` (E,) and ``offsets`` (n + 1,),
    contiguous, on one device, fewer than 2^31 outputs; raises otherwise.
    Returns (E, n, d), d the width of a message row."""
    if messages.dim() < 1:
        raise ValueError("segment_sum: messages must have a row axis")
    E = messages.shape[0]
    for name, t, dtype in (("messages", messages, torch.float32),
                           ("order", order, torch.int64),
                           ("keys", keys, torch.int64),
                           ("offsets", offsets, torch.int64)):
        if not isinstance(t, torch.Tensor) or t.device != messages.device:
            raise ValueError(f"segment_sum: {name} is not a tensor on "
                             f"{messages.device}")
        if t.dtype != dtype:
            raise TypeError(f"segment_sum: {name} is {t.dtype}, the kernel "
                            f"takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"segment_sum: {name} is not contiguous")
    if (order.shape != (E,) or keys.shape != (E,) or offsets.dim() != 1
            or offsets.shape[0] < 1):
        raise ValueError(
            f"segment_sum: order {tuple(order.shape)}, keys "
            f"{tuple(keys.shape)} and offsets {tuple(offsets.shape)} do not "
            f"fit {E} messages into segments")
    n, d = offsets.shape[0] - 1, math.prod(messages.shape[1:])
    if n * d >= 2 ** 31:
        raise ValueError(f"segment_sum: {n} x {d} outputs, the kernel takes "
                         "fewer than 2^31")
    return E, n, d


def _segment_sum_cuda(messages, order, keys, offsets, path):
    E, n, d = check_operands(messages, order, keys, offsets)
    out = torch.empty((n,) + tuple(messages.shape[1:]), dtype=torch.float32,
                      device=messages.device)
    if out.numel():
        part = torch.empty((2 * -(-E // TILE), d), dtype=torch.float32,
                           device=messages.device)
        lib = load()
        with torch.cuda.device(messages.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.segment_sum_f32(
                messages.data_ptr(), order.data_ptr(), keys.data_ptr(),
                offsets.data_ptr(), out.data_ptr(), part.data_ptr(), E, n, d,
                stream)
        _build.check(lib, err, "segment_sum launch")
        segment_sum.launches += 1
        segment_sum.launches_by_path[path] += 1
    return out
