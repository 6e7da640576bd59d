"""K3, the sorted segment sum (``repro_torch.kernels.segment_sum``), on the
CPU: the plain mirror of the kernel's association (tile partials in sorted
order, then added in tile order) against ``index_add_`` and a float64 sum
over a plan-sized dummy segment, the operand checks the kernel's wrapper
makes, the plain path's backward (a gather by ``dst``) by gradcheck, the
host-made offsets, and the launch counters.  The kernel itself runs in
``tests/test_torch_cuda.py`` on a card."""
import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.gnn import models as TM
from repro_torch.kernels import segment_sum as K


def _plan_like(rng, d, n=1000, dummy=100_000, live=30_000):
    """Destinations shaped like a plan's edge table: live arcs over the
    first 900 ids (id 500 never used), then ``dummy`` padded arcs into
    segment n - 3; the last two segments stay empty."""
    dst = rng.integers(0, 900, size=live)
    dst[dst == 500] = 501
    dst = np.concatenate([dst, np.full(dummy, n - 3)])
    msgs = rng.standard_normal((len(dst), d)).astype(np.float32)
    return dst, msgs if d > 1 else msgs[:, 0]


@pytest.mark.parametrize("d", [1, 2, 16, 52])
def test_tiles_mirror_matches_index_add(d):
    """The mirror of K3's association against ``index_add_`` and the
    float64 sum, each within 1e-5 of the segment's sum of magnitudes (a
    few hundred fp32 roundings, where the tiled sum's worst case is
    TILE + 392 of them); the plain version bit-equal to ``index_add_``;
    empty and trailing empty segments exactly 0."""
    rng = np.random.default_rng(d)
    n = 1000
    dst, msgs = _plan_like(rng, d, n)
    order, keys, offsets = (torch.from_numpy(a)
                            for a in TM.segment_order(dst, n))
    m, dt = torch.from_numpy(msgs), torch.from_numpy(dst)
    got = K.segment_sum_tiles_plain(m, order, keys, offsets)
    want = torch.zeros((n,) + tuple(m.shape[1:])).index_add_(0, dt, m)
    exact = torch.zeros(want.shape, dtype=torch.float64).index_add_(
        0, dt, m.double())
    mag = torch.zeros(want.shape, dtype=torch.float64).index_add_(
        0, dt, m.double().abs())
    assert int(torch.diff(offsets).max()) == 100_000
    for other in (want.double(), exact):
        assert bool(((got.double() - other).abs() <= 1e-5 * mag).all())
    assert not torch.equal(got, want)          # the long segment is tiled
    assert torch.equal(K.segment_sum_plain(m, order, offsets), want)
    for s in (500, n - 2, n - 1):
        assert not got[s].any() and not mag[s].any()
    assert got.shape == want.shape and got.dtype == torch.float32


def test_tiles_mirror_keeps_edge_order_inside_a_tile():
    """Segments that lie inside one tile are summed in edge order: for
    widths of 3 and more the mirror equals ``index_add_`` bit for bit when
    no segment crosses a tile boundary."""
    rng = np.random.default_rng(7)
    dst = np.repeat(np.arange(64), 8)                   # 8 a segment, 2 a
    msgs = torch.from_numpy(                            # tile's 256 rows
        rng.standard_normal((len(dst), 5)).astype(np.float32))
    perm = rng.permutation(len(dst))
    dst, msgs = dst[perm], msgs[perm]
    order, keys, offsets = (torch.from_numpy(a)
                            for a in TM.segment_order(dst, 64))
    want = torch.zeros(64, 5).index_add_(0, torch.from_numpy(dst), msgs)
    assert torch.equal(K.segment_sum_tiles_plain(msgs, order, keys,
                                                 offsets), want)


def test_tiles_mirror_on_no_messages():
    empty = torch.zeros(0, dtype=torch.int64)
    out = K.segment_sum_tiles_plain(torch.zeros(0, 4), empty, empty,
                                    torch.zeros(6, dtype=torch.int64))
    assert out.shape == (5, 4) and not out.any()


def _operands():
    m = torch.zeros(10, 3)
    idx = torch.arange(10)
    return m, idx, idx.clone(), torch.tensor([0, 4, 10])


@pytest.mark.parametrize("case", [
    "messages_f64", "order_i32", "keys_i32", "offsets_i32",
    "messages_strided", "order_strided", "order_device", "offsets_device",
    "order_short", "keys_short", "offsets_2d", "offsets_empty",
    "messages_scalar", "outputs_past_2_31"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    m, order, keys, offsets = _operands()
    assert K.check_operands(m, order, keys, offsets) == (10, 2, 3)
    bad = {
        "messages_f64": (m.double(), order, keys, offsets, TypeError),
        "order_i32": (m, order.int(), keys, offsets, TypeError),
        "keys_i32": (m, order, keys.int(), offsets, TypeError),
        "offsets_i32": (m, order, keys, offsets.int(), TypeError),
        "messages_strided": (torch.zeros(3, 10).t(), order, keys, offsets,
                             ValueError),
        "order_strided": (m, torch.arange(20)[::2], keys, offsets,
                          ValueError),
        "order_device": (m, order.to("meta"), keys, offsets, ValueError),
        "offsets_device": (m, order, keys, offsets.to("meta"), ValueError),
        "order_short": (m, order[:-1], keys, offsets, ValueError),
        "keys_short": (m, order, keys[1:], offsets, ValueError),
        "offsets_2d": (m, order, keys, offsets[None], ValueError),
        "offsets_empty": (m, order, keys, offsets[:0], ValueError),
        "messages_scalar": (torch.tensor(1.0), order, keys, offsets,
                            ValueError),
        "outputs_past_2_31": (  # shapes alone: meta tensors hold no data
            m.to("meta"), order.to("meta"), keys.to("meta"),
            torch.empty(2 ** 30 + 1, dtype=torch.int64, device="meta"),
            ValueError),
    }[case]
    with pytest.raises(bad[-1], match="segment_sum"):
        K.check_operands(*bad[:-1])


def test_unknown_path_is_refused():
    m, order, keys, offsets = _operands()
    with pytest.raises(ValueError, match="path"):
        K.segment_sum(m, keys, order, keys, offsets, path="host")


@pytest.mark.parametrize("given", [True, False])
def test_plain_backward_is_a_gather_by_dst(given):
    """Gradcheck in float64 of the sum's backward through
    ``sorted_segment_sum``, with the order given (the plan's path) or
    sorted on the device, with empty segments: the gradient of every
    message is its destination's output gradient."""
    rng = np.random.default_rng(3)
    n = 12
    dst = rng.integers(0, n - 3, size=60)
    dst[dst == 4] = 5
    segments = (tuple(torch.from_numpy(a) for a in TM.segment_order(dst, n))
                if given else None)
    dt = torch.from_numpy(dst)
    m = torch.from_numpy(rng.standard_normal((60, 3))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x: TM.sorted_segment_sum(x, dt, n, segments), (m,))
    g = torch.from_numpy(rng.standard_normal((n, 3)))
    got, = torch.autograd.grad(TM.sorted_segment_sum(m, dt, n, segments),
                               m, g)
    assert torch.equal(got, g[dt])


def test_offsets_beside_the_order_are_the_prefix_of_the_lengths():
    """``segment_order``'s offsets (the plan's and the ego batch's path)
    are the exclusive prefix of the per-id counts with the total last,
    over empty and trailing empty ids, and its keys are ``dst`` sorted."""
    rng = np.random.default_rng(5)
    n = 50
    dst = rng.integers(0, 40, size=400)
    dst[dst == 17] = 18
    order, keys, offsets = TM.segment_order(dst, n)
    lengths = np.bincount(dst, minlength=n)
    assert np.array_equal(offsets, np.concatenate([[0], np.cumsum(lengths)]))
    assert offsets[17] == offsets[18] and offsets[40] == offsets[n] == 400
    assert np.array_equal(keys, np.sort(dst, kind="stable"))
    assert np.array_equal(dst[order], keys)
    assert all(a.dtype == np.int64 for a in (order, keys, offsets))
    on_device = torch.searchsorted(torch.from_numpy(keys),
                                   torch.arange(n + 1))
    assert np.array_equal(on_device.numpy(), offsets)


def test_launch_counters_are_registered_and_the_plain_path_counts_none():
    names = tracing.counters()
    assert "segment_sum.launches" in names
    assert set(names["segment_sum.launches_by_path"]) == {"plan", "device"}
    before = tracing.counters()
    m, order, keys, offsets = _operands()
    K.segment_sum(m, keys, order, keys, offsets)
    assert tracing.since(before)["segment_sum.launches"] == 0
