"""The counts of work on a small graph worked out by hand."""
import pytest

from bench.ref import gat, gcn
from bench.yardstick import peaks, work


def test_spmm_counts():
    # 5 arcs of width 3: 2 * 5 * 3 operations; 5 * (4 + 4) bytes of
    # weights and indices, 4 input rows and 3 output rows of 3 floats.
    flops, nbytes = work.spmm(arcs=5, in_rows=4, out_rows=3, width=3)
    assert flops == 30
    assert nbytes == 40 + 4 * 3 * 7


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_seconds(67e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_gcn_aggregations():
    assert gcn.aggregations((52, 16, 2), train=False) == [("fwd", 16),
                                                          ("fwd", 2)]
    assert gcn.aggregations((52, 16, 2), train=True) == [
        ("fwd", 16), ("fwd", 2), ("bwd", 2)]
    assert gat.aggregations((52, 16, 2), train=True) == []


# A path 0 - 1 - 2: 3 vertices, 4 arcs; layers 2 -> 3 -> 1.
COUNTS = {"n": 3, "arcs": 4}
DIMS = (2, 3, 1)


def test_gcn_forward_flops():
    # layer 0 (w = 2): sums 4 * 2, self and scale 2 * 3 * 2, product
    # 2 * 3 * 2 * 3, ReLU 3 * 3; layer 1 (w = 1): 4 + 2 * 3 + 2 * 3 * 3.
    want = (8 + 12 + 36 + 9) + (4 + 6 + 18)
    assert gcn.flops(COUNTS, DIMS, train=False) == want


def test_gcn_train_flops():
    fwd = gcn.flops(COUNTS, DIMS, train=False)
    # dW of both layers 36 + 18; layer 1's input: 18 + 2 * 3 + 4 + 3 * 3;
    # NLL 3 * 4 + 3 * 2; SGD 2 * (6 + 3).
    want = fwd + 36 + 18 + (18 + 6 + 4 + 9) + (12 + 6) + 18
    assert gcn.flops(COUNTS, DIMS, train=True) == want


def test_gat_forward_flops():
    # 7 arcs with the self loops.  Layer 0: 2*3*2*3 + 4*3*3 + 7*(7+6) + 3*3;
    # layer 1: 2*3*3*1 + 4*3*1 + 7*(7+2).
    want = (36 + 36 + 91 + 9) + (18 + 12 + 63)
    assert gat.flops(COUNTS, DIMS, train=False) == want


def test_gat_train_flops():
    fwd = gat.flops(COUNTS, DIMS, train=False)
    # per layer: dW + 7 * (4 b + 5) + 8 n b; layer 1 also 2 n a b + n a;
    # NLL 3 * 4 + 3 * 2; SGD 2 * ((6 + 6) + (3 + 2)).
    want = (fwd + (36 + 7 * 17 + 72) + (18 + 7 * 9 + 24 + 18 + 9)
            + (12 + 6) + 34)
    assert gat.flops(COUNTS, DIMS, train=True) == want
