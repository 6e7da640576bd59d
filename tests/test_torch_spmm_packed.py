"""K1's packed operand against the JAX reference: ``pack_bsr`` in numpy and
in torch, the inverse of the pack, the order of a row's entries, and the
packed product's plain version against the reference's ``spmm`` (Pallas in
interpret mode) and ``spmm_plain``.  The CUDA kernel itself runs only on the
card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it against
``spmm_packed_plain`` there."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.gnn.models import directed_edges  # noqa: E402
from repro.kernels import gnn_aggregate as J  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CostModel, partition_from_assign, random_layout, workload_for)
from repro_torch.gnn import build_plan_bsr, compile_plan  # noqa: E402
from repro_torch.graphs import (  # noqa: E402
    build_edge_network, synthetic_siot)
from repro_torch.kernels import gnn_aggregate as T  # noqa: E402
from repro_torch.kernels.ops import BSRAggregate  # noqa: E402
from tests.conftest import random_graph  # noqa: E402


def _cost_model(g, m):
    """A cost model over an ``m``-server fleet for ``random_layout``, which
    reads the graph's and the fleet's sizes from it."""
    return CostModel(build_edge_network(g, m, seed=0), g,
                     workload_for("gcn", g.features.shape[1]))


SHAPES = [
    (40, 60, 8, 128, 128),
    (100, 200, 8, 128, 256),
    (17, 10, 16, 128, 128),
    (250, 500, 8, 256, 128),
]
FIELDS = ("row_ptr", "col", "w")


def _case(seed, n, extra, bm, bk, d, weighted=False):
    rng = np.random.default_rng(seed)
    g = random_graph(rng, n, extra)
    sd = directed_edges(g.edges)
    w = (rng.uniform(0.1, 2.0, size=len(sd)).astype(np.float32)
         if weighted else None)
    vals, cols, n_dst, n_src = J.build_bsr(sd, w, n, bm, bk)
    feats = rng.normal(size=(n_src, d)).astype(np.float32)
    return sd, w, vals, cols, n_dst, n_src, feats


def _unpack(pk, block_cols, bm, bk):
    """The pack's inverse for layouts whose stored blocks in a row name
    distinct source blocks and whose padding follows them: each entry goes
    back to the first slot of its row that names its source block."""
    block_cols = block_cols.reshape((-1,) + block_cols.shape[-2:])
    P, nb, maxb = block_cols.shape
    vals = np.zeros((P, nb, maxb, bm, bk), np.float32)
    for p in range(P):
        for row in range(pk.n_rows):
            i, r = divmod(row, bm)
            for e in range(pk.row_ptr[p, row], pk.row_ptr[p, row + 1]):
                jb, k = divmod(int(pk.col[p, e]), bk)
                j = int(np.flatnonzero(block_cols[p, i] == jb)[0])
                vals[p, i, j, r, k] = pk.w[p, e]
    return vals.reshape(P, nb * maxb, bm, bk)


def _assert_packs_equal(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    assert (a.src_rows, a.n_rows) == (b.src_rows, b.n_rows)


@pytest.mark.parametrize("n,extra,bm,bk,d", SHAPES)
@pytest.mark.parametrize("weighted", [False, True])
def test_pack_numpy_and_torch_agree(n, extra, bm, bk, d, weighted):
    _, _, vals, cols, n_dst, _, _ = _case(n, n, extra, bm, bk, d, weighted)
    pk = T.pack_bsr(vals, cols, bm, bk)
    pt = T.pack_bsr(torch.from_numpy(vals), torch.from_numpy(cols), bm, bk)
    assert isinstance(pk.col, np.ndarray) and isinstance(pt.col, torch.Tensor)
    _assert_packs_equal(pk, pt.to("cpu"))
    assert pk.row_ptr.shape == (1, n_dst + 1) and pk.n_rows == n_dst
    assert pk.row_ptr.dtype == pk.col.dtype == np.int32
    assert pk.w.dtype == np.float32
    assert int(pk.row_ptr[0, -1]) == pk.nnz_cap == int((vals != 0).sum())
    assert pk.src_rows == (int(cols.max()) + 1) * bk


@pytest.mark.parametrize("n,extra,bm,bk,d", SHAPES)
def test_unpack_restores_values(n, extra, bm, bk, d):
    _, _, vals, cols, _, _, _ = _case(n + 3, n, extra, bm, bk, d, True)
    pk = T.pack_bsr(vals, cols, bm, bk)
    np.testing.assert_array_equal(_unpack(pk, cols, bm, bk)[0], vals)


def test_entry_order_is_stored_block_then_k():
    """Within a row: stored block j first (even when a later block names a
    smaller source block), then k ascending; rows ascend."""
    bm, bk = 2, 4
    vals = np.zeros((1 * 3, bm, bk), np.float32)       # nb = 1, maxb = 3
    cols = np.array([[5, 2, 0]], np.int32)             # j = 2 is padding
    vals[0, 0, 3] = 1.0                                 # j 0, r 0, k 3
    vals[0, 0, 1] = 2.0                                 # j 0, r 0, k 1
    vals[1, 0, 0] = 3.0                                 # j 1, r 0, k 0
    vals[1, 1, 2] = 4.0                                 # j 1, r 1, k 2
    vals[0, 1, 0] = 5.0                                 # j 0, r 1, k 0
    for pk in (T.pack_bsr(vals, cols, bm, bk),
               T.pack_bsr(torch.from_numpy(vals), torch.from_numpy(cols),
                          bm, bk).to("cpu")):
        np.testing.assert_array_equal(np.asarray(pk.row_ptr), [[0, 3, 5]])
        np.testing.assert_array_equal(np.asarray(pk.col),
                                      [[5 * 4 + 1, 5 * 4 + 3, 2 * 4 + 0,
                                        5 * 4 + 0, 2 * 4 + 2]])
        np.testing.assert_array_equal(np.asarray(pk.w),
                                      [[2.0, 1.0, 3.0, 5.0, 4.0]])
        assert pk.src_rows == 6 * bk


def test_padded_blocks_and_exact_zeros_are_dropped():
    rng = np.random.default_rng(11)
    bm, bk = 4, 8
    vals = rng.normal(size=(2, 3 * 4, bm, bk)).astype(np.float32)
    vals[rng.uniform(size=vals.shape) < 0.6] = 0.0      # exact zeros
    vals[:, 2::4] = 0.0                                  # padded blocks
    vals[0, 5] = -0.0
    cols = rng.integers(0, 6, size=(2, 3, 4)).astype(np.int32)
    cols[:, :, 2:] = 0
    pk = T.pack_bsr(vals, cols, bm, bk)
    for p in range(2):
        live = pk.w[p, : pk.row_ptr[p, -1]]
        assert live.size == int((vals[p] != 0).sum())
        assert (live != 0).all()
        np.testing.assert_array_equal(np.sort(live), np.sort(vals[p][vals[p] != 0]))
    assert pk.nnz_cap == int(pk.row_ptr[:, -1].max())
    short = int(pk.row_ptr[:, -1].min())
    p_short = int(pk.row_ptr[:, -1].argmin())
    assert (pk.col[p_short, short:] == 0).all()
    assert (pk.w[p_short, short:] == 0).all()


def test_nnz_cap_padding_is_never_read():
    _, _, vals, cols, _, _, feats = _case(2, 60, 90, 8, 128, 52, True)
    pk = T.pack_bsr(vals, cols, 8, 128, nnz_cap=1000)
    nnz = int(pk.row_ptr[0, -1])
    assert pk.col.shape == pk.w.shape == (1, 1000) and nnz < 1000
    assert (pk.col[:, nnz:] == 0).all() and (pk.w[:, nnz:] == 0).all()
    f = torch.from_numpy(feats)
    clean = T.spmm_packed_plain(pk, f)
    pk.col[:, nnz:] = 10 ** 6                           # out of range
    pk.w[:, nnz:] = np.nan
    np.testing.assert_array_equal(T.spmm_packed_plain(pk, f).numpy(),
                                  clean.numpy())
    with pytest.raises(ValueError, match="nnz_cap"):
        T.pack_bsr(vals, cols, 8, 128, nnz_cap=nnz - 1)


@pytest.mark.parametrize("n,extra,bm,bk,d", SHAPES)
def test_spmm_packed_plain_matches_pallas_and_spmm_plain(n, extra, bm, bk, d):
    _, _, vals, cols, _, _, feats = _case(n + 1, n, extra, bm, bk, d)
    ref = np.asarray(J.spmm(jnp.asarray(vals), jnp.asarray(cols),
                            jnp.asarray(feats), bm=bm, bk=bk, interpret=True))
    pk = T.pack_bsr(vals, cols, bm, bk)
    out = T.spmm_packed_plain(pk, torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    dense = T.spmm_plain(torch.from_numpy(vals), torch.from_numpy(cols),
                         torch.from_numpy(feats), bm, bk).numpy()
    np.testing.assert_allclose(out, dense, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [52, 100])
def test_spmm_packed_plain_weighted_ragged_and_empty_rows(d):
    """Weighted arcs into even vertices only: odd rows, and the padded rows
    past n, are empty and give exactly 0."""
    rng = np.random.default_rng(d)
    n, bm, bk = 90, 8, 128
    sd = np.stack([rng.integers(0, n, 300), 2 * rng.integers(0, n // 2, 300)],
                  axis=1)
    w = rng.uniform(0.1, 2.0, size=len(sd)).astype(np.float32)
    vals, cols, n_dst, n_src = J.build_bsr(sd, w, n, bm, bk)
    feats = rng.normal(size=(n_src, d)).astype(np.float32)
    ref = np.asarray(J.spmm(jnp.asarray(vals), jnp.asarray(cols),
                            jnp.asarray(feats), bm=bm, bk=bk, interpret=True))
    pk = T.pack_bsr(vals, cols, bm, bk)
    out = T.spmm_packed_plain(pk, torch.from_numpy(feats)).numpy()
    assert out.shape == (n_dst, d)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        out, T.spmm_plain(*[torch.from_numpy(a) for a in (vals, cols, feats)],
                          bm, bk).numpy(), rtol=1e-5, atol=1e-5)
    empty = np.diff(pk.row_ptr[0]) == 0
    assert empty[1::2].all() and empty[n:].all()
    assert (out[empty] == 0).all()
    oracle = np.zeros((n_dst, d), np.float64)
    np.add.at(oracle, sd[:, 1], w[:, None].astype(np.float64) * feats[sd[:, 0]])
    np.testing.assert_allclose(out, oracle, rtol=1e-4, atol=1e-4)


@settings(max_examples=40, deadline=None)
@given(P=st.sampled_from([1, 3]), nb=st.integers(1, 4),
       maxb=st.integers(1, 4), bm=st.sampled_from([1, 2, 4]),
       bk=st.sampled_from([1, 4, 8]), src_blocks=st.integers(1, 6),
       density=st.floats(0.0, 1.0), seed=st.integers(0, 2 ** 32 - 1))
def test_pack_round_trip_property(P, nb, maxb, bm, bk, src_blocks, density,
                                  seed):
    """Random BSRs (random sparsity, padded blocks after each row's stored
    ones) round-trip through pack and unpack, and the numpy and torch packs
    agree."""
    rng = np.random.default_rng(seed)
    vals = np.zeros((P, nb, maxb, bm, bk), np.float32)
    cols = np.zeros((P, nb, maxb), np.int32)
    for p in range(P):
        for i in range(nb):
            m = int(rng.integers(0, min(maxb, src_blocks) + 1))
            cols[p, i, :m] = rng.permutation(src_blocks)[:m]
            blk = rng.normal(size=(m, bm, bk)).astype(np.float32)
            vals[p, i, :m] = np.where(rng.uniform(size=blk.shape) < density,
                                      blk, 0.0)
    vals = vals.reshape(P, nb * maxb, bm, bk)
    arg_vals, arg_cols = (vals, cols) if P > 1 else (vals[0], cols[0])
    pk = T.pack_bsr(arg_vals, arg_cols, bm, bk)
    _assert_packs_equal(pk, T.pack_bsr(torch.from_numpy(arg_vals),
                                       torch.from_numpy(arg_cols), bm,
                                       bk).to("cpu"))
    np.testing.assert_array_equal(_unpack(pk, cols, bm, bk), vals)
    counts = np.diff(pk.row_ptr, axis=1)
    assert (counts >= 0).all() and pk.row_ptr[:, 0].tolist() == [0] * P
    assert pk.row_ptr[:, -1].tolist() == [int((vals[p] != 0).sum())
                                          for p in range(P)]
    feats = rng.normal(size=(P, src_blocks * bk, 3)).astype(np.float32)
    np.testing.assert_allclose(
        T.spmm_packed_plain(pk, torch.from_numpy(feats)).numpy(),
        T.spmm_plain(*[torch.from_numpy(a) for a in (vals, cols, feats)],
                     bm, bk).numpy(), rtol=1e-5, atol=1e-5)


def test_spmm_packed_cpu_dispatch_takes_plain_path():
    _, _, vals, cols, _, _, feats = _case(5, 40, 60, 8, 128, 52)
    pk = T.pack_bsr(vals, cols, 8, 128).to("cpu")
    f = torch.from_numpy(feats)
    before = T.spmm.launches
    out = T.spmm_packed(pk, f)
    assert out.shape == (pk.n_rows, 52)                 # unbatched in, out
    np.testing.assert_array_equal(out.numpy(),
                                  T.spmm_packed_plain(pk, f).numpy())
    np.testing.assert_array_equal(T.spmm_packed(pk, f[None])[0].numpy(),
                                  out.numpy())
    assert T.spmm.launches == before


def test_plan_pack_matches_dense_product():
    """The BSP forward's operand: the plan's BSR packed at e_cap entries per
    partition, against the dense layout's plain product on all P at once."""
    g = synthetic_siot(n=400, target_links=1600)
    plan = compile_plan(g, partition_from_assign(
        g, random_layout(_cost_model(g, 4), seed=0), 4, {}), slack=0.5)
    b = build_plan_bsr(plan)
    pk = T.pack_bsr(b.values, b.block_cols, b.bm, b.bk, nnz_cap=plan.e_cap)
    assert pk.col.shape == (4, plan.e_cap)
    assert pk.row_ptr.shape == (4, b.nb * b.bm + 1)
    live = (plan.edges_dst < plan.cap).sum(axis=1)
    assert (pk.row_ptr[:, -1] <= live).all()
    feats = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, b.src_rows, 16)).astype(np.float32))
    np.testing.assert_allclose(
        T.spmm_packed_plain(pk, feats).numpy(),
        T.spmm_plain(torch.from_numpy(b.values),
                     torch.from_numpy(b.block_cols), feats, b.bm,
                     b.bk).numpy(), rtol=1e-5, atol=1e-5)


def test_bsr_aggregate_packs_once(small_siot):
    sd = directed_edges(small_siot.edges)
    agg = BSRAggregate(sd, small_siot.n, device="cpu")
    assert isinstance(agg.packed.col, torch.Tensor)
    _assert_packs_equal(agg.packed.to("cpu"), T.pack_bsr(
        agg.values.numpy(), agg.block_cols.numpy(), agg.bm, agg.bk))
    assert agg.stored_blocks == agg.block_cols.numel()
    assert 0 < agg.nnz_density < 1
    packed = agg.packed
    feats = torch.from_numpy(small_siot.features)
    auto = agg(feats)
    assert agg.packed is packed                         # no repack per call
    np.testing.assert_allclose(auto.numpy(), agg(feats, impl="plain").numpy(),
                               rtol=1e-5, atol=1e-5)
