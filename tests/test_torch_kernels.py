"""Port kernels vs the JAX reference: BSR packing, the plain SpMM path, the
per-block oracle and the CPU dispatch.  The CUDA kernel itself runs only on
the card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it against
``spmm_plain`` there."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.gnn.models import directed_edges  # noqa: E402
from repro.kernels import gnn_aggregate as J  # noqa: E402
from repro.kernels.ops import BSRAggregate as JBSRAggregate  # noqa: E402
from repro_torch.kernels import gnn_aggregate as T  # noqa: E402
from repro_torch.kernels.ops import BSRAggregate, aggregate_features  # noqa: E402
from repro_torch.kernels.ref import segment_sum_ref, spmm_ref  # noqa: E402
from tests.conftest import random_graph  # noqa: E402

SHAPES = [
    (40, 60, 8, 128, 128),
    (100, 200, 8, 128, 256),
    (17, 10, 16, 128, 128),
    (250, 500, 8, 256, 128),
]


def _case(seed, n, extra, bm, bk, d, weighted=False):
    rng = np.random.default_rng(seed)
    g = random_graph(rng, n, extra)
    sd = directed_edges(g.edges)
    w = (rng.uniform(0.1, 2.0, size=len(sd)).astype(np.float32)
         if weighted else None)
    vals, cols, n_dst, n_src = J.build_bsr(sd, w, n, bm, bk)
    feats = rng.normal(size=(n_src, d)).astype(np.float32)
    return sd, w, vals, cols, n_dst, n_src, feats


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


@pytest.mark.parametrize("n,extra,bm,bk,d", SHAPES)
@pytest.mark.parametrize("weighted", [False, True])
def test_build_bsr_equals_reference(n, extra, bm, bk, d, weighted):
    rng = np.random.default_rng(n)
    g = random_graph(rng, n, extra)
    sd = directed_edges(g.edges)
    w = (rng.uniform(0.1, 2.0, size=len(sd)).astype(np.float32)
         if weighted else None)
    ref = J.build_bsr(sd, w, n, bm, bk)
    got = T.build_bsr(sd, w, n, bm, bk)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert T.bsr_density(got[1], got[0]) == J.bsr_density(ref[1], ref[0])


@pytest.mark.parametrize("n,extra,bm,bk,d", SHAPES)
def test_spmm_plain_matches_pallas_and_segment_sum(n, extra, bm, bk, d):
    sd, _, vals, cols, n_dst, _, feats = _case(n + 1, n, extra, bm, bk, d)
    ref = np.asarray(J.spmm(jnp.asarray(vals), jnp.asarray(cols),
                            jnp.asarray(feats), bm=bm, bk=bk, interpret=True))
    out = T.spmm_plain(*_t(vals, cols, feats), bm, bk).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    oracle = segment_sum_ref(torch.from_numpy(feats[sd[:, 0]]),
                             torch.from_numpy(sd[:, 1]), n_dst).numpy()
    np.testing.assert_allclose(out, oracle, rtol=1e-4, atol=1e-4)


def test_spmm_plain_weighted_edges():
    sd, w, vals, cols, n_dst, _, feats = _case(7, 30, 40, 8, 128, 128,
                                               weighted=True)
    out = T.spmm_plain(*_t(vals, cols, feats), 8, 128).numpy()
    ref = np.asarray(J.spmm_jnp(jnp.asarray(vals), jnp.asarray(cols),
                                jnp.asarray(feats), 8, 128))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    oracle = np.zeros((n_dst, feats.shape[1]), np.float64)
    np.add.at(oracle, sd[:, 1], w[:, None].astype(np.float64)
              * feats[sd[:, 0]])
    np.testing.assert_allclose(out, oracle, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,extra,bm,bk,d", [SHAPES[0], SHAPES[2]])
def test_spmm_ref_matches_plain(n, extra, bm, bk, d):
    _, _, vals, cols, _, _, feats = _case(n + 2, n, extra, bm, bk, d)
    args = _t(vals, cols, feats)
    np.testing.assert_allclose(spmm_ref(*args, bm, bk).numpy(),
                               T.spmm_plain(*args, bm, bk).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_spmm_plain_batched_equals_per_partition():
    """The (P, ...) form the BSP forward uses is P independent products."""
    rng = np.random.default_rng(3)
    P, bm, bk, d = 3, 4, 8, 5
    vals = np.where(rng.uniform(size=(P, 6 * 2, bm, bk)) < 0.2,
                    rng.normal(size=(P, 6 * 2, bm, bk)), 0).astype(np.float32)
    cols = rng.integers(0, 4, size=(P, 6, 2)).astype(np.int32)
    feats = rng.normal(size=(P, 4 * bk, d)).astype(np.float32)
    out = T.spmm_plain(*_t(vals, cols, feats), bm, bk)
    assert out.shape == (P, 6 * bm, d)
    for p in range(P):
        one = T.spmm_plain(*_t(vals[p], cols[p], feats[p]), bm, bk)
        np.testing.assert_array_equal(out[p].numpy(), one.numpy())


def test_spmm_cpu_dispatch_takes_plain_path():
    _, _, vals, cols, _, _, feats = _case(5, 40, 60, 8, 128, 52)
    before = T.spmm.launches
    args = _t(vals, cols, feats)
    out = T.spmm(*args, 8, 128)
    np.testing.assert_array_equal(out.numpy(),
                                  T.spmm_plain(*args, 8, 128).numpy())
    assert T.spmm.launches == before


@pytest.mark.parametrize("impl", ["auto", "plain", "ref"])
def test_bsr_aggregate_matches_reference_without_padding(impl, small_yelp):
    """d = 100 is ragged for the reference's 128-lane pad; the port needs
    no pad and agrees with the reference's wrapper."""
    sd = directed_edges(small_yelp.edges)
    ref = np.asarray(JBSRAggregate(sd, small_yelp.n)(
        jnp.asarray(small_yelp.features), impl="jnp"))
    agg = BSRAggregate(sd, small_yelp.n, device="cpu")
    out = agg(torch.from_numpy(small_yelp.features), impl=impl).numpy()
    assert out.shape == ref.shape == small_yelp.features.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_aggregate_features_and_kernel_impl_guard(small_siot):
    sd = directed_edges(small_siot.edges)
    feats = torch.from_numpy(small_siot.features)
    out = aggregate_features(sd, feats, small_siot.n)
    oracle = segment_sum_ref(feats[torch.from_numpy(sd[:, 0]).long()],
                             torch.from_numpy(sd[:, 1]), small_siot.n)
    np.testing.assert_allclose(out.numpy(), oracle.numpy(),
                               rtol=1e-4, atol=1e-4)
    agg = BSRAggregate(sd, small_siot.n, device="cpu")
    with pytest.raises(ValueError):
        agg(feats, impl="kernel")               # the kernel needs the card
    with pytest.raises(ValueError):
        agg(feats, impl="pallas")

