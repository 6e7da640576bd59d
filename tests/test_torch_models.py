"""Port GNN models vs the JAX reference on the same weights and inputs."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import gnn_paper as JC  # noqa: E402
from repro.gnn import models as J  # noqa: E402
from repro_torch.configs import gnn_paper as TC  # noqa: E402
from repro_torch.gnn import models as T  # noqa: E402

TOL = {"gcn": 1e-5, "sage": 1e-5, "gat": 1e-4}


def _pair(model, dims, seed=0):
    jcfg = J.GNNConfig(model, dims)
    jp = J.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = T.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, T.GNNConfig(model, dims), tp


@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
@pytest.mark.parametrize("graph", ["small_siot", "small_yelp"])
def test_forward_matches_reference(model, graph, request):
    g = request.getfixturevalue(graph)
    dims = (g.features.shape[1], 16, 2)
    jcfg, jp, tcfg, tp = _pair(model, dims)
    sd = J.directed_edges(g.edges)
    ref = np.asarray(J.forward(jcfg, jp, jnp.asarray(g.features),
                               jnp.asarray(sd)))
    out = T.forward(tcfg, tp, torch.from_numpy(g.features), sd).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL[model], atol=TOL[model])


def test_directed_edges_and_degrees_match(small_siot):
    sd_t = T.directed_edges(small_siot.edges)
    sd_j = J.directed_edges(small_siot.edges)
    np.testing.assert_array_equal(sd_t, sd_j)
    assert sd_t.dtype == sd_j.dtype
    deg_j = np.asarray(J.degrees_from_directed(jnp.asarray(sd_j),
                                               small_siot.n))
    deg_t = T.degrees_from_directed(torch.from_numpy(sd_t),
                                    small_siot.n).numpy()
    np.testing.assert_array_equal(deg_t, deg_j)
    assert deg_t.dtype == np.float32
    assert len(T.directed_edges(np.zeros((0, 2), np.int64))) == 0


@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_init_params_keys_shapes_and_glorot_range(model):
    dims = (52, 16, 2)
    jp = J.init_params(jax.random.PRNGKey(0), J.GNNConfig(model, dims))
    tp = T.init_params(T.GNNConfig(model, dims), torch.Generator().manual_seed(0),
                       device="cpu")
    assert len(tp) == len(jp)
    for lj, lt in zip(jp, tp):
        assert sorted(lj) == sorted(lt)
        for k in lj:
            assert tuple(lt[k].shape) == tuple(lj[k].shape)
            assert lt[k].dtype == torch.float32
        w = lt["w"]
        lim = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
        assert float(w.abs().max()) <= lim
    again = T.init_params(T.GNNConfig(model, dims),
                          torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a["w"], b["w"]) for a, b in zip(tp, again))


def test_sorted_segment_sum_equals_index_add_bitwise():
    """The card's deterministic segment sum adds each destination's
    messages in edge order, exactly as ``index_add_`` does on the CPU."""
    rng = np.random.default_rng(0)
    msgs = torch.from_numpy(rng.normal(size=(500, 7)).astype(np.float32))
    dst = torch.from_numpy(rng.integers(0, 60, size=500))
    a = T.sorted_segment_sum(msgs, dst, 64)
    b = torch.zeros(64, 7).index_add_(0, dst, msgs)
    assert torch.equal(a, b)
    assert torch.equal(T.segment_sum(msgs, dst, 64), b)
    empty = T.sorted_segment_sum(msgs[:0], dst[:0], 5)
    assert empty.shape == (5, 7) and not empty.any()


def test_segment_max_matches_reference():
    rng = np.random.default_rng(1)
    vals = rng.normal(size=200).astype(np.float32)
    dst = rng.integers(0, 40, size=200)
    ref = np.asarray(jax.ops.segment_max(jnp.asarray(vals), jnp.asarray(dst),
                                         num_segments=45))
    out = T.segment_max(torch.from_numpy(vals), torch.from_numpy(dst),
                        45).numpy()
    np.testing.assert_array_equal(out, ref)        # -inf on empty segments


def test_loss_and_predict_match_reference(small_siot):
    g = small_siot
    jcfg, jp, tcfg, tp = _pair("gcn", (g.features.shape[1], 16, 2), seed=3)
    sd = J.directed_edges(g.edges)
    mask = (np.arange(g.n) % 3 == 0).astype(np.float32)
    ref = float(J.loss_fn(jcfg, jp, jnp.asarray(g.features), jnp.asarray(sd),
                          jnp.asarray(g.labels), jnp.asarray(mask)))
    out = float(T.loss_fn(tcfg, tp, torch.from_numpy(g.features), sd,
                          torch.from_numpy(g.labels), torch.from_numpy(mask)))
    assert abs(out - ref) <= 1e-5 * max(1.0, abs(ref))
    pred = T.predict(tcfg, tp, torch.from_numpy(g.features), sd).numpy()
    ref_pred = np.asarray(J.predict(jcfg, jp, jnp.asarray(g.features),
                                    jnp.asarray(sd)))
    logits = T.forward(tcfg, tp, torch.from_numpy(g.features), sd).numpy()
    decisive = np.abs(logits[:, 0] - logits[:, 1]) > 1e-4   # no near-ties
    assert decisive.mean() > 0.9
    np.testing.assert_array_equal(pred[decisive], ref_pred[decisive])


def test_paper_configs_match_reference():
    assert set(TC.ALL) == set(JC.ALL)
    for key, jcfg in JC.ALL.items():
        tcfg = TC.ALL[key]
        assert (tcfg.model, tcfg.layer_dims) == (jcfg.model, jcfg.layer_dims)


def test_entry_points_default_to_the_card():
    """No device and no card: the port raises instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = T.GNNConfig("gcn", (4, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.params_from_jax([{"w": np.zeros((4, 2), np.float32)}])
