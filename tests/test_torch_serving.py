"""Port serving vs the JAX reference: ego extraction, request streams, the
feature cache, and the engine's ledgers and answers on the same stream."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.partition import partition_from_assign as j_partition  # noqa: E402
from repro.gnn import distributed as JD  # noqa: E402
from repro.gnn import models as JM  # noqa: E402
from repro.gnn import serving as JS  # noqa: E402
from repro_torch.core import partition_from_assign  # noqa: E402
from repro_torch.gnn import models as TM  # noqa: E402
from repro_torch.gnn import plan as TP  # noqa: E402
from repro_torch.gnn import serving as TS  # noqa: E402
from repro_torch.graphs import DataGraph  # noqa: E402


def port_graph(g):
    return DataGraph(n=g.n, edges=g.edges.copy(), features=g.features)


@pytest.mark.parametrize("targets,hops,fanout,batch", [
    ([0, 7, 31], 2, None, 4),
    ([149, 3, 3, 80, 12], 1, 3, 5),
])
def test_ego_batch_and_tables_equal_reference(small_siot, targets, hops,
                                              fanout, batch):
    g, tg = small_siot, port_graph(small_siot)
    targets = np.array(targets)
    for t in targets:
        for a, b in zip(JS.extract_ego(g, int(t), hops, fanout),
                        TS.extract_ego(tg, int(t), hops, fanout)):
            np.testing.assert_array_equal(a, b)
    je = JS.extract_ego_batch(g, targets, hops, fanout, batch=batch)
    te = TS.extract_ego_batch(tg, targets, hops, fanout, batch=batch)
    for f in dataclasses.fields(je):
        np.testing.assert_array_equal(getattr(je, f.name),
                                      getattr(te, f.name), err_msg=f.name)
    deg = g.degrees.astype(np.float32)
    for a, b in zip(JS.ego_tables(je, g.features, deg),
                    TS.ego_tables(te, g.features, deg)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["zipf", "request_traffic",
                                   "link_traffic"])
def test_request_streams_equal_reference(which, small_siot):
    g, tg = small_siot, port_graph(small_siot)
    if which == "zipf":
        np.testing.assert_array_equal(JS.zipf_requests(100, 500, s=1.2, seed=7),
                                      TS.zipf_requests(100, 500, s=1.2, seed=7))
        return
    stream = JS.zipf_requests(g.n, 60, seed=3)
    if which == "request_traffic":
        for kw in ({}, {"smooth": 0.5}):
            np.testing.assert_array_equal(
                JS.request_traffic(g.n, stream, **kw),
                TS.request_traffic(g.n, stream, **kw))
        np.testing.assert_array_equal(
            JS.request_traffic(g.n, stream, graph=g, hops=2),
            TS.request_traffic(tg.n, stream, graph=tg, hops=2))
    else:
        np.testing.assert_array_equal(JS.link_traffic(g, stream, hops=2),
                                      TS.link_traffic(tg, stream, hops=2))


def test_feature_cache_counters_equal_reference():
    rng = np.random.default_rng(0)
    caches = [JS.FeatureCache(10, 60), TS.FeatureCache(10, 60)]
    for c in caches:
        c.seed(np.array([1, 2, 3]))
    for _ in range(40):
        ids = rng.integers(0, 20, size=int(rng.integers(1, 6)))
        hits = [c.lookup(ids) for c in caches]
        np.testing.assert_array_equal(*hits)
        for c, h in zip(caches, hits):
            c.admit(ids[~h])
    a, b = caches
    assert (a.hits, a.misses, a.evictions, a.rejected, a.resident) == (
        b.hits, b.misses, b.evictions, b.rejected, b.resident)
    assert list(a._rows) == list(b._rows)


def _engines(g, model, seed=1, batch=4):
    tg = port_graph(g)
    assign = np.random.default_rng(0).integers(0, 4, size=g.n)
    jplan = JD.compile_plan(g, j_partition(g, assign, 4, {}), slack=0.5)
    tplan = TP.compile_plan(tg, partition_from_assign(tg, assign, 4, {}),
                            slack=0.5)
    dims = (g.features.shape[1], 16, 4)
    jcfg = JM.GNNConfig(model, dims)
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jeng = JS.GNNServeEngine(jcfg, jp, g, jplan, batch=batch)
    teng = TS.GNNServeEngine(TM.GNNConfig(model, dims), tp, tg, tplan,
                             batch=batch, device="cpu")
    return jeng, teng, tg


def _assert_ledgers_equal(a, b):
    for f in dataclasses.fields(JS.ServeStats):
        if f.name != "wall_time_s":
            assert getattr(a, f.name) == getattr(b, f.name), f.name


@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_engine_matches_reference(model, small_siot):
    jeng, teng, _ = _engines(small_siot, model)
    targets = JS.zipf_requests(small_siot.n, 17, seed=2)
    out, ref = teng.serve(targets), jeng.serve(targets)
    assert out.shape == ref.shape == (17, 4)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    _assert_ledgers_equal(teng.stats, jeng.stats)
    assert teng.stats.batches == 5                       # ceil(17 / 4)
    assert teng.cache_stats() == jeng.cache_stats()
    lat = teng.latency_percentiles()
    assert lat["p99"] >= lat["p50"] >= 0.0 and teng.stats.throughput_rps > 0


def test_engine_follows_plan_patch_like_reference(small_siot):
    g = small_siot
    jeng, teng, tg = _engines(g, "gcn", seed=3)
    first = np.array([0, 1, 2, 3, 4])
    np.testing.assert_allclose(teng.serve(first), jeng.serve(first),
                               rtol=1e-5, atol=1e-5)
    new = jeng.plan.assign.copy()
    new[:30] = (new[:30] + 1) % 4                        # relayout delta
    JD.patch_plan(jeng.plan, g, new)
    TP.patch_plan(teng.plan, tg, new)
    second = np.array([5, 8, 13, 21, 34, 55])
    np.testing.assert_allclose(teng.serve(second), jeng.serve(second),
                               rtol=1e-5, atol=1e-5)
    assert teng.stats.plan_refreshes == jeng.stats.plan_refreshes == 1
    _assert_ledgers_equal(teng.stats, jeng.stats)
    _assert_ledgers_equal(teng.epoch_stats, jeng.epoch_stats)
    assert len(teng.epoch_history) == len(jeng.epoch_history) == 1
    _assert_ledgers_equal(teng.epoch_history[0]["stats"],
                          jeng.epoch_history[0]["stats"])
    assert teng.cache_stats() == jeng.cache_stats()
