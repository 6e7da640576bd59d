"""Port serving vs the JAX reference: ego extraction, request streams, the
feature cache, the engine's ledgers and answers on the same stream (over a
plain and a replicated plan), and the analytic serving cost with the
stream-weighted replica greedy."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import CostModel as JCostModel  # noqa: E402
from repro.core import workload_for as j_workload  # noqa: E402
from repro.core.partition import partition_from_assign as j_partition  # noqa: E402
from repro.gnn import distributed as JD  # noqa: E402
from repro.gnn import models as JM  # noqa: E402
from repro.gnn import serving as JS  # noqa: E402
from repro.graphs.edgenet import build_edge_network as j_network  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CostModel, partition_from_assign, workload_for)
from repro_torch.gnn import models as TM  # noqa: E402
from repro_torch.gnn import plan as TP  # noqa: E402
from repro_torch.gnn import serving as TS  # noqa: E402
from repro_torch.graphs import DataGraph, build_edge_network  # noqa: E402
from tests.conftest import random_graph  # noqa: E402


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


def _serving_setup(seed):
    """The reference's serving-cost scenario, once per package: a random
    graph, a fleet that keeps compute from collapsing (mu_factor 2.0), a
    random layout and a 400-request Zipf stream."""
    rng = np.random.default_rng(seed)
    g = random_graph(rng, 140, 220)
    tg = DataGraph(n=g.n, edges=g.edges.copy(), features=g.features,
                   labels=g.labels, coords=g.coords)
    jcm = JCostModel(j_network(g, 4, seed=seed, mu_factor=2.0), g,
                     j_workload("gcn", g.features.shape[1]))
    tcm = CostModel(build_edge_network(tg, 4, seed=seed, mu_factor=2.0), tg,
                    workload_for("gcn", g.features.shape[1]))
    assign = rng.integers(0, 4, size=g.n)
    targets = JS.zipf_requests(g.n, 400, s=1.1, seed=seed)
    return g, tg, jcm, tcm, assign, targets


def _replication_equal(a, b):
    assert a.by_part.keys() == b.by_part.keys()
    for p in a.by_part:
        np.testing.assert_array_equal(a.by_part[p], b.by_part[p])
    for f in ("gain", "saved", "sync", "storage", "sync_weight",
              "storage_cost"):
        assert np.float64(getattr(a, f)).hex() == \
            np.float64(getattr(b, f)).hex(), f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_serving_cost_and_replicate_for_stream_equal_reference(seed):
    _, _, jcm, tcm, assign, targets = _serving_setup(seed)
    hexes = []
    for kw in ({}, {"budget": 2}, {"sync_weight": 1.5, "storage": 0.25}):
        jr = JS.replicate_for_stream(jcm, assign, targets, hops=2, **kw)
        tr = TS.replicate_for_stream(tcm, assign, targets, hops=2, **kw)
        _replication_equal(tr, jr)
        assert tr.count > 0
        cost_kw = {k: v for k, v in kw.items() if k != "budget"}
        for repl in (None, tr.by_part, tr):
            j = JS.serving_cost(jcm, assign, targets, hops=2,
                                replication=repl, **cost_kw)
            t = TS.serving_cost(tcm, assign, targets, hops=2,
                                replication=repl, **cost_kw)
            hexes.append((np.float64(t).hex(), np.float64(j).hex()))
        base = TS.serving_cost(tcm, assign, targets, hops=2, **cost_kw)
        got = TS.serving_cost(tcm, assign, targets, hops=2,
                              replication=tr, **cost_kw)
        assert got == pytest.approx(base - tr.gain)
    assert all(t == j for t, j in hexes)
    with pytest.raises(ValueError, match="traffic-blind"):
        TS.serving_cost(CostModel(tcm.net, tcm.graph, tcm.gnn,
                                  traffic=np.ones(tcm.graph.n)),
                        assign, targets, hops=2)


@pytest.mark.parametrize("model", ["gcn", "sage"])
def test_engine_over_replicated_plan_matches_reference(model):
    """The same stream through both engines over a replicated plan: the
    replica tier serves rows before the cache, and every ledger field and
    answer matches the reference's."""
    g, tg, jcm, tcm, assign, targets = _serving_setup(1)
    repl = TS.replicate_for_stream(tcm, assign, targets, hops=2)
    jplan = JD.compile_plan(g, j_partition(g, assign, 4, {}), slack=0.5,
                            replication=repl.by_part)
    tplan = TP.compile_plan(tg, partition_from_assign(tg, assign, 4, {}),
                            slack=0.5, replication=repl)
    assert TP.plans_equal(tplan, jplan) == []
    dims = (g.features.shape[1], 16, 2)
    jcfg = JM.GNNConfig(model, dims)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jeng = JS.GNNServeEngine(jcfg, jp, g, jplan, hops=2, batch=16,
                             cache_bytes=2048)
    teng = TS.GNNServeEngine(TM.GNNConfig(model, dims), tp, tg, tplan,
                             hops=2, batch=16, cache_bytes=2048, device="cpu")
    out, ref = teng.serve(targets[:160]), jeng.serve(targets[:160])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    _assert_ledgers_equal(teng.stats, jeng.stats)
    assert teng.cache_stats() == jeng.cache_stats()
    assert teng.stats.replica_hit_rows > 0
