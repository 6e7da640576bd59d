"""Port BSP forward vs the JAX reference: every (model x exchange x
aggregate) path, the rebuild count over a patch sequence, and the slice end
to end (generator -> layout -> plan -> forward -> served requests)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.partition import partition_from_assign as j_partition  # noqa: E402
from repro.gnn import distributed as JD  # noqa: E402
from repro.gnn import models as JM  # noqa: E402
from repro.gnn import serving as JS  # noqa: E402
from repro.graphs.datagraph import synthetic_siot as j_siot  # noqa: E402
from repro_torch.core import partition_from_assign, random_layout  # noqa: E402
from repro_torch.gnn import distributed as TD  # noqa: E402
from repro_torch.gnn import models as TM  # noqa: E402
from repro_torch.gnn import plan as TP  # noqa: E402
from repro_torch.gnn import serving as TS  # noqa: E402
from repro_torch.graphs import DataGraph, synthetic_siot  # noqa: E402
from repro_torch.kernels.gnn_aggregate import pack_bsr, spmm  # noqa: E402
from tests.conftest import random_graph  # noqa: E402

TOL = 2e-4                     # the reference's gate (test_distributed_gnn)


def port_graph(g):
    return DataGraph(n=g.n, edges=g.edges.copy(), features=g.features)


def params_pair(model, dims, seed=0):
    jcfg = JM.GNNConfig(model, dims)
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return (jcfg, jp, TM.GNNConfig(model, dims),
            TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))


@functools.lru_cache(maxsize=None)
def _reference(model, agg):
    """JAX simulate + whole-graph forward on a shared small SIoT layout."""
    g = j_siot(n=150, target_links=450)
    assign = np.random.default_rng(1).integers(0, 4, size=g.n)
    jplan = JD.compile_plan(g, j_partition(g, assign, 4, {}), slack=0.25)
    jcfg, jp, _, _ = params_pair(model, (52, 16, 2))
    sim = JD.simulate_bsp_forward(jcfg, jp, jplan, g.features,
                                  aggregate="pallas" if agg == "bsr"
                                  else "segment")
    full = np.asarray(JM.forward(jcfg, jp, jnp.asarray(g.features),
                                 jnp.asarray(JM.directed_edges(g.edges))))
    return g, assign, sim, full


@pytest.mark.parametrize("agg", ["segment", "bsr"])
@pytest.mark.parametrize("exchange", ["ppermute", "allgather"])
@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_bsp_forward_matches_reference(model, exchange, agg):
    g, assign, sim, full = _reference(model, agg)
    tg = port_graph(g)
    plan = TP.compile_plan(tg, partition_from_assign(tg, assign, 4, {}),
                           slack=0.25)
    _, _, tcfg, tp = params_pair(model, (52, 16, 2))
    fwd = TD.make_bsp_forward(tcfg, plan, exchange=exchange, aggregate=agg,
                              device="cpu")
    assert fwd.mode == ("segment" if model == "gat" else agg)
    blocks = torch.from_numpy(TP.scatter_features(plan, g.features))
    out = TP.gather_outputs(plan, fwd(tp, blocks).numpy(), g.n)
    np.testing.assert_allclose(out, sim, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out, full, rtol=TOL, atol=TOL)
    one_shot = TD.simulate_bsp_forward(tcfg, tp, plan, g.features,
                                       exchange=exchange, aggregate=agg,
                                       device="cpu")
    np.testing.assert_array_equal(one_shot, out)
    assert spmm.launches == 0                 # CPU tensors never launch


@pytest.mark.parametrize("model,exchange", [("gcn", "ppermute"),
                                            ("sage", "allgather")])
def test_builds_track_reference_retrace_over_patches(model, exchange):
    """Value-only patches refresh the resident tensors in place (0 builds);
    a grown capacity or a new round rebuilds exactly once — precisely when
    the reference's PlanDelta.retrace_expected says so.  Every patched
    forward stays bit-equal to a fresh plan's and close to the reference."""
    rng = np.random.default_rng(7)
    g = random_graph(rng, 60, 60)
    P = 4
    assign = rng.integers(0, P, size=g.n)
    jplan = JD.compile_plan(g, j_partition(g, assign, P, {}), slack=0.3)
    JD.build_plan_bsr(jplan, 4, 8)
    tg = port_graph(g)
    plan = TP.compile_plan(tg, partition_from_assign(tg, assign, P, {}),
                           slack=0.3)
    TP.build_plan_bsr(plan, 4, 8)
    jcfg, jp, tcfg, tp = params_pair(model, (8, 8, 2), seed=2)
    ref = np.asarray(JM.forward(jcfg, jp, jnp.asarray(g.features),
                                jnp.asarray(JM.directed_edges(g.edges))))
    fwd = TD.make_bsp_forward(tcfg, plan, exchange=exchange, aggregate="bsr",
                              device="cpu")
    fwd(tp, TP.scatter_features(plan, g.features))
    assert fwd.stats["builds"] == 1
    tensors = fwd.stats["ops"]
    saw = set()
    for step in range(8):
        new = jplan.assign.copy()
        if step == 5:
            new[: g.n // 2] = 0               # stampede: capacities grow
        else:
            k = int(rng.integers(1, 4 if step < 3 else 12))
            movers = rng.choice(g.n, size=k, replace=False)
            new[movers] = rng.integers(0, P, size=k)
        jd = JD.patch_plan(jplan, g, new)
        TP.patch_plan(plan, tg, new)
        before = fwd.stats["builds"]
        blocks = TP.scatter_features(plan, g.features)
        out = fwd(tp, blocks)
        rebuilt = fwd.stats["builds"] - before
        assert rebuilt == int(jd.retrace_expected), (step, jd)
        saw.add(bool(rebuilt))
        if not rebuilt:
            assert fwd.stats["ops"] is tensors     # refreshed in place
        tensors = fwd.stats["ops"]
        fresh = TP.recompile_like(plan, tg, new)
        fresh_out = TD.make_bsp_forward(tcfg, fresh, exchange=exchange,
                                        aggregate="bsr", device="cpu")(
            tp, TP.scatter_features(fresh, g.features))
        assert torch.equal(out, fresh_out)
        np.testing.assert_allclose(
            TP.gather_outputs(plan, out.numpy(), g.n), ref, rtol=TOL, atol=TOL)
    assert saw == {False, True}


def _bsr_plan(seed, n=80, P=4):
    rng = np.random.default_rng(seed)
    g = port_graph(random_graph(rng, n, n))
    plan = TP.compile_plan(g, partition_from_assign(
        g, rng.integers(0, P, size=g.n), P, {}), slack=0.3)
    TP.build_plan_bsr(plan, 4, 8)
    return rng, g, plan


def test_plan_tensors_hold_packed_operand():
    """Mode 'bsr' keeps the BSR's nonzeros at (P, e_cap) on the device and
    not the dense values."""
    _, g, plan = _bsr_plan(3)
    ops = TD._PlanTensors(plan, "bsr", "ppermute", torch.device("cpu"))
    b, P = plan.bsr, plan.num_parts
    assert "bsr_values" not in ops.t and "bsr_cols" not in ops.t
    assert ops.t["bsr_row_ptr"].shape == (P, b.nb * b.bm + 1)
    assert ops.t["bsr_col"].shape == ops.t["bsr_w"].shape == (P, plan.e_cap)
    assert ops.t["bsr_row_ptr"].dtype == ops.t["bsr_col"].dtype == torch.int32
    assert ops.t["bsr_w"].dtype == torch.float32
    assert ops.packed.row_ptr is ops.t["bsr_row_ptr"]
    assert (ops.packed.src_rows, ops.packed.n_rows) == (b.src_rows,
                                                       b.nb * b.bm)
    want = pack_bsr(b.values, b.block_cols, b.bm, b.bk, nnz_cap=plan.e_cap)
    for f, name in (("row_ptr", "bsr_row_ptr"), ("col", "bsr_col"),
                    ("w", "bsr_w")):
        np.testing.assert_array_equal(ops.t[name].numpy(), getattr(want, f))


def test_value_only_patch_refreshes_packed_tensors_to_a_fresh_pack():
    rng, g, plan = _bsr_plan(5)
    cfg = TM.GNNConfig("gcn", (8, 4))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    fwd = TD.make_bsp_forward(cfg, plan, aggregate="bsr", device="cpu")
    fwd(params, TP.scatter_features(plan, g.features))
    ops = fwd.stats["ops"]
    addrs = {k: t.data_ptr() for k, t in ops.t.items()}
    refreshed = 0
    for _ in range(6):
        new = plan.assign.copy()
        movers = rng.choice(g.n, size=3, replace=False)
        new[movers] = rng.integers(0, plan.num_parts, size=3)
        if TP.patch_plan(plan, g, new).retrace_expected:
            break
        fwd(params, TP.scatter_features(plan, g.features))
        assert fwd.stats["builds"] == 1 and fwd.stats["ops"] is ops
        assert {k: t.data_ptr() for k, t in ops.t.items()} == addrs
        fresh = TP.recompile_like(plan, g, new)
        fb = fresh.bsr
        want = pack_bsr(fb.values, fb.block_cols, fb.bm, fb.bk,
                        nnz_cap=fresh.e_cap)
        for f, name in (("row_ptr", "bsr_row_ptr"), ("col", "bsr_col"),
                        ("w", "bsr_w")):
            np.testing.assert_array_equal(ops.t[name].numpy(),
                                          getattr(want, f), err_msg=name)
        refreshed += 1
    assert refreshed >= 2


def test_forwards_over_one_plan_share_one_pack_per_version(monkeypatch):
    """A GCN and a SAGE forward over one plan pack its BSR once per plan
    version, not once each; growth (a new BSR) packs anew."""
    rng, g, plan = _bsr_plan(7)
    packs = []

    def counting_pack(*args, **kw):
        packs.append(plan.version)
        return pack_bsr(*args, **kw)

    monkeypatch.setattr(TD, "pack_bsr", counting_pack)
    fwds = []
    for model in ("gcn", "sage"):
        cfg = TM.GNNConfig(model, (8, 4))
        params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        fwds.append((TD.make_bsp_forward(cfg, plan, aggregate="bsr",
                                         device="cpu"), params))

    def run_all():
        for fwd, params in fwds:
            fwd(params, TP.scatter_features(plan, g.features))

    run_all()
    run_all()
    assert packs == [plan.version]
    new = plan.assign.copy()
    movers = rng.choice(g.n, size=2, replace=False)
    new[movers] = (new[movers] + 1) % plan.num_parts
    assert not TP.patch_plan(plan, g, new).retrace_expected
    run_all()
    assert packs == [plan.version - 1, plan.version]
    grow = plan.assign.copy()
    grow[: g.n // 2] = 0
    assert TP.patch_plan(plan, g, grow).retrace_expected
    run_all()
    assert len(packs) == 3 and packs[-1] == plan.version
    assert all(f.stats["builds"] == 2 for f, _ in fwds)


def test_replica_plans_raise_until_ported(small_siot):
    tg = port_graph(small_siot)
    assign = np.random.default_rng(0).integers(0, 4, size=tg.n)
    plan = TP.compile_plan(tg, partition_from_assign(tg, assign, 4, {}),
                           slack=0.5)
    _, _, tcfg, tp = params_pair("gcn", (52, 8, 2))
    fwd = TD.make_bsp_forward(tcfg, plan, device="cpu")
    TP.set_replication(plan, {0: np.array([1, 2, 3])})
    with pytest.raises(NotImplementedError):
        fwd(tp, TP.scatter_features(plan, tg.features))
    with pytest.raises(NotImplementedError):
        TD.make_bsp_forward(tcfg, plan, device="cpu")


def test_resolve_aggregate_and_device_defaults(small_siot):
    gcn, gat = TM.GNNConfig("gcn", (4, 2)), TM.GNNConfig("gat", (4, 2))
    assert TD.resolve_aggregate(gcn, "auto", "cpu") == "segment"
    assert TD.resolve_aggregate(gcn, "auto", "cuda") == "bsr"
    assert TD.resolve_aggregate(gat, "auto", "cuda") == "segment"
    assert TD.resolve_aggregate(gat, "bsr", "cuda") == "segment"
    with pytest.raises(ValueError):
        TD.resolve_aggregate(gcn, "pallas", "cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    tg = port_graph(small_siot)
    plan = TP.compile_plan(tg, partition_from_assign(
        tg, np.zeros(tg.n, np.int64), 2, {}))
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.make_bsp_forward(gcn, plan)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.GNNServeEngine(gcn, [], tg, plan)
    with pytest.raises(ValueError):
        TD.make_bsp_forward(gcn, plan, exchange="ring", device="cpu")


def test_slice_end_to_end_matches_reference():
    """The chip smoke path at small size on the CPU: generator -> random
    layout -> plan -> BSP forward (BSR aggregate) -> 32 served requests,
    against the JAX pipeline.  n = 300 at the paper's SIoT link density
    (33509 links / 8001 vertices)."""
    n, links, P = 300, 300 * 33509 // 8001, 4
    g, jg = synthetic_siot(n=n, target_links=links), j_siot(n=n,
                                                          target_links=links)
    assign = random_layout(g.n, P, seed=0)
    np.testing.assert_array_equal(
        assign, np.random.default_rng(0).integers(0, P, size=n))
    plan = TP.compile_plan(g, partition_from_assign(g, assign, P, {}),
                           slack=0.5)
    jplan = JD.compile_plan(jg, j_partition(jg, assign, P, {}), slack=0.5)
    TP.build_plan_bsr(plan)
    JD.build_plan_bsr(jplan)
    assert TP.plans_equal(plan, jplan) == []

    jcfg, jp, tcfg, tp = params_pair("gcn", (52, 16, 2), seed=4)
    fwd = TD.make_bsp_forward(tcfg, plan, device="cpu", aggregate="bsr")
    out = TP.gather_outputs(plan, fwd(tp, TP.scatter_features(
        plan, g.features)).numpy(), n)
    ref = JD.simulate_bsp_forward(jcfg, jp, jplan, jg.features,
                                  aggregate="pallas")
    full = np.asarray(JM.forward(jcfg, jp, jnp.asarray(jg.features),
                                 jnp.asarray(JM.directed_edges(jg.edges))))
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out, full, rtol=TOL, atol=TOL)

    targets = TS.zipf_requests(n, 32, s=1.1, seed=0)
    eng = TS.GNNServeEngine(tcfg, tp, g, plan, hops=2, batch=16, device="cpu")
    jeng = JS.GNNServeEngine(jcfg, jp, jg, jplan, hops=2, batch=16)
    served, jserved = eng.serve(targets), jeng.serve(targets)
    np.testing.assert_allclose(served, jserved, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(served, out[targets], rtol=TOL, atol=TOL)
    for f in ("requests", "batches", "local_rows", "cache_hit_rows",
              "fetched_rows", "replica_hit_rows", "plan_refreshes"):
        assert getattr(eng.stats, f) == getattr(jeng.stats, f), f
    assert eng.cache_stats() == jeng.cache_stats()
