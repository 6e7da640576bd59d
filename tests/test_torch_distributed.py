"""Port BSP forward vs the JAX reference: every (model x exchange x
aggregate) path, the rebuild count over a patch sequence, the replica
forward (bit-equal to the unreplicated one, its rebuilds against the
reference's traces), and the slice end to end (generator -> layout -> plan
-> forward -> served requests) under a random and a GLAD-S layout."""
import functools
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import CostModel as JCostModel  # noqa: E402
from repro.core import glad_s as j_glad_s, workload_for as j_workload  # noqa: E402
from repro.core.partition import partition_from_assign as j_partition  # noqa: E402
from repro.gnn import distributed as JD  # noqa: E402
from repro.gnn import models as JM  # noqa: E402
from repro.gnn import serving as JS  # noqa: E402
from repro.graphs.datagraph import synthetic_siot as j_siot  # noqa: E402
from repro.graphs.edgenet import build_edge_network as j_network  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CostModel, glad_s, partition_from_assign, random_layout, workload_for)
from repro_torch.gnn import distributed as TD  # noqa: E402
from repro_torch.gnn import models as TM  # noqa: E402
from repro_torch.gnn import plan as TP  # noqa: E402
from repro_torch.gnn import serving as TS  # noqa: E402
from repro_torch.graphs import (  # noqa: E402
    DataGraph, build_edge_network, synthetic_siot)
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
    before = spmm.launches
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
    assert spmm.launches == before            # CPU tensors never launch


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


# ----------------------------------------------------------- replica forward
@functools.lru_cache(maxsize=None)
def _replica_case(P=4):
    """The reference's replicated-forward scenario at P = 4: a SIoT graph, a
    random layout, a fleet that keeps compute from collapsing onto one
    server, and the cost model's replica overlay.  Returns the port's plain
    and replicated plans, the reference's replicated plan and the graph."""
    g = synthetic_siot(n=160, target_links=420)
    jg = j_siot(n=160, target_links=420)
    assign = np.random.default_rng(0).integers(0, P, size=g.n)
    cm = CostModel(build_edge_network(g, P, seed=0, mu_factor=2.0), g,
                   workload_for("gcn", g.features.shape[1]))
    repl = cm.replicate_greedy(assign)
    assert repl.count > 0
    part = partition_from_assign(g, assign, P, {})
    plain = TP.compile_plan(g, part, slack=0.25)
    rplan = TP.compile_plan(g, part, slack=0.25, replication=repl)
    jrplan = JD.compile_plan(jg, j_partition(jg, assign, P, {}), slack=0.25,
                             replication=repl.by_part)
    assert TP.plans_equal(rplan, jrplan) == []
    assert rplan.halo_bytes_ppermute0 < rplan.halo_bytes_ppermute
    return g, plain, rplan, jrplan


@pytest.mark.parametrize("agg", ["segment", "bsr"])
@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_replicated_forward_bit_equal_to_unreplicated(model, agg):
    """Replicas carry exact copies of what the pruned layer-0 rounds would
    have delivered, so the forward is bit-identical; the allgather forward
    ignores replicas."""
    g, plain, rplan, _ = _replica_case()
    _, _, tcfg, tp = params_pair(model, (52, 16, 2))
    blocks = torch.from_numpy(TP.scatter_features(plain, g.features))
    replica0 = torch.from_numpy(TP.scatter_replica_halo(rplan, g.features))
    assert int((replica0 != 0).any(-1).sum()) > 0
    ref = TD.make_bsp_forward(tcfg, plain, aggregate=agg,
                              device="cpu")(tp, blocks)
    fwd = TD.make_bsp_forward(tcfg, rplan, aggregate=agg, device="cpu")
    assert torch.equal(fwd(tp, blocks, replica0=replica0), ref)
    assert fwd.stats["builds"] == 1
    ag = TD.make_bsp_forward(tcfg, rplan, exchange="allgather",
                             aggregate=agg, device="cpu")
    assert torch.equal(ag(tp, blocks), TD.make_bsp_forward(
        tcfg, plain, exchange="allgather", aggregate=agg,
        device="cpu")(tp, blocks))


@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_replicated_forward_matches_reference_simulation(model):
    g, _, rplan, jrplan = _replica_case()
    jcfg, jp, tcfg, tp = params_pair(model, (52, 16, 2), seed=3)
    sim = JD.simulate_bsp_forward(jcfg, jp, jrplan, g.features)
    out = TD.simulate_bsp_forward(tcfg, tp, rplan, g.features, device="cpu")
    np.testing.assert_allclose(out, sim, rtol=TOL, atol=TOL)


def test_replicated_forward_requires_replica0():
    g, _, rplan, _ = _replica_case()
    _, _, tcfg, tp = params_pair("gcn", (52, 16, 2))
    fwd = TD.make_bsp_forward(tcfg, rplan, device="cpu")
    with pytest.raises(ValueError, match="plan has replicas: pass replica0"):
        fwd(tp, TP.scatter_features(rplan, g.features))


# One script, run by both packages: the replication sequence of the builds
# test.  ``Forward`` wraps the package's BSP forward; the script records its
# counter (the reference's traces, the port's builds) after every step.
_REPL_SEQUENCE = textwrap.dedent("""
    import numpy as np
    g = synthetic_siot(n=120, target_links=330)
    assign = np.random.default_rng(5).integers(0, 4, size=g.n)
    plan = compile_plan(g, partition_from_assign(g, assign, 4, {}),
                        slack=0.3)
    feats = g.features
    fwd = Forward(plan)
    counts = []

    def run():
        fwd(scatter_features(plan, feats),
            scatter_replica_halo(plan, feats) if plan.has_replicas else None)
        counts.append(fwd.count())

    run()                                           # plain plan
    set_replication(plan, {0: np.arange(40, 60), 2: np.arange(60, 80)})
    run()                                           # replicas on
    new = plan.assign.copy()
    new[[3, 17]] = (new[[3, 17]] + 1) % 4
    assert not patch_plan(plan, g, new).retrace_expected
    run()                                           # value-only patch
    r_cap = plan.r_cap
    set_replication(plan, {p: np.arange(0, 110) for p in range(4)})
    assert plan.r_cap > r_cap                       # r_cap grew
    run()
    set_replication(plan, None)
    run()                                           # replicas off
    set_replication(plan, {1: np.arange(10, 30)})
    run()                                           # on again
    print("COUNTS", json.dumps(counts))
""")

_REF_HEAD = textwrap.dedent("""
    import os
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
    import json
    import jax
    from repro.core.partition import partition_from_assign
    from repro.gnn import (GNNConfig, init_params, compile_plan, patch_plan,
                           make_bsp_forward, scatter_features,
                           scatter_replica_halo, set_replication)
    from repro.graphs import synthetic_siot
    from repro.jaxcompat import make_mesh

    cfg = GNNConfig('gcn', (52, 8, 2))
    params = init_params(jax.random.PRNGKey(0), cfg)
    mesh = make_mesh((4,), ('data',))

    class Forward:
        def __init__(self, plan):
            self.f = make_bsp_forward(cfg, plan, mesh, exchange='ppermute',
                                      aggregate='segment')

        def __call__(self, blocks, replica0):
            return self.f(params, blocks, replica0)

        def count(self):
            return self.f.stats['traces']
""")


def test_builds_track_reference_traces_over_replication():
    """Replicas on, a value-only patch of the replicated plan, r_cap growth,
    replicas off and on again: the port rebuilds exactly where the
    reference's jitted forward retraces (its ``stats['traces']``, counted in
    a 4-device subprocess)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REF_HEAD + _REPL_SEQUENCE],
                       env=env, capture_output=True, text=True, timeout=600)
    assert "COUNTS" in r.stdout, r.stdout + r.stderr
    traces = json.loads(r.stdout.split("COUNTS")[1])
    tcfg = TM.GNNConfig("gcn", (52, 8, 2))
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")

    class Forward:
        def __init__(self, plan):
            self.f = TD.make_bsp_forward(tcfg, plan, device="cpu")

        def __call__(self, blocks, replica0):
            return self.f(tp, blocks, replica0)

        def count(self):
            return self.f.stats["builds"]

    scope = {"synthetic_siot": synthetic_siot, "compile_plan": TP.compile_plan,
             "partition_from_assign": partition_from_assign,
             "scatter_features": TP.scatter_features,
             "scatter_replica_halo": TP.scatter_replica_halo,
             "set_replication": TP.set_replication,
             "patch_plan": TP.patch_plan, "json": json, "Forward": Forward}
    exec(_REPL_SEQUENCE.replace('print("COUNTS", json.dumps(counts))', ""),
         scope)
    assert scope["counts"] == traces == [1, 2, 2, 2, 3, 4]


@pytest.mark.parametrize("agg", ["segment", "bsr"])
def test_value_only_patch_of_replicated_plan_equals_fresh_forward(agg):
    """A value-only patch of a replicated plan rewrites the resident
    ``rounds0`` tables in place: the forward equals a fresh plan's, bit for
    bit (a same-plan check would not see stale layer-0 tables)."""
    g, _, base, _ = _replica_case()
    plan = TP.recompile_like(base, g, base.assign)
    _, _, tcfg, tp = params_pair("sage", (52, 16, 2), seed=1)
    fwd = TD.make_bsp_forward(tcfg, plan, aggregate=agg, device="cpu")
    fwd(tp, TP.scatter_features(plan, g.features),
        replica0=TP.scatter_replica_halo(plan, g.features))
    rng = np.random.default_rng(11)
    for step in range(3):
        new = plan.assign.copy()
        movers = rng.choice(g.n, size=3, replace=False)
        new[movers] = (new[movers] + 1) % plan.num_parts
        before = [r["recv_pos"].copy() for r in plan.rounds0]
        assert not TP.patch_plan(plan, g, new).retrace_expected
        assert any(not np.array_equal(a, r["recv_pos"])
                   for a, r in zip(before, plan.rounds0)) or step
        fresh = TP.recompile_like(plan, g, new)
        blocks = TP.scatter_features(plan, g.features)
        replica0 = TP.scatter_replica_halo(plan, g.features)
        out = fwd(tp, blocks, replica0=replica0)
        assert fwd.stats["builds"] == 1
        want = TD.make_bsp_forward(tcfg, fresh, aggregate=agg,
                                   device="cpu")(tp, blocks,
                                                 replica0=replica0)
        assert torch.equal(out, want)


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
    cm = CostModel(build_edge_network(g, P, seed=0), g,
                   workload_for("gcn", 52))
    assign = random_layout(cm, seed=0)
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


@pytest.mark.parametrize("mu_factor", [0.05, 2.0])
def test_glad_slice_end_to_end_matches_reference(mu_factor):
    """The chip smoke path at small size on the CPU, under a GLAD-S layout:
    edge network -> cost model -> GLAD-S (bit-equal to the reference's) ->
    plan -> BSP forward (BSR aggregate) -> 32 served requests, against the
    JAX pipeline within the reference's 2e-4.  The default fleet
    (mu_factor 0.05) collapses SIoT onto few servers; 2.0 keeps compute
    from collapsing, so the layout cuts links and the halo moves rows."""
    n, links, P = 300, 300 * 33509 // 8001, 4
    g, jg = synthetic_siot(n=n, target_links=links), j_siot(n=n,
                                                          target_links=links)
    cm = CostModel(build_edge_network(g, P, seed=0, mu_factor=mu_factor), g,
                   workload_for("gcn", 52))
    jcm = JCostModel(j_network(jg, P, seed=0, mu_factor=mu_factor), jg,
                     j_workload("gcn", 52))
    res, jres = glad_s(cm, seed=0), j_glad_s(jcm, seed=0)
    np.testing.assert_array_equal(res.assign, jres.assign)
    assert ([np.float64(h).hex() for h in res.history]
            == [np.float64(h).hex() for h in jres.history])
    assert res.cost < cm.total(random_layout(cm, seed=0))
    plan = TP.compile_plan(g, partition_from_assign(
        g, res.assign, P, cm.factors(res.assign)), slack=0.5)
    jplan = JD.compile_plan(jg, j_partition(
        jg, jres.assign, P, jcm.factors(jres.assign)), slack=0.5)
    TP.build_plan_bsr(plan)
    JD.build_plan_bsr(jplan)
    assert TP.plans_equal(plan, jplan) == []
    if mu_factor > 1:
        assert plan.halo_bytes_ppermute > 0

    jcfg, jp, tcfg, tp = params_pair("gcn", (52, 16, 2), seed=4)
    fwd = TD.make_bsp_forward(tcfg, plan, device="cpu", aggregate="bsr")
    out = TP.gather_outputs(plan, fwd(tp, TP.scatter_features(
        plan, g.features)).numpy(), n)
    ref = JD.simulate_bsp_forward(jcfg, jp, jplan, jg.features,
                                  aggregate="pallas")
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)

    targets = TS.zipf_requests(n, 32, s=1.1, seed=0)
    eng = TS.GNNServeEngine(tcfg, tp, g, plan, hops=2, batch=16, device="cpu")
    jeng = JS.GNNServeEngine(jcfg, jp, jg, jplan, hops=2, batch=16)
    served, jserved = eng.serve(targets), jeng.serve(targets)
    np.testing.assert_allclose(served, jserved, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(served, out[targets], rtol=TOL, atol=TOL)
    for f in ("requests", "local_rows", "cache_hit_rows", "fetched_rows"):
        assert getattr(eng.stats, f) == getattr(jeng.stats, f), f
