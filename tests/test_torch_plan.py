"""Port host code vs the JAX reference: graph generators, the partition
bridge, and the ShardPlan compile/patch/BSR/replica tables, array for
array."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import baselines as JB  # noqa: E402
from repro.core.cost import CostModel, workload_for  # noqa: E402
from repro.core.evolution import apply_delta, sample_delta  # noqa: E402
from repro.core.glad_s import glad_s  # noqa: E402
from repro.core.partition import partition_from_assign as j_partition  # noqa: E402
from repro.gnn import distributed as JD  # noqa: E402
from repro.graphs import datagraph as JG  # noqa: E402
from repro.graphs.edgenet import build_edge_network  # noqa: E402
from repro_torch import core as TC  # noqa: E402
from repro_torch.core import partition_from_assign, random_layout  # noqa: E402
from repro_torch.gnn import plan as TP  # noqa: E402
from repro_torch.graphs import datagraph as TG  # noqa: E402
from repro_torch.graphs import edgenet as TE  # noqa: E402
from tests.conftest import random_graph  # noqa: E402


def port_graph(g):
    return TG.DataGraph(n=g.n, edges=g.edges.copy(), features=g.features)


def assert_same_plan(jplan, tplan):
    """Every field equal, arrays with their dtypes, BSR and rounds
    included."""
    assert JD.plans_equal(jplan, tplan) == []
    assert TP.plans_equal(tplan, jplan) == []
    for f in dataclasses.fields(JD.ShardPlan):
        a, b = getattr(jplan, f.name), getattr(tplan, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name in ("rounds", "rounds0"):
            assert len(a or ()) == len(b or ()), f.name
            for ra, rb in zip(a or (), b or ()):
                assert sorted(ra) == sorted(rb)
                for k in ra:
                    np.testing.assert_array_equal(ra[k], rb[k])
        elif f.name == "bsr":
            assert (a is None) == (b is None)
            if a is not None:
                for g in dataclasses.fields(a):
                    np.testing.assert_array_equal(getattr(a, g.name),
                                                  getattr(b, g.name))
        elif f.name == "replication":
            assert (a is None) == (b is None)
            if a is not None:
                assert sorted(a) == sorted(b)
                for p in a:
                    np.testing.assert_array_equal(a[p], b[p])
        else:
            assert a == b, f.name


def both_plans(g, assign, parts, slack=0.0, bsr=None):
    tg = port_graph(g)
    jplan = JD.compile_plan(g, j_partition(g, assign, parts, {}), slack=slack)
    tplan = TP.compile_plan(tg, partition_from_assign(tg, assign, parts, {}),
                            slack=slack)
    if bsr is not None:
        JD.build_plan_bsr(jplan, *bsr)
        TP.build_plan_bsr(tplan, *bsr)
    return jplan, tplan, tg


@pytest.mark.parametrize("kind,kwargs", [
    ("siot", dict(n=150, target_links=450)),
    ("yelp", dict(n=120, target_links=160)),
    ("siot", {}),                                   # the paper's 8001 / 33509
    ("yelp", {}),                                   # the paper's 3912 / 4677
])
def test_generators_identical(kind, kwargs):
    name = f"synthetic_{kind}"
    a = getattr(JG, name)(**kwargs)
    b = getattr(TG, name)(**kwargs)
    assert a.n == b.n
    for f in ("edges", "features", "labels", "coords", "indptr", "indices",
              "degrees"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    if not kwargs:
        assert (b.n, b.num_edges, b.features.shape[1]) in (
            (8001, 33509, 52), (3912, 4677, 100))


def test_partition_bridge_and_random_layout(small_siot):
    g = small_siot
    tg = TG.DataGraph(n=g.n, edges=g.edges.copy(), features=g.features,
                      coords=g.coords)
    jcm = CostModel(build_edge_network(g, 4, seed=0), g,
                    workload_for("gcn", 52))
    tcm = TC.CostModel(TE.build_edge_network(tg, 4, seed=0), tg,
                       TC.workload_for("gcn", 52))
    for seed in (0, 5):
        assign = random_layout(tcm, seed=seed)
        ref = JB.random_layout(jcm, seed=seed)
        np.testing.assert_array_equal(assign, ref)
        a = j_partition(g, assign, 4, {"k": 1})
        b = partition_from_assign(port_graph(g), assign, 4, {"k": 1})
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name


@pytest.mark.parametrize("seed,parts,slack,bsr", [
    (0, 2, 0.0, None), (1, 3, 0.5, (8, 128)), (2, 5, 0.3, (4, 8)),
    (3, 4, 0.0, (8, 16)),
])
def test_compile_plan_equals_reference(seed, parts, slack, bsr):
    rng = np.random.default_rng(seed)
    g = random_graph(rng, int(rng.integers(30, 80)), int(rng.integers(10, 80)))
    assign = rng.integers(0, parts, size=g.n)
    jplan, tplan, _ = both_plans(g, assign, parts, slack, bsr)
    assert_same_plan(jplan, tplan)


def test_compile_plan_equals_reference_on_glad_s_layout(small_siot):
    g = small_siot
    net = build_edge_network(g, 4, seed=0)
    assign = glad_s(CostModel(net, g, workload_for("gcn", 52)), R=2,
                    seed=0).assign
    jplan, tplan, _ = both_plans(g, assign, 4, 0.5, (8, 128))
    assert_same_plan(jplan, tplan)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_patch_sequence_equals_reference(seed):
    """Seeded relayouts and graph evolutions through both packages'
    patch_plan leave identical plans; within the port the patched plan
    equals a fresh compile at the same capacities."""
    rng = np.random.default_rng(seed)
    g = random_graph(rng, int(rng.integers(30, 60)), int(rng.integers(20, 50)))
    P = int(rng.integers(2, 6))
    jplan, tplan, tg = both_plans(g, rng.integers(0, P, size=g.n), P,
                                  float(rng.choice([0.0, 0.3])), (4, 8))
    assign = jplan.assign.copy()
    for step in range(5):
        dirty = None
        if step % 2 == 1:                     # evolve the graph, then relayout
            delta = sample_delta(g, pct_links=0.08, pct_vertices=0.05,
                                 seed=seed * 31 + step)
            g_new = apply_delta(g, delta)
            parts = [delta.add_edges.ravel(), delta.del_edges.ravel(),
                     delta.del_vertices]
            parts += [g.neighbors(int(v)) for v in delta.del_vertices]
            if any(len(x) for x in parts):
                dirty = np.unique(np.concatenate(parts)).astype(np.int64)
            g = g_new
            tg = port_graph(g)
            assign = np.concatenate(
                [assign, rng.integers(0, P, size=g.n - len(assign))])
        k = int(rng.integers(1, max(2, g.n // 3)))
        movers = rng.choice(g.n, size=k, replace=False)
        assign = assign.copy()
        assign[movers] = rng.integers(0, P, size=k)
        jd = JD.patch_plan(jplan, g, assign, dirty_vertices=dirty)
        td = TP.patch_plan(tplan, tg, assign, dirty_vertices=dirty)
        assert_same_plan(jplan, tplan)
        for f in ("new_vertices", "patched", "grew", "rounds_added",
                  "retrace_expected"):
            assert getattr(jd, f) == getattr(td, f), f
        np.testing.assert_array_equal(jd.moved, td.moved)
        np.testing.assert_array_equal(jd.dirty_parts, td.dirty_parts)
        assert TP.plans_equal(tplan, TP.recompile_like(tplan, tg, assign)) == []


def test_growth_rebuild_equals_reference(small_siot):
    g = small_siot
    assign = np.random.default_rng(1).integers(0, 4, size=g.n)
    jplan, tplan, tg = both_plans(g, assign, 4, 0.0, (4, 8))
    new = assign.copy()
    new[: g.n // 2] = 0                        # stampede into part 0
    jd = JD.patch_plan(jplan, g, new)
    td = TP.patch_plan(tplan, tg, new)
    assert not td.patched and td.grew == jd.grew and td.retrace_expected
    assert_same_plan(jplan, tplan)


def test_scatter_and_gather_equal_reference(small_yelp):
    g = small_yelp
    assign = np.random.default_rng(2).integers(0, 3, size=g.n)
    jplan, tplan, _ = both_plans(g, assign, 3)
    jb = JD.scatter_features(jplan, g.features)
    tb = TP.scatter_features(tplan, g.features)
    np.testing.assert_array_equal(jb, tb)
    np.testing.assert_array_equal(JD.scatter_ints(jplan, g.labels, pad=-3),
                                  TP.scatter_ints(tplan, g.labels, pad=-3))
    np.testing.assert_array_equal(JD.gather_outputs(jplan, jb, g.n),
                                  TP.gather_outputs(tplan, tb, g.n))
    np.testing.assert_array_equal(TP.gather_outputs(tplan, tb, g.n),
                                  g.features)


def test_replication_tables_equal_reference(small_siot):
    g = small_siot
    assign = np.random.default_rng(4).integers(0, 4, size=g.n)
    jplan, tplan, tg = both_plans(g, assign, 4, 0.5)
    repl = {0: np.array([1, 5, 9, 40]), 2: np.array([3, 7, 100, 149])}
    jd = JD.set_replication(jplan, repl)
    td = TP.set_replication(tplan, repl)
    assert jd.grew == td.grew
    assert_same_plan(jplan, tplan)
    np.testing.assert_array_equal(JD.scatter_replica_halo(jplan, g.features),
                                  TP.scatter_replica_halo(tplan, g.features))
    new = assign.copy()
    new[[1, 3, 40]] = [0, 2, 1]
    JD.patch_plan(jplan, g, new)
    TP.patch_plan(tplan, tg, new)
    assert_same_plan(jplan, tplan)


@pytest.mark.parametrize("seed", [5778, 0, 1, 2, 3])
def test_patch_tracks_graph_evolution(seed):
    """The reference's GLAD-E evolution sequence (``tests/test_plan_patch.py``)
    on the port alone: evolve the graph (links and vertices in and out),
    relayout with GLAD-E, patch with the move delta plus the structural
    endpoints; the patched plan equals a fresh compile every slot.  Seed
    5778 inserts vertices in the slot whose edge table overflows ``e_cap``:
    the rebuild must take the old universe size from the plan's assignment,
    not from ``slot_of``, which the patch has already grown."""
    rng = np.random.default_rng(seed)
    g0 = random_graph(rng, int(rng.integers(30, 60)),
                      int(rng.integers(20, 50)))
    g = TG.DataGraph(n=g0.n, edges=g0.edges.copy(), features=g0.features,
                     labels=g0.labels, coords=g0.coords)
    P = 4
    net = TE.build_edge_network(g, P, seed=seed)
    gnn = TC.workload_for("gcn", 10)
    assign = TC.glad_s(TC.CostModel(net, g, gnn), R=2, seed=seed).assign
    plan = TP.compile_plan(g, partition_from_assign(g, assign, P, {}),
                           slack=0.4)
    TP.build_plan_bsr(plan, bm=4, bk=8)
    grown_after_insertion = False
    for t in range(3):
        delta = TC.sample_delta(g, pct_links=0.08, pct_vertices=0.05,
                                seed=seed + 17 * t)
        g_new = TC.apply_delta(g, delta)
        net_new = TE.build_edge_network(g_new, P, seed=seed)
        res = TC.glad_e(TC.CostModel(net_new, g_new, gnn), g, assign,
                        seed=seed)
        structural = [delta.add_edges.ravel(), delta.del_edges.ravel(),
                      delta.del_vertices]
        structural += [g.neighbors(int(v)) for v in delta.del_vertices]
        structural = (np.unique(np.concatenate(structural))
                      if any(len(x) for x in structural) else None)
        pd = TP.patch_plan(plan, g_new, res.assign,
                           dirty_vertices=structural)
        assert TP.plans_equal(plan, TP.recompile_like(plan, g_new,
                                                      res.assign)) == []
        assert set(np.flatnonzero(
            res.assign[:g.n] != assign)) <= set(res.moved.tolist())
        assert pd.new_vertices == g_new.n - g.n
        grown_after_insertion |= pd.new_vertices > 0 and "e_cap" in pd.grew
        g, assign = g_new, res.assign
    if seed == 5778:
        assert grown_after_insertion
