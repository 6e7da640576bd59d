"""The port's layout host code (``repro_torch.graphs`` / ``repro_torch.core``)
against the reference's on the same seeded inputs, bit for bit: edge
networks and k-means, the DGPE cost model (totals, factors and incremental
deltas as float hex), min s-t cuts, GLAD-S under every sweep (assignment,
history hex, iterations), multilevel and streamed coarsening, GLAD-E and
GLAD-A over an evolution trace, a LayoutSession rebind, the three baselines,
the partition bridge's GLAD entry points and the replication greedy.

Each scenario is one function run once per package (``repro`` and
``repro_torch``), so both see identical inputs; wall-clock fields are never
compared."""
import dataclasses
import importlib

import numpy as np
import pytest

PKGS = ("repro", "repro_torch")
SEEDS = (0, 1, 2)


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _both(fn, *args):
    return tuple(fn(pkg, *args) for pkg in PKGS)


def _hex(x):
    return np.float64(x).hex()


def _assert_same(a, b, path="out"):
    """Structural equality with floats compared bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float):
        assert _hex(a) == _hex(b), path
    else:
        assert a == b, path


def _graph(pkg, seed, n=240, kind="siot"):
    dg = _m(pkg, "graphs.datagraph")
    if kind == "siot":
        return dg.synthetic_siot(n=n, target_links=3 * n, seed=seed)
    return dg.synthetic_yelp(n=n, target_links=int(1.5 * n), seed=seed)


def _cm(pkg, seed, n=240, m=4, model="gcn", kind="siot", **net_kw):
    g = _graph(pkg, seed, n, kind)
    net = _m(pkg, "graphs.edgenet").build_edge_network(g, m, seed=seed,
                                                       **net_kw)
    d = 52 if kind == "siot" else 100
    return _m(pkg, "core.cost").CostModel(
        net, g, _m(pkg, "core.cost").workload_for(model, d))


def _result(res):
    return {"assign": res.assign, "history": [float(h) for h in res.history],
            "cost": float(res.cost), "iterations": res.iterations,
            "accepted": res.accepted, "factors": dict(res.factors),
            "moved": res.moved}


# ------------------------------------------------------------- substrates
def _substrate(pkg, seed):
    g = _graph(pkg, seed, kind="yelp")
    en = _m(pkg, "graphs.edgenet")
    net = en.build_edge_network(g, 5, seed=seed, mu_factor=0.1 + 0.2 * seed)
    pod = en.pod_edge_network(8, g.n, pods=2, seed=seed)
    nets = [{f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
            for x in (net, pod, net.degrade(1, 2.5), net.without_server(2))]
    pts = np.random.default_rng(seed).normal(size=(300, 2))
    centers, assign = _m(pkg, "graphs.kmeans").kmeans(pts, 6, seed=seed)
    return nets, centers, assign, g.edges, g.coords


@pytest.mark.parametrize("seed", SEEDS)
def test_edge_networks_and_kmeans_match_reference(seed):
    ref, port = _both(_substrate, seed)
    _assert_same(port, ref)


def _contracted(pkg, seed):
    g = _graph(pkg, seed)
    cluster = np.random.default_rng(seed).integers(0, 40, size=g.n)
    c = _m(pkg, "graphs.datagraph").contract_graph(g, cluster, 40)
    return c.n, c.edges, c.edge_weights


@pytest.mark.parametrize("seed", SEEDS)
def test_contract_graph_matches_reference(seed):
    ref, port = _both(_contracted, seed)
    _assert_same(port, ref)


# ------------------------------------------------------------- cost model
def _costs(pkg, seed, model):
    cm = _cm(pkg, seed, model=model)
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, 4, size=cm.graph.n)
    st = cm.layout_state(assign)
    deltas = []
    for _ in range(5):
        moved = rng.choice(cm.graph.n, size=7, replace=False)
        to = rng.integers(0, 4, size=7)
        deltas.append(float(st.delta(moved, to)))
        deltas.append(float(st.commit(moved, to)))
    return {"unary": cm.unary, "cp": cm.cp_matrix,
            "total": float(cm.total(assign)), "factors": cm.factors(assign),
            "deltas": deltas, "state_total": float(st.total),
            "state_factors": st.factors(),
            "marginal": [cm.marginal_all(assign % 2 == 0, assign, v)
                         for v in range(0, cm.graph.n, 17)]}


@pytest.mark.parametrize("model", ["gcn", "gat", "sage"])
@pytest.mark.parametrize("seed", SEEDS)
def test_cost_model_matches_reference(seed, model):
    ref, port = _both(_costs, seed, model)
    _assert_same(port, ref)


def _cut(pkg, seed, backend):
    rng = np.random.default_rng(seed)
    n = 40
    us, vs = rng.integers(0, n, size=160), rng.integers(0, n, size=160)
    keep = us != vs
    us, vs = us[keep], vs[keep]
    caps = rng.uniform(0.1, 5.0, size=len(us)).round(3)
    back = rng.uniform(0.0, 2.0, size=len(us)).round(3)
    val, side = _m(pkg, "core.maxflow").min_st_cut(
        n, 0, n - 1, us, vs, caps, back, backend=backend)
    return float(val), side


@pytest.mark.parametrize("backend", ["scipy", "dinic"])
@pytest.mark.parametrize("seed", SEEDS)
def test_min_st_cut_matches_reference(seed, backend):
    ref, port = _both(_cut, seed, backend)
    _assert_same(port, ref)


# ------------------------------------------------------------------ GLAD-S
SWEEPS = {
    "single": dict(sweep="single"),
    "batched_pairwise": dict(sweep="batched", round_solver="pairwise"),
    "batched_block": dict(sweep="batched", round_solver="block"),
    "batched_chunked": dict(sweep="batched", chunk_nodes=64, workers=2),
    "multilevel": dict(sweep="batched", multilevel=True, coarsen_to=48),
    "multilevel_streamed": dict(sweep="batched", multilevel=True,
                                coarsen_to=48, chunk_vertices=37),
}


def _glad_s(pkg, seed, sweep):
    cm = _cm(pkg, seed, n=300, m=5, mu_factor=1.0)
    return _result(_m(pkg, "core.glad_s").glad_s(cm, seed=seed,
                                                 **SWEEPS[sweep]))


@pytest.mark.parametrize("sweep", list(SWEEPS))
@pytest.mark.parametrize("seed", SEEDS)
def test_glad_s_matches_reference(seed, sweep):
    ref, port = _both(_glad_s, seed, sweep)
    _assert_same(port, ref)
    assert ref["iterations"] > 0


def _baselines(pkg, seed):
    cm = _cm(pkg, seed, m=6, kind="yelp")
    b = _m(pkg, "core.baselines")
    return (b.random_layout(cm, seed=seed), b.greedy_layout(cm),
            b.uploading_first_layout(cm))


@pytest.mark.parametrize("seed", SEEDS)
def test_baselines_match_reference(seed):
    ref, port = _both(_baselines, seed)
    _assert_same(port, ref)


# ------------------------------------------------------- GLAD-E and GLAD-A
def _evolve(pkg, seed):
    core = _m(pkg, "core")
    cm = _cm(pkg, seed, n=200, m=4, mu_factor=1.0)
    g, net, gnn = cm.graph, cm.net, cm.gnn
    trace = core.evolution_trace(g, 3, pct_links=0.05, pct_vertices=0.03,
                                 seed=seed)
    res = core.glad_s(cm, seed=seed)
    assign, out = res.assign, [_result(res)]
    for t, delta in enumerate(trace):
        g_new = core.apply_delta(g, delta)
        changed = core.changed_vertices(g, g_new, assign)
        r = core.glad_e(core.CostModel(net, g_new, gnn), g, assign,
                        seed=seed + t)
        out.append((changed, _result(r)))
        g, assign = g_new, r.assign
    sched = core.GladA(net, gnn, cm.graph, theta=25.0, seed=seed)
    g = cm.graph
    for delta in trace:
        g = core.apply_delta(g, delta)
        sched.step(g)
    out.append([(r.t, r.algorithm, float(r.cost), float(r.drift_estimate),
                 float(r.accumulated_drift), r.migrated_vertices)
                for r in sched.records])
    out.append(sched.assign)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_glad_e_and_glad_a_over_a_trace_match_reference(seed):
    ref, port = _both(_evolve, seed)
    _assert_same(port, ref)
    assert {r[1] for r in ref[-2]} == {"glad-s", "glad-e"}


def _session(pkg, seed):
    core, engine = _m(pkg, "core"), _m(pkg, "core.engine")
    cm0 = _cm(pkg, seed, n=300, m=4, mu_factor=1.0)
    ses = engine.LayoutSession(cache=True, warm=True)
    kw = dict(sweep="batched", cache=True, warm=True, session=ses)
    r0 = core.glad_s(cm0, R=4, seed=seed, **kw)
    cm1 = core.CostModel(cm0.net.degrade(1, 1.5), cm0.graph, cm0.gnn)
    r1 = core.glad_s(cm1, init=r0.assign.copy(), R=4, seed=seed + 1, **kw)
    return _result(r0), _result(r1), ses.adoptions, ses.rebinds


@pytest.mark.parametrize("seed", SEEDS)
def test_layout_session_rebind_matches_reference(seed):
    ref, port = _both(_session, seed)
    _assert_same(port, ref)
    assert ref[3] == 1                      # the second slot was a rebind


# ------------------------------------------- partition bridge, replication
def _coactivation(seed, experts=32, groups=4):
    rng = np.random.default_rng(seed)
    counts = np.zeros((experts, experts))
    per = experts // groups
    for _ in range(60):
        g = rng.integers(0, groups)
        k = rng.choice(np.arange(g * per, (g + 1) * per), size=3,
                       replace=False)
        for a in k:
            counts[a, a] += 25.0
            for b in k:
                if a < b:
                    counts[a, b] += 8.0
                    counts[b, a] += 8.0
    return counts


def _partitions(pkg, seed):
    core = _m(pkg, "core")
    g = _graph(pkg, seed, n=200, kind="yelp")
    gnn = core.workload_for("gcn", 100)
    part = core.data_partition(g, gnn, num_parts=6, pods=2, seed=seed)
    net = _m(pkg, "graphs.edgenet").pod_edge_network(6, g.n, pods=2,
                                                     seed=seed)
    reb = core.rebalance(g, gnn, part, net, straggler=0, slow_factor=4.0,
                         seed=seed)
    exp = core.expert_layout(_coactivation(seed), num_slices=4, pods=2,
                             seed=seed)
    return [{"assign": p.assign, "vertices": p.part_vertices,
             "sizes": p.part_sizes, "halo": p.halo_src,
             "halo_sizes": p.halo_sizes, "cut": p.cut_links,
             "factors": dict(p.cost_factors)} for p in (part, reb, exp)]


@pytest.mark.parametrize("seed", SEEDS)
def test_data_partition_rebalance_expert_layout_match_reference(seed):
    ref, port = _both(_partitions, seed)
    _assert_same(port, ref)


def _replicas(pkg, seed):
    cm = _cm(pkg, seed, n=160, m=4, mu_factor=2.0)
    assign = np.random.default_rng(seed).integers(0, 4, size=cm.graph.n)
    out = []
    for kw in ({}, {"budget": 3}, {"sync_weight": 2.0, "storage": 0.5}):
        r = cm.replicate_greedy(assign, **kw)
        out.append((r.by_part, float(r.gain), float(r.saved), float(r.sync),
                    float(r.storage), r.pairs(),
                    cm.replication_cost(assign, r)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_replicate_greedy_matches_reference(seed):
    ref, port = _both(_replicas, seed)
    _assert_same(port, ref)
    assert sum(len(v) for v in ref[0][0].values()) > 0
