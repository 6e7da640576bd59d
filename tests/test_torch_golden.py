"""The committed golden fixtures re-run against the port's copy of the
layout code (``repro_torch.core``): the GLAD-S sequential trajectory bit for
bit and the batched sweeps' final cost (``golden_glad_s.json``), the GLAD-E
masked relayout under every cache x warm regime and through a rebound
session (``golden_glad_e.json``), and the multilevel V-cycle's hierarchy and
finest refinement (``golden_multilevel.json``), with the assertions of the
reference's own golden tests.  Imports neither JAX nor the reference."""
import json
import pathlib

import numpy as np
import pytest

from repro_torch.core.cost import CostModel, workload_for
from repro_torch.core.engine import LayoutSession
from repro_torch.core.evolution import (
    apply_delta, changed_vertices, sample_delta)
from repro_torch.core.glad_s import glad_s
from repro_torch.core.multilevel import build_levels
from repro_torch.graphs.datagraph import synthetic_siot
from repro_torch.graphs.edgenet import build_edge_network

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "golden_glad_s.json"
FIXTURE_E = pathlib.Path(__file__).parent / "fixtures" / "golden_glad_e.json"


@pytest.fixture(scope="module")
def golden():
    with open(FIXTURE) as f:
        fix = json.load(f)
    p = fix["params"]
    g = synthetic_siot(n=p["n"], target_links=p["target_links"],
                       seed=p["graph_seed"])
    net = build_edge_network(g, p["m"], seed=p["net_seed"])
    cm = CostModel(net, g, workload_for(p["gnn_model"], p["in_dim"]))
    return fix, cm, p["glad_seed"]


def test_sequential_sweep_reproduces_golden_bit_for_bit(golden):
    fix, cm, seed = golden
    res = glad_s(cm, seed=seed, sweep="single")
    assert res.iterations == fix["iterations"]
    assert res.accepted == fix["accepted"]
    got_hex = [np.float64(h).hex() for h in res.history]
    assert got_hex == fix["history_hex"]
    assert np.float64(res.cost).hex() == fix["final_cost_hex"]
    np.testing.assert_array_equal(res.assign, np.array(fix["assign"]))


@pytest.mark.parametrize("round_solver", ["pairwise", "block"])
def test_batched_sweeps_reach_golden_final_cost(golden, round_solver):
    fix, cm, seed = golden
    res = glad_s(cm, seed=seed, sweep="batched", round_solver=round_solver)
    assert res.cost == pytest.approx(fix["final_cost"], rel=1e-12)


# ------------------------------------------------- GLAD-E masked relayout
@pytest.fixture(scope="module")
def golden_e():
    """The fixture's scenario, rebuilt by the port."""
    with open(FIXTURE_E) as f:
        fix = json.load(f)
    p = fix["params"]
    g0 = synthetic_siot(n=p["n"], target_links=p["target_links"],
                        seed=p["graph_seed"])
    net = build_edge_network(g0, p["m"], seed=p["net_seed"])
    cm0 = CostModel(net, g0, workload_for(p["gnn_model"], p["in_dim"]))
    base = glad_s(cm0, seed=p["base_seed"], sweep="single")
    delta = sample_delta(g0, pct_links=p["delta_pct_links"],
                         pct_vertices=p["delta_pct_vertices"],
                         seed=p["delta_seed"])
    g1 = apply_delta(g0, delta)
    cm1 = CostModel(net, g1, workload_for(p["gnn_model"], p["in_dim"]))
    # Carried-over layout with drift: pad the inserted vertices, scramble
    # a slice (the layout served while the graph evolved).
    rng = np.random.default_rng(p["scramble_seed"])
    assign = np.zeros(g1.n, dtype=np.int64)
    assign[:g0.n] = base.assign
    if g1.n > g0.n:
        assign[g0.n:] = rng.integers(0, p["m"], size=g1.n - g0.n)
    scr = rng.uniform(size=g1.n) < p["scramble_frac"]
    assign[scr] = rng.integers(0, p["m"], size=int(scr.sum()))
    active = changed_vertices(g0, g1, assign)
    active |= scr
    for v in np.flatnonzero(scr):
        active[g1.indices[g1.indptr[v]:g1.indptr[v + 1]]] = True
    return fix, cm1, assign, active, p


@pytest.mark.parametrize("cache,warm", [(False, False), (True, False),
                                        (True, True), (True, "auto")])
def test_glad_e_masked_relayout_reproduces_golden_bit_for_bit(
        golden_e, cache, warm):
    """Every cache x warm regime must reproduce the SAME committed masked
    relayout — full history and final assignment, bit for bit."""
    fix, cm1, assign, active, p = golden_e
    res = glad_s(cm1, R=p["m"], init=assign.copy(), active=active,
                 seed=p["glad_seed"], sweep="batched", cache=cache,
                 warm=warm)
    assert res.iterations == fix["iterations"]
    assert res.accepted == fix["accepted"]
    got_hex = [np.float64(h).hex() for h in res.history]
    assert got_hex == fix["history_hex"]
    assert np.float64(res.cost).hex() == fix["final_cost_hex"]
    np.testing.assert_array_equal(res.assign, np.array(fix["assign"]))


@pytest.mark.parametrize("cache,warm", [(True, False), (True, True)])
def test_session_rebound_engine_reproduces_golden_e(golden_e, cache, warm):
    """A LayoutSession that already served a DIFFERENT slot (the full
    pre-evolution solve) and is then rebound onto the golden scenario must
    reproduce the committed masked relayout bit-for-bit — carried cache
    entries and warm residuals may only change wall time, never the
    trajectory."""
    fix, cm1, assign, active, p = golden_e
    g0 = synthetic_siot(n=p["n"], target_links=p["target_links"],
                        seed=p["graph_seed"])
    net = build_edge_network(g0, p["m"], seed=p["net_seed"])
    cm0 = CostModel(net, g0, workload_for(p["gnn_model"], p["in_dim"]))
    ses = LayoutSession(cache=cache, warm=warm)
    glad_s(cm0, seed=p["base_seed"], sweep="batched", cache=cache,
           warm=warm, session=ses)                 # warm the session
    res = glad_s(cm1, R=p["m"], init=assign.copy(), active=active,
                 seed=p["glad_seed"], sweep="batched", cache=cache,
                 warm=warm, session=ses)
    assert ses.rebinds == 1                        # adopted, not rebuilt
    assert res.iterations == fix["iterations"]
    assert res.accepted == fix["accepted"]
    got_hex = [np.float64(h).hex() for h in res.history]
    assert got_hex == fix["history_hex"]
    assert np.float64(res.cost).hex() == fix["final_cost_hex"]
    np.testing.assert_array_equal(res.assign, np.array(fix["assign"]))


def test_glad_e_golden_fixture_is_self_consistent(golden_e):
    fix, cm1, _, _, _ = golden_e
    assert cm1.total(np.array(fix["assign"])) == pytest.approx(
        fix["final_cost"], rel=1e-12)
    h = np.array(fix["history"])
    assert (np.diff(h) <= 1e-9).all()
    assert h[-1] == pytest.approx(fix["final_cost"], rel=1e-12)
    assert fix["accepted"] >= 2      # the fixture actually moves vertices


def test_golden_fixture_is_self_consistent(golden):
    """The committed assignment really evaluates to the committed cost, and
    the history is monotone non-increasing (accepts only improve)."""
    fix, cm, _ = golden
    assert cm.total(np.array(fix["assign"])) == pytest.approx(
        fix["final_cost"], rel=1e-12)
    h = np.array(fix["history"])
    assert (np.diff(h) <= 1e-9).all()
    assert h[-1] == pytest.approx(fix["final_cost"], rel=1e-12)


# ------------------------------------------------------ multilevel V-cycle
FIXTURE_ML = (pathlib.Path(__file__).parent / "fixtures"
              / "golden_multilevel.json")


def _cluster_checksum(cluster_of):
    return int(np.bitwise_xor.reduce(
        (cluster_of.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
        ^ np.arange(len(cluster_of), dtype=np.uint64)))


@pytest.fixture(scope="module")
def golden_ml():
    with open(FIXTURE_ML) as f:
        fix = json.load(f)
    p = fix["params"]
    g = synthetic_siot(n=p["n"], target_links=p["target_links"],
                       seed=p["graph_seed"])
    net = build_edge_network(g, p["m"], seed=p["net_seed"],
                             mu_factor=p["mu_factor"])
    cm = CostModel(net, g, workload_for(p["gnn_model"], p["in_dim"]))
    res = glad_s(cm, seed=p["glad_seed"], sweep="batched", multilevel=True,
                 coarsen_to=p["coarsen_to"])
    return fix, cm, res


def test_coarsening_hierarchy_matches_golden(golden_ml):
    fix, cm, _ = golden_ml
    stack = build_levels(cm, coarsen_to=fix["params"]["coarsen_to"])
    assert [l.cm.graph.n for l in stack] == fix["level_sizes"]
    assert ([_cluster_checksum(l.cluster_of) for l in stack[1:]]
            == fix["cluster_checksums"])


def test_finest_refinement_matches_golden_bit_for_bit(golden_ml):
    fix, _, res = golden_ml
    finest = res.levels[-1]
    assert finest["level"] == 0 and finest["role"] == "refine"
    assert int(finest["active"].sum()) == fix["active_count"]
    assert finest["R"] == fix["refine_R"]
    assert finest["iterations"] == fix["iterations"]
    assert finest["accepted"] == fix["accepted"]
    got_hex = [np.float64(h).hex() for h in finest["history"]]
    assert got_hex == fix["history_hex"]
    assert np.float64(finest["cost"]).hex() == fix["final_cost_hex"]
    np.testing.assert_array_equal(res.assign, np.array(fix["assign"]))


def test_flat_replay_of_finest_level_matches_golden_bit_for_bit(golden_ml):
    """Run the flat engine from the V-cycle's recorded projected init and
    boundary mask: it must walk the committed trajectory exactly."""
    fix, cm, res = golden_ml
    finest = res.levels[-1]
    replay = glad_s(cm, R=finest["R"], init=finest["init"],
                    active=finest["active"],
                    seed=fix["params"]["glad_seed"], sweep="batched")
    assert replay.iterations == fix["iterations"]
    assert replay.accepted == fix["accepted"]
    assert ([np.float64(h).hex() for h in replay.history]
            == fix["history_hex"])
    assert np.float64(replay.cost).hex() == fix["final_cost_hex"]
    np.testing.assert_array_equal(replay.assign, np.array(fix["assign"]))


def test_reused_level_stack_replays_golden_bit_for_bit(golden_ml):
    """The persistent LevelStack: a V-cycle run whose coarsening was
    served ENTIRELY off a reused cached hierarchy (zero rebuilt levels)
    must still walk the committed finest-refinement trajectory hex-for-hex
    and land on the committed assign."""
    fix, cm, _ = golden_ml
    p = fix["params"]
    ses = LayoutSession()
    kw = dict(seed=p["glad_seed"], sweep="batched", multilevel=True,
              coarsen_to=p["coarsen_to"], session=ses)
    first = glad_s(cm, **kw)                    # builds + caches the stack
    assert first.coarsen["mode"] == "build"
    res = glad_s(cm, **kw)                      # replays through the cache
    assert res.coarsen["mode"] == "refresh"
    assert res.coarsen["rebuilt"] == 0
    assert res.coarsen["reused"] == len(fix["cluster_checksums"])
    finest = res.levels[-1]
    assert ([np.float64(h).hex() for h in finest["history"]]
            == fix["history_hex"])
    assert np.float64(finest["cost"]).hex() == fix["final_cost_hex"]
    np.testing.assert_array_equal(res.assign, np.array(fix["assign"]))


def test_golden_multilevel_fixture_is_self_consistent(golden_ml):
    fix, cm, _ = golden_ml
    assert cm.total(np.array(fix["assign"])) == pytest.approx(
        fix["final_cost"], rel=1e-12)
    h = np.array(fix["history"])
    assert (np.diff(h) <= 1e-9).all()
    assert h[-1] == pytest.approx(fix["final_cost"], rel=1e-12)
    assert fix["accepted"] >= 1      # the pinned refinement really moves
    assert len(fix["level_sizes"]) == len(fix["cluster_checksums"]) + 1
