"""The frozen copies in the benchmark give what the program's own
functions give today, at the configurations' seeds."""
import numpy as np
import pytest

from bench.graphs import siot
from bench.yardstick import cost, fleet

from repro_torch.core import CostModel, glad_s, workload_for
from repro_torch.graphs import build_edge_network, synthetic_siot
from repro_torch.graphs.edgenet import EdgeNetwork

FLEET_KEYS = ("w", "tau", "alpha", "beta", "gamma", "rho", "eps", "mu",
              "sku", "coords")


@pytest.fixture(scope="module")
def graphs():
    return siot.generate(), synthetic_siot()


@pytest.fixture(scope="module")
def fleets(graphs):
    ours, port = graphs
    return (fleet.build(ours["coords"], 8, seed=0, mu_factor=2.0),
            build_edge_network(port, 8, seed=0, mu_factor=2.0))


@pytest.mark.parametrize("key", ["edges", "features", "labels", "coords"])
def test_siot_graph_equals_the_program(graphs, key):
    ours, port = graphs
    assert ours["n"] == port.n == 8001
    assert np.array_equal(ours[key], getattr(port, key))
    assert ours[key].dtype == getattr(port, key).dtype


def test_siot_graph_sizes(graphs):
    ours, _ = graphs
    assert ours["edges"].shape == (33509, 2)
    assert (ours["edges"][:, 0] < ours["edges"][:, 1]).all()


@pytest.mark.parametrize("key", FLEET_KEYS)
def test_fleet_equals_the_program(fleets, key):
    ours, port = fleets
    assert np.array_equal(ours[key], getattr(port, key))


@pytest.mark.parametrize("seed,mu", [(1, 0.05), (3, 2.0)])
def test_fleet_equals_the_program_at_other_settings(graphs, seed, mu):
    ours, port = graphs
    a = fleet.build(ours["coords"], 5, seed=seed, mu_factor=mu)
    b = build_edge_network(port, 5, seed=seed, mu_factor=mu)
    for key in FLEET_KEYS:
        assert np.array_equal(a[key], getattr(b, key)), key


def test_small_graph_equals_the_program():
    ours = siot.generate(n=300, target_links=1000, feat_dim=12, seed=5)
    port = synthetic_siot(n=300, target_links=1000, feat_dim=12, seed=5)
    assert np.array_equal(ours["edges"], port.edges)
    assert np.array_equal(ours["features"], port.features)


@pytest.mark.parametrize("model,want", [("gcn", 72772.97), ("gat", 73046.21)])
def test_cost_on_the_programs_layout(graphs, fleets, model, want):
    ours, port = graphs
    mine, theirs = fleets
    net = EdgeNetwork(m=8, **{k: getattr(theirs, k) for k in FLEET_KEYS})
    cm = CostModel(net, port, workload_for(model, 52))
    res = glad_s(cm, seed=0)
    got = cost.total(mine, ours["n"], ours["edges"], model, (52, 16, 2),
                     res.assign)
    assert got == cm.total(res.assign)                 # the same bits
    assert cost.factors(mine, ours["n"], ours["edges"], model, (52, 16, 2),
                        res.assign) == cm.factors(res.assign)
    assert round(got, 2) == want
    assert abs(got - res.cost) / got < 1e-12


@pytest.mark.parametrize("model", ["gcn", "gat", "sage"])
def test_workload_units_equal_the_program(model):
    w = workload_for(model, 52)
    assert cost.workload_units(model, (52, 16, 2)) == (
        w.agg_units, w.upd_units, w.act_units)
