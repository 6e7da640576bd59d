"""The plain reference against the program's eager CPU path
(``graphs=False``) on a small SIoT graph over 8 servers: the BSP forward
and one distributed train step, for both models; and the layout system's
interface to the harness."""
import json

import pytest
import torch

from bench import harness
from bench.ref.common import Precision, graph_tensors, sgd
from bench.systems import layout
from bench.systems.layout import System, model_module

from bench.tests.copies import REPO, TINY_GRAPH

F64 = Precision(torch.float64)


def small_system(model: str) -> System:
    cfg = json.loads((REPO / "bench/configs" / f"siot-{model}.json")
                     .read_text())
    cfg.update(graph=TINY_GRAPH, layer_dims=[12, 16, 2])
    return System(cfg, torch.device("cpu"), graphs=False)


@pytest.fixture(scope="module", params=["gcn", "gat"])
def system(request):
    return small_system(request.param)


def data(system, seed=3):
    gen = torch.Generator().manual_seed(seed)
    params = system.params(gen)
    x = torch.randn((system.graph["n"], system.dims[0]), generator=gen)
    return params, x


def test_layout_is_checked(system):
    assert system.layout.assign_bad == 0
    assert system.layout.row_map_bad == 0
    assert system.plan.local.shape[0] == 8


def test_forward_matches_the_reference(system):
    params, x = data(system)
    fwd = system.forward()
    assert not fwd.graphs
    out = system.gather(fwd(params, system.scatter(x)))
    ref = system.model.forward(params, x, graph_tensors(
        system.graph["n"], system.graph["edges"], "cpu"), F64)
    err = (out.double() - ref).abs().max() / ref.abs().max()
    assert float(err) < 1e-5


def test_train_step_matches_the_reference(system):
    params, x = data(system, seed=4)
    labels = (x[:, 0] > 0).long()
    n = system.graph["n"]
    step = system.train_step(system.scatter(labels),
                             system.scatter(torch.ones(n)), lr=0.1)
    new, loss = step(params, system.scatter(x))
    graph = graph_tensors(n, system.graph["edges"], "cpu")
    ref_losses, _, ref_after = sgd(system.model, params, x, labels, graph,
                                   0.1, 1, F64)
    assert abs(float(loss) - float(ref_losses[0])) < 1e-6
    for got, want in zip(new, ref_after[0]):
        for k in want:
            assert torch.allclose(got[k].double(), want[k], rtol=0,
                                  atol=1e-6), k


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_reference_matches_the_programs_whole_graph_model(model):
    from repro_torch.gnn import GNNConfig
    from repro_torch.gnn.models import directed_edges, forward
    system = small_system(model)
    params, x = data(system, seed=5)
    edges = system.graph["edges"]
    want = forward(GNNConfig(model, system.dims), params, x,
                   torch.from_numpy(directed_edges(edges)))
    got = model_module(model).forward(params, x, graph_tensors(
        system.graph["n"], edges, "cpu"), F64)
    assert torch.allclose(got, want.double(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("config", ["siot-gcn", "siot-gat"])
def test_configuration_resolves_to_layout(config):
    assert "system" not in harness.config(config)
    assert harness.system_module(harness.config(config)) is layout


def test_layout_checks_and_values(system):
    got = system.checks({"cost_gap": 1e-9})
    assert list(got) == ["assign_bad", "row_map_bad", "cost_gap"]
    assert got["assign_bad"] == (0, 0) and got["row_map_bad"] == (0, 0)
    assert got["cost_gap"][1] == 1e-9 and got["cost_gap"][0] < 1e-9
    assert system.values() == {"layout_cost": system.layout_cost}


@pytest.mark.parametrize("train", [False, True])
def test_layout_flops_are_the_references(system, train):
    ref = model_module(system.config["model"])
    assert system.flops(train) == ref.flops(system.counts, system.dims,
                                            train)
    assert system.peak_ops_per_s == 67e12
