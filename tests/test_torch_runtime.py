"""The port's fault runtime (``repro_torch.runtime``) against the reference's
on the scenarios of ``tests/test_runtime.py``: the same heartbeat scripts
give the same sweeps, revivals and stragglers, and the same failure /
straggler / revive sequences give the same relayout events (kinds, devices,
costs to the bit, migrations, move deltas), the same final partition and the
same repriced network."""
import importlib
import time

import numpy as np
import pytest

PKGS = ("repro", "repro_torch")


def _mods(pkg):
    m = {name: importlib.import_module(f"{pkg}.{name}") for name in (
        "core", "core.partition", "graphs", "graphs.edgenet", "runtime")}
    return m


def _cluster(pkg):
    m = _mods(pkg)
    g = m["graphs"].synthetic_yelp(n=200, target_links=300)
    gnn = m["core"].workload_for("gcn", 100)
    net = m["graphs.edgenet"].pod_edge_network(6, g.n, pods=2, seed=0)
    net.rho = np.linspace(0.1, 0.2, 6)
    part = m["core"].data_partition(g, gnn, num_parts=6, net=net, seed=0)
    return m, g, gnn, net, part


def _loaded(m, g, gnn, net, assign):
    cm = m["core"].CostModel(net, g, gnn)
    return m["core.partition"].partition_from_assign(
        g, assign, 6, cm.factors(assign))


def _events(coord):
    return [(e.kind, list(e.devices), np.float64(e.old_cost).hex(),
             np.float64(e.new_cost).hex(), e.migrated,
             None if e.moved is None else np.asarray(e.moved).tolist())
            for e in coord.events]


def _net_arrays(net):
    return {k: np.asarray(getattr(net, k)) for k in (
        "w", "tau", "alpha", "beta", "gamma", "rho", "mu")}


def _failure(pkg):
    m, g, gnn, net, part = _cluster(pkg)
    assign = part.assign.copy()
    assign[:40] = 5
    coord = m["runtime"].ElasticCoordinator(
        net, g, gnn, _loaded(m, g, gnn, net, assign))
    coord.on_failure([5])
    return coord


def _straggler(pkg):
    m, g, gnn, net, part = _cluster(pkg)
    assign = np.zeros(g.n, dtype=np.int64)
    coord = m["runtime"].ElasticCoordinator(
        net, g, gnn, _loaded(m, g, gnn, net, assign))
    coord.on_straggler([0], slow_factor=50.0)
    return coord


def _repeated_failures(pkg):
    m, g, gnn, net, part = _cluster(pkg)
    coord = m["runtime"].ElasticCoordinator(net, g, gnn, part)
    for d in (5, 3, 1):
        coord.on_failure([d], seed=0)
    return coord


def _kill_revive(pkg):
    m, g, gnn, net, part = _cluster(pkg)
    assign = part.assign.copy()
    assign[:40] = 5
    coord = m["runtime"].ElasticCoordinator(
        net, g, gnn, _loaded(m, g, gnn, net, assign))
    coord.on_failure([5], seed=0)
    coord.on_revive([5], seed=0)
    return coord


def _replayed_ops(pkg):
    m, g, gnn, net, part = _cluster(pkg)
    coord = m["runtime"].ElasticCoordinator(net, g, gnn, part)
    coord.on_failure([5], seed=0)
    coord.on_straggler([4], slow_factor=3.0, seed=0)
    coord.on_revive([5], seed=0)
    coord.on_revive([4], seed=0)
    coord.on_straggler([2], slow_factor=4.0, seed=0)
    coord.on_failure([2], seed=0)
    coord.on_revive([2], seed=0)
    return coord


@pytest.mark.parametrize("scenario", [_failure, _straggler,
                                      _repeated_failures, _kill_revive,
                                      _replayed_ops],
                         ids=lambda f: f.__name__.strip("_"))
def test_coordinator_events_and_relayouts_match_reference(scenario):
    ref, port = (scenario(pkg) for pkg in PKGS)
    assert len(port.events) == len(ref.events) > 0
    assert _events(port) == _events(ref)
    np.testing.assert_array_equal(port.part.assign, ref.part.assign)
    np.testing.assert_array_equal(port.part.part_vertices,
                                  ref.part.part_vertices)
    np.testing.assert_array_equal(port.part.halo_src, ref.part.halo_src)
    assert port.part.cut_links == ref.part.cut_links
    rn, pn = _net_arrays(ref.net), _net_arrays(port.net)
    for k in rn:
        np.testing.assert_array_equal(pn[k], rn[k], err_msg=k)


def _detector_script(pkg):
    """The heartbeat scripts of the reference's detector tests, one log."""
    FD = importlib.import_module(f"{pkg}.runtime").FailureDetector
    log = []
    fd = FD(4, timeout_s=10)
    for d in range(4):
        fd.heartbeat(d, now=0.0)
    fd.heartbeat(0, now=12.0)
    log.append(fd.sweep(now=15.0))
    fd.revive(1, now=16.0)
    log += [fd.devices[1].alive, fd.sweep(now=17.0)]
    fd = FD(2, timeout_s=10)
    fd.heartbeat(0, now=0.0)
    fd.heartbeat(1, now=0.0)
    log.append(fd.sweep(now=15.0))
    fd.heartbeat(0, now=16.0, step_time_s=1.0)
    log += [fd.devices[0].alive, fd.devices[0].step_time_ewma,
            fd.sweep(now=17.0)]
    fd.revive(0, now=18.0)
    log += [fd.devices[0].alive, fd.sweep(now=19.0)]
    fd = FD(4)
    for s in range(6):
        for d in range(4):
            fd.heartbeat(d, now=float(s), step_time_s=5.0 if d == 2 else 1.0)
    log += [fd.stragglers(factor=2.0),
            [np.float64(fd.devices[d].step_time_ewma).hex()
             for d in range(4)]]
    fd = FD(4, timeout_s=30.0)
    now = 1.7e9
    log.append(fd.sweep(now))
    fd.heartbeat(0, now=now + 20.0)
    fd.heartbeat(1, now=now + 20.0)
    log.append(fd.sweep(now + 31.0))
    fd = FD(2)
    fd.heartbeat(0, now=1.0, step_time_s=1.0)
    fd.heartbeat(1, now=1.0, step_time_s=10.0)
    log.append(fd.stragglers(factor=2.0))
    fd = FD(2)
    fd.heartbeat(0, now=1.0, step_time_s=10.0)
    log.append(fd.stragglers(factor=2.0))
    return log


def test_failure_detector_matches_reference():
    ref = _detector_script("repro")
    assert _detector_script("repro_torch") == ref
    assert ref[0] == [1, 2, 3] and ref[-3] == [2, 3]


def test_detector_cold_start_on_the_wall_clock():
    from repro_torch.runtime import FailureDetector
    fd = FailureDetector(4, timeout_s=30.0)
    now = time.time()
    assert fd.sweep(now) == []
    fd.heartbeat(0, now=now + 20.0)
    assert fd.sweep(now + 31.0) == [1, 2, 3]
