"""Shared fixtures + marker config.  NOTE: no XLA_FLAGS here — smoke tests
must see the real (single) device; only dryrun sets the 512-device flag, and
the multi-device integration tests spawn subprocesses.

Markers: ``slow`` (long property/fuzz runs) and ``bench`` (wall-clock
comparisons).  Tier-1 runs with an implicit ``-m "not slow"``-style default:
when no ``-m`` expression is given, slow/bench tests are deselected so the
default suite stays fast; run them on demand with e.g. ``-m slow``,
``-m bench`` or ``-m "slow or not slow"`` (everything)."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running property/fuzz tests "
        "(deselected unless an -m expression is given)")
    config.addinivalue_line(
        "markers", "bench: wall-clock benchmark tests "
        "(deselected unless an -m expression is given)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one; chip_smoke.py "
        "runs the same checks on the card)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("-m"):
        return                     # an explicit -m expression takes over
    # A test named by node id on the command line was asked for explicitly —
    # run it even without -m (pytest convention: selection beats markers).
    explicit = [a.split("::", 1)[1].split("[", 1)[0]
                for a in config.args if "::" in a]
    skip = pytest.mark.skip(
        reason="slow/bench: deselected by default, pass -m to opt in")
    for item in items:
        if "slow" not in item.keywords and "bench" not in item.keywords:
            continue
        name = item.nodeid.split("::", 1)[-1].split("[", 1)[0]
        if name in explicit:
            continue
        item.add_marker(skip)

try:  # pragma: no cover - exercised only where hypothesis is installed
    import hypothesis  # noqa: F401
except ImportError:
    from tests._hypothesis_fallback import install as _install_hypothesis

    _install_hypothesis()

from repro.core.cost import CostModel, workload_for
from repro.graphs.datagraph import DataGraph, synthetic_siot, synthetic_yelp
from repro.graphs.edgenet import build_edge_network


@pytest.fixture(scope="session")
def small_yelp():
    return synthetic_yelp(n=120, target_links=160)


@pytest.fixture(scope="session")
def small_siot():
    return synthetic_siot(n=150, target_links=450)


@pytest.fixture()
def cm_small(small_yelp):
    net = build_edge_network(small_yelp, 4, seed=0)
    return CostModel(net, small_yelp, workload_for("gcn", 100))


def random_graph(rng, n, extra_edges):
    """Connected-ish random graph for property tests."""
    edges = []
    for v in range(1, n):
        edges.append((rng.integers(0, v), v))
    for _ in range(extra_edges):
        u, v = rng.integers(0, n, size=2)
        if u != v:
            edges.append((min(u, v), max(u, v)))
    g = DataGraph(n=n, edges=np.array(edges))
    g.coords = rng.uniform(0, 10, size=(n, 2)).astype(np.float32)
    g.features = rng.normal(size=(n, 8)).astype(np.float32)
    g.labels = rng.integers(0, 2, size=n)
    return g
