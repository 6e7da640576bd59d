"""The port's tracing (``repro_torch.tracing``) on the CPU: spans, marks and
counters, and what they leave untouched.

* Off, nothing is recorded, and the BSP forward and the distributed train
  step give the same bits as with tracing on.
* On, a call's marks come in the documented phase order, a layer at a
  time; its host spans nest under the call's span and share its call id,
  and they appear in a ``torch.profiler`` trace.
* A full ring counts its drops; the counter registry's deltas add back
  per replay; the exchange counts the plan's rows.
* Turning tracing on and off moves neither ``stats['traces']`` nor
  ``stats['builds']``.

The card's side (a marked graph's marks a replay, its bits, the unmarked
graph's kernels) is in ``tests/test_torch_cuda.py``.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch.core import partition_from_assign  # noqa: E402
from repro_torch.gnn import GNNConfig, init_params  # noqa: E402
from repro_torch.gnn import distributed as TD  # noqa: E402
from repro_torch.gnn import plan as TP  # noqa: E402
from repro_torch.gnn.training import make_distributed_train_step  # noqa: E402
from repro_torch.graphs import synthetic_siot  # noqa: E402

LAYER = {"gcn": ["exchange", "aggregate", "dense"],
         "sage": ["exchange", "aggregate", "dense"],
         "gat": ["exchange", "attention", "messages", "dense"]}


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and nothing recorded."""
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _case(model, replicas=False, exchange="ppermute", n=120, P=4):
    g = synthetic_siot(n=n, target_links=3 * n)
    assign = np.random.default_rng(5).integers(0, P, size=g.n)
    plan = TP.compile_plan(g, partition_from_assign(g, assign, P, {}),
                           slack=0.3)
    if replicas:
        TP.set_replication(plan, {0: np.arange(10, 30)})
    cfg = GNNConfig(model, (52, 16, 2))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    fwd = TD.make_bsp_forward(cfg, plan, exchange=exchange, device="cpu")
    blocks = torch.from_numpy(TP.scatter_features(plan, g.features))
    r0 = (torch.from_numpy(TP.scatter_replica_halo(plan, g.features))
          if replicas else None)
    step = make_distributed_train_step(
        cfg, fwd, TP.scatter_ints(plan, g.labels),
        TP.scatter_ints(plan, np.ones(g.n, np.float32)), lr=0.1)
    return plan, params, fwd, step, blocks, r0


def _phases():
    marks, = tracing.read()["marks"].values()
    return [p for p, _ in marks]


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_off_records_nothing_and_on_gives_the_same_bits(model):
    """Off: no span, no mark.  The forward and two train steps with
    tracing on equal those with it off, bit for bit."""
    plan, params, fwd, step, blocks, _ = _case(model)
    before = tracing.read()
    off_out = fwd(params, blocks)
    p, off_loss = step(params, blocks)
    off_p, off_loss2 = step(p, blocks)
    got = tracing.read()
    assert got["spans"] == [] and got["spans"] == before["spans"]
    assert got["marks"] == before["marks"]
    tracing.enable()
    on_out = fwd(params, blocks)
    p, on_loss = step(params, blocks)
    on_p, on_loss2 = step(p, blocks)
    assert tracing.read()["spans"]
    assert torch.equal(off_out, on_out)
    assert torch.equal(off_loss, on_loss) and torch.equal(off_loss2,
                                                          on_loss2)
    for a, b in zip(off_p, on_p):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("replicas", [False, True])
@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_phases_come_in_the_documented_order(model, replicas):
    """A forward call marks write, step, each layer's phases, clone and
    idle; a train step the forward's layers, then loss, backward and sgd.
    The marks' times never run backwards."""
    plan, params, fwd, step, blocks, r0 = _case(model, replicas)
    tracing.enable()
    fwd(params, blocks, replica0=r0)
    layers = LAYER[model] * 2
    assert _phases() == ["write", "step", *layers, "clone", "idle"]
    tracing.clear()
    step(params, blocks, replica0=r0)
    assert _phases() == ["write", "step", *layers, "loss", "backward",
                         "sgd", "clone", "idle"]
    marks, = tracing.read()["marks"].values()
    times = [t for _, t in marks]
    assert times == sorted(times)


def test_spans_nest_under_their_call_with_its_id():
    """Each call is one ``bsp.call`` or ``train.call`` span with a new call
    id; ``plan.sync`` and ``step.key`` lie inside it, name it as their
    parent (the train step's forward one level down) and carry its id."""
    plan, params, fwd, step, blocks, _ = _case("gcn")
    tracing.enable()
    fwd(params, blocks)
    fwd(params, blocks)
    step(params, blocks)
    spans = tracing.read()["spans"]
    by_id = {s["id"]: s for s in spans}
    calls = [s for s in spans if s["name"].endswith(".call")]
    assert [s["name"] for s in calls] == ["bsp.call", "bsp.call",
                                          "train.call"]
    assert len({s["call"] for s in calls}) == 3
    assert all(s["parent"] == -1 for s in calls)
    for s in spans:
        if s in calls:
            continue
        assert s["name"] in ("plan.sync", "step.key"), s
        parent = by_id[s["parent"]]
        assert parent["name"].endswith(".call")
        assert parent["start"] <= s["start"] <= s["end"] <= parent["end"]
        assert s["call"] == parent["call"]
    assert sum(1 for s in spans if s["name"] == "plan.sync") == 3


def test_spans_lie_in_a_profiler_trace():
    """Under an active ``torch.profiler`` every span is also a
    ``record_function`` range: the same names, as often."""
    from torch.profiler import ProfilerActivity, profile
    plan, params, fwd, step, blocks, _ = _case("gcn")
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fwd(params, blocks)
        step(params, blocks)
    names = [e.name for e in prof.events()]
    spans = [s["name"] for s in tracing.read()["spans"]]
    for name in set(spans):
        assert names.count(name) == spans.count(name), name
    tracing.clear()
    fwd(params, blocks)                        # no profiler: no range
    assert tracing.read()["spans"]


def test_a_full_ring_counts_its_drops(monkeypatch):
    """Past its capacity a ring keeps its first marks and counts the
    rest as drops; a clear empties it."""
    monkeypatch.setattr(tracing, "CAPACITY", 5)
    monkeypatch.setattr(tracing, "_rings", {})
    tracing.enable()
    for phase in tracing.PHASES[:8]:
        tracing.mark(phase, "cpu")
    got = tracing.read()
    assert [p for p, _ in got["marks"]["cpu"]] == list(tracing.PHASES[:5])
    assert got["drops"] == {"cpu": 3}
    tracing.clear()
    tracing.mark("idle", "cpu")
    got = tracing.read()
    assert got["marks"]["cpu"][0][0] == "idle" and got["drops"]["cpu"] == 0
    tracing.disable()
    tracing.mark("write", "cpu")
    assert len(tracing.read()["marks"]["cpu"]) == 1


def test_registry_adds_per_replay_deltas(monkeypatch):
    """What a step's capture counted (``since``) comes back out (``add``
    with -1) and goes in again once a replay; counters are looked up at
    each use, so a holder's fresh object is the one counted."""
    holder = types.SimpleNamespace(__name__="probe", n=0, by={"a": 0})
    monkeypatch.setattr(tracing, "_counters", list(tracing._counters))
    tracing.register(holder, "n")
    tracing.register(holder, "by")
    tracing.register(holder, "n")                       # listed once
    assert [c[0] for c in tracing._counters].count("probe.n") == 1
    before = tracing.counters()
    holder.n += 3
    holder.by["a"] += 2
    holder.by["b"] = 1
    delta = tracing.since(before)
    assert delta["probe.n"] == 3 and delta["probe.by"] == {"a": 2, "b": 1}
    tracing.add(delta, -1)                             # the capture's own
    assert holder.n == 0 and holder.by == {"a": 0, "b": 0}
    for _ in range(4):                                 # four replays
        tracing.add(delta)
    assert holder.n == 12 and holder.by == {"a": 8, "b": 4}
    holder.by = {"a": 0}                               # a fresh object
    tracing.add(delta)
    assert holder.by == {"a": 2, "b": 1}


@pytest.mark.parametrize("exchange", ["ppermute", "allgather"])
def test_exchange_counts_the_plan_rows(exchange):
    """A forward adds each layer's copied rows (P x each round's width;
    the allgather P x halo_cap) and the live ones (receives below
    halo_cap; the allgather's real slots), whether tracing is on or not."""
    plan, params, fwd, step, blocks, _ = _case("gcn", exchange=exchange)
    rows = TD.exchange_counts.rows
    if exchange == "ppermute":
        copied = sum(plan.num_parts * r["width"] for r in plan.rounds)
        live = sum(int((r["recv_pos"] < plan.halo_cap).sum())
                   for r in plan.rounds)
    else:
        copied = plan.num_parts * plan.halo_cap
        live = int((plan.halo_slot < plan.num_parts * plan.cap).sum())
    assert 0 < live <= copied
    for on in (False, True):
        (tracing.enable if on else tracing.disable)()
        before = dict(rows)
        fwd(params, blocks)
        assert rows["copied"] - before["copied"] == 2 * copied
        assert rows["live"] - before["live"] == 2 * live
    assert tracing.counters()["exchange.rows"] == rows


def test_toggling_tracing_moves_no_trace_or_build_count():
    """On, off and on again over one signature: one trace, one build, as
    without tracing; nothing captured on the CPU, marked or not."""
    plan, params, fwd, step, blocks, _ = _case("gcn")
    fwd(params, blocks)
    want = (fwd.stats["traces"], fwd.stats["builds"])
    for on in (True, False, True):
        (tracing.enable if on else tracing.disable)()
        fwd(params, blocks)
        step(params, blocks)
        assert (fwd.stats["traces"], fwd.stats["builds"]) == want == (1, 1)
    assert fwd.marked_steps == {} and step.marked_steps == {}
    assert list(fwd.steps.values()) == [None]
