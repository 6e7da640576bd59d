"""Windows 3 and 4 (``bench/marks.py``): the CPU harness path with
``--trace 1`` on tiny copy cells reports every metric that reads the
program's tracing, and ``program_trace``; the arithmetic over a ring of
marks and a trace; and nothing read from a program without tracing."""
import json
import sys
import types

import pytest

from bench import marks
from bench.tests import copies

NEW = ("exchange_ms", "aggregate_ms", "dense_ms", "gap_share", "launch_ms",
       "halo_use")


@pytest.mark.parametrize("model,kind", [("gcn", "infer"), ("gat", "train")])
def test_traced_run_reports_the_program_metrics(tmp_path, model, kind):
    root = copies.checkout(tmp_path)
    cell = copies.add_tiny(root, model, kind)
    code, last, err = copies.run(root, cell, trace=1)
    assert code == 0, err[-3000:]
    assert last["correct"] is True
    want = {f"{m}.{kind}" for m in NEW} | (
        {"backward_ms.train"} if kind == "train" else set())
    assert want <= set(last["metrics"]), sorted(last["metrics"])
    line, = [ln for ln in err.splitlines()
             if ln.startswith("bench: program_trace ")]
    got = json.loads(line.split(" ", 2)[2])
    layer = (["exchange", "aggregate", "dense"] if model == "gcn"
             else ["exchange", "attention", "messages", "dense"])
    tail = ["loss", "backward", "sgd"] if kind == "train" else []
    assert set(got["phase_ms"]) == {"write", "step", *layer, *tail,
                                    "clone"}
    assert got["drops"] == [0, 0]
    assert got["coverage"] == {"call": 1.0, "graph": 1.0}
    assert 0 <= got["gap_share"] < 100 and got["on_cost"]["marked_ms"] > 0
    assert got["exchange_rows"]["copied"] >= got["exchange_rows"]["live"]
    assert last["metrics"][f"exchange_ms.{kind}"]["value"] == pytest.approx(
        got["phase_ms"]["exchange"])


def test_windows_rebuild_the_run_s_own_mix(tmp_path):
    """Two cells over one configuration whose mixes one generator reads:
    windows 3 and 4 rebuild the traffic of the cell that was run, not of
    the first such cell in ``BENCHMARK.json``."""
    root = copies.checkout(tmp_path)
    first = copies.add_tiny(root, "gcn", "infer")
    cell = "tiny-gcn.ring4"
    (root / "bench/traffic/infer-ring4.json").write_text(json.dumps(
        {"generator": "infer", "params": {"ring": 4, "warmup": 3}}))
    limits = root / "bench/workloads" / f"{first}.json"
    (root / "bench/workloads" / f"{cell}.json").write_text(
        limits.read_text())
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": cell, "config": "tiny-gcn",
                              "traffic": "infer-ring4", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if first in m.get("workloads", ()):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    spy = ("import bench.traffic.infer as T\n"
           "init = T.Traffic.__init__\n"
           "def spy(self, system, seed, params):\n"
           "    print('bench-test mix', params['ring'], file=sys.stderr)\n"
           "    init(self, system, seed, params)\n"
           "T.Traffic.__init__ = spy\n")
    code, last, err = copies.run(root, cell, trace=1, prelude=spy)
    assert code == 0, err[-3000:]
    assert "exchange_ms.infer" in last["metrics"]
    rings = [ln.split()[-1] for ln in err.splitlines()
             if ln.startswith("bench-test mix")]
    assert rings == ["4", "4"]            # the run's set-up, then windows


def _ring(calls=3):
    """Calls of 100 ns of write, 1,000 of graph phases and 50 of clone,
    20 ns apart: (marks, the phases' ns a call)."""
    phases = [("write", 100), ("step", 10), ("exchange", 300),
              ("aggregate", 400), ("dense", 290), ("clone", 50)]
    out, t = [], 1_000
    for _ in range(calls):
        for p, ns in phases:
            out.append((p, t))
            t += ns
        out.append(("idle", t))
        t += 20
    return out, dict(phases)


def test_split_sums_phases_and_the_idle_share():
    ring, per = _ring()
    got = marks.split(ring, 3)
    assert got["phase_ms"] == pytest.approx(
        {p: ns * 1e-6 for p, ns in per.items()})
    call = sum(per.values())
    assert got["gap_share"] == pytest.approx(100 * 40 / (3 * call + 40))
    assert got["coverage"] == {"call": 1.0, "graph": 1.0}
    broken = [m for m in ring if m != ring[4]]           # a lost mark
    assert marks.split(broken, 3)["coverage"]["graph"] == 1.0
    graph = []                                           # a captured call
    for p, t in ring:
        graph += [("exit", t)] if p == "clone" else []
        graph += [(p, t + 5 if p == "clone" else t)]
    got = marks.split(graph, 3)
    assert got["coverage"] == {"call": 1.0, "graph": 1.0}
    assert got["phase_ms"]["exit"] == pytest.approx(5e-6)


def test_clock_and_phases_in_the_trace():
    """One offset maps the ring onto the trace's mark kernels; the kernels
    between two marks fall in the first one's phase, mark kernels not
    counted."""
    ring, _ = _ring(2)
    starts = [t * 1e-3 + 500.0 for _, t in ring]
    starts[5] += 0.002                                  # 2 ns of jitter
    got = marks.clock(ring, starts)
    assert got["pairs"] == len(ring)
    assert got["offset_us"] == pytest.approx(500.0)
    assert got["residual_us"] == pytest.approx(0.002, abs=1e-9)
    epoch = [(p, t + 1_792_349_193_500_591_000) for p, t in ring]
    got = marks.clock(epoch, starts)
    assert got["residual_us"] == pytest.approx(0.002, abs=1e-9)
    ops = [(s, s + 0.001, "mark_kernel(long long*)") for s in starts]
    ops += [(starts[2] + 0.01, starts[2] + 0.2, "gather"),
            (starts[2] + 0.21, starts[2] + 0.25, "roll"),
            (starts[3] + 0.1, starts[3] + 0.3, "spmm_csr_f32_kernel")]
    traced = marks.in_trace(ring, sorted(ops), starts, 2)
    assert traced["exchange"]["kernels"] == 1.0
    assert traced["aggregate"]["kernels"] == 0.5
    assert traced["exchange"]["kernel_ms"] == pytest.approx(0.232e-3 / 2)  # 2 marks
    assert traced["exchange"]["span_ms"] == pytest.approx(0.3e-3)
    assert "idle" not in traced
    check = marks.cross_check({"exchange": 0.12e-3, "dense": 6e-3},
                              traced)
    assert check == {"exchange": True, "dense": False}


def test_on_ring_undoes_a_trace_clock_that_runs_fast():
    """A trace whose device clock runs twice as fast after its second
    mark: the card's operations go back onto the ring's clock (between
    two marks by their share of the interval), the host's spans stay."""
    from torch.autograd import DeviceType

    def ev(name, s, t, kind):
        return types.SimpleNamespace(
            name=name, device_type=kind, is_async=False,
            time_range=types.SimpleNamespace(start=s, end=t))

    ring = [("write", 1_000), ("step", 1_100), ("clone", 1_200)]
    starts = [500.0, 500.1, 500.3]                     # µs
    events = [ev("mark_kernel", s, s + 0.01, DeviceType.CUDA)
              for s in starts]
    events += [ev("gather", 500.2, 500.25, DeviceType.CUDA),
               ev("roll", 500.4, 500.5, DeviceType.CUDA),
               ev("bsp.call", 499.0, 501.0, DeviceType.CPU)]
    got = marks.on_ring(events, ring, starts)
    times = [(e.name, e.time_range.start, e.time_range.end) for e in got]
    assert times[:3] == [("mark_kernel", pytest.approx(s), pytest.approx(t))
                         for s, t in ((500.0, 500.01), (500.1, 500.105),
                                      (500.2, 500.21))]
    assert times[3] == ("gather", pytest.approx(500.15),
                        pytest.approx(500.175))
    assert times[4] == ("roll", pytest.approx(500.3), pytest.approx(500.4))
    assert got[5] is events[5]


def test_a_program_without_tracing_gives_nothing(monkeypatch):
    """A program older than ``repro_torch.tracing``: every reader of the
    program's tracing returns None, and nothing runs."""
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    if "repro_torch" in sys.modules:
        monkeypatch.delattr(sys.modules["repro_torch"], "tracing",
                            raising=False)
    ctx = types.SimpleNamespace(window={"steps": 5, "seconds": 1.0})
    from bench import harness
    for m in NEW + ("backward_ms",):
        assert harness.reader(f"{m}.train").read(ctx, f"{m}.train") is None
    assert ctx.program_trace is None
