"""A configuration, a cell, a traffic generator, a traffic mix and a
per-layer metric added as files and entries in a copy of the benchmark
are found by name, with no file of the benchmark edited."""
import hashlib
import json
import textwrap

from bench.tests import copies

KIND = textwrap.dedent('''
    """A probe generator: infer's under another end-to-end metric."""
    from bench.traffic import infer

    METRIC = "probe_ms"


    class Traffic(infer.Traffic):
        def window(self, res):
            return {METRIC: res["seconds"] / max(res["steps"], 1) * 1e3}
''')
READER = textwrap.dedent('''
    """A probe metric: the rows of the plan's blocks."""


    def read(ctx, name):
        return float(ctx.system.counts["rows"])
''')


def digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted((root / "bench").rglob("*.py"))}


def test_added_files_are_found(tmp_path):
    root = copies.checkout(tmp_path)
    before = digests(root)
    cell = copies.add_tiny(root, "gcn", "infer")
    (root / "bench/traffic/probe.py").write_text(KIND)
    (root / "bench/metrics/probe_rows.py").write_text(READER)
    wl = (root / "bench/workloads" / f"{cell}.json").read_text()
    probe, ring8 = "tiny-gcn.probe", "tiny-gcn.ring8"
    # A generator of its own, and a mix that an existing generator reads.
    (root / "bench/traffic/probe.json").write_text(json.dumps(
        {"generator": "probe", "params": {"ring": 16, "warmup": 3}}))
    (root / "bench/traffic/infer_ring8.json").write_text(json.dumps(
        {"generator": "infer", "params": {"ring": 8, "warmup": 2}}))
    for name in (probe, ring8):
        (root / "bench/workloads" / f"{name}.json").write_text(wl)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": probe, "config": "tiny-gcn",
                              "traffic": "probe", "chips": 1, "why": "t"})
    spec["workloads"].append({"name": ring8, "config": "tiny-gcn",
                              "traffic": "infer_ring8", "chips": 1,
                              "why": "t"})
    next(m for m in spec["end_to_end"]
         if m["name"] == "infer_ms")["workloads"].append(ring8)
    spec["end_to_end"].append({"name": "probe_ms", "unit": "ms",
                               "better": "lower", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": [probe]})
    spec["per_layer"].append({"name": "probe_rows", "unit": "rows",
                              "better": "lower", "source": "program_counter",
                              "layer": "plan", "moves": "infer_ms",
                              "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    code, last, err = copies.run(root, probe)
    assert code == 0, err[-3000:]
    assert set(last["metrics"]) == {"probe_ms", "layout_cost", "setup_s"}
    assert last["correct"] is True

    code, last, err = copies.run(root, ring8)
    assert code == 0, err[-3000:]
    assert set(last["metrics"]) == {"infer_ms", "layout_cost", "setup_s"}
    assert last["correct"] is True and last["answers_compared"] <= 16

    code, last, err = copies.run(root, cell, trace=1)
    assert code == 0, err[-3000:]
    assert last["metrics"]["probe_rows"]["value"] > 0
    assert "row_use.infer" in last["metrics"]
    assert "busy_s" in last["device"] and "breakdown" in last

    after = digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
