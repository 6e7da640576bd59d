"""A configuration, a cell, a traffic generator, a traffic mix, a
per-layer metric and a system under test with no layout added as files
and entries in a copy of the benchmark are found by name, with no file of
the benchmark edited."""
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
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    e2e["infer_ms"]["workloads"].append(ring8)
    e2e["layout_cost"]["workloads"] += [probe, ring8]
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


# A system with no layout: a zoo smoke configuration's train step.
LM_SYSTEM = textwrap.dedent('''
    """A probe system: the program's LM train step over a zoo smoke
    configuration, with no graph, fleet or layout."""
    import sys

    import repro_torch.models  # noqa: F401  (the program)
    from repro_torch import models as zoo
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step

    FLOPS = 1.25e9
    PEAK = 2.5e12


    def load_kernels(config, device):
        return False


    class System:
        peak_ops_per_s = PEAK

        def __init__(self, config, device, graphs=None):
            self.cfg = get_smoke_config(config["arch"])
            self.device, self.graphs = device, graphs
            self.timings = {}

        def params(self, gen):
            return zoo.init_params(self.cfg, gen, self.device)

        def train_step(self):
            opt = optim.for_model(self.cfg)
            return opt, make_train_step(self.cfg, opt, graphs=self.graphs)

        def checks(self, limits):
            return {}

        def values(self):
            return {}

        def flops(self, train):
            print(f"probe-flops train={train}", file=sys.stderr)
            return FLOPS * (3 if train else 1)

        def release(self):
            pass
''')
LM_KIND = textwrap.dedent('''
    """A probe generator: the LM train step on one batch of tokens drawn
    from the seed; it checks the first step's loss against ln(vocab)."""
    import math

    import torch

    from bench import checks
    from repro_torch.train import optim

    METRIC = "train_step_ms"


    class Traffic:
        train = True

        def __init__(self, system, seed, params):
            dev, cfg = system.device, system.cfg
            gen = torch.Generator(device=dev).manual_seed(seed)
            self.vocab = cfg.vocab
            self.params = system.params(gen)
            opt, self.step = system.train_step()
            self.state = optim.init_opt_state(opt, self.params)
            b, n = int(params["batch"]), int(params["seq_len"])
            tok = torch.randint(1, cfg.vocab, (b, n + 1), generator=gen,
                                device=dev, dtype=torch.int32)
            self.batch = {"tokens": tok[:, :n], "labels": tok[:, 1:]}
            self.losses = []
            self.call(-1)

        def call(self, k):
            self.params, self.state, _, m = self.step(
                self.params, self.state, None, self.batch)
            if len(self.losses) < 1:
                self.losses.append(float(m["loss"]))

        def window(self, res):
            return {METRIC: res["seconds"] / max(res["steps"], 1) * 1e3}

        def release(self):
            self.step = self.params = self.state = None

        def check(self, limits):
            ln_v = math.log(self.vocab)
            gap = abs(self.losses[0] - ln_v) / ln_v
            lim = limits["init_loss_gap"]
            return ({"init_loss_gap": (gap, lim)}, 1,
                    int(not checks.passes(gap, lim)))
''')
# Runs the per-layer readers of mfu.* as on a card, and prints the window
# they read, so the test can work the share out again.
AS_ON_A_CARD = textwrap.dedent('''
    import torch
    from types import SimpleNamespace
    from bench import harness
    _reader = harness.reader


    def _as_on_a_card(name):
        mod = _reader(name)
        if not name.startswith("mfu."):
            return mod

        def read(ctx, name):
            w = ctx.window
            print(f"probe-window {w['seconds']!r} {w['steps']!r}",
                  file=sys.stderr)
            card = SimpleNamespace(**dict(vars(ctx),
                                          device=torch.device("cuda")))
            return mod.read(card, name)
        return SimpleNamespace(read=read)


    harness.reader = _as_on_a_card
''')


def files(root):
    """Every file of the benchmark in a copy, with its digest."""
    paths = [root / "BENCHMARK.json"] + [
        p for p in (root / "bench").rglob("*")
        if p.is_file() and "__pycache__" not in p.parts]
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in paths}


def only_added(old, new) -> bool:
    """Whether ``new`` is ``old`` with entries appended to its lists and
    names appended to its entries' ``workloads``, and nothing else."""
    if isinstance(old, dict):
        return isinstance(new, dict) and old.keys() == new.keys() and all(
            only_added(old[k], new[k]) for k in old)
    if isinstance(old, list):
        return (isinstance(new, list) and len(new) >= len(old)
                and all(only_added(a, b) for a, b in zip(old, new)))
    return old == new


def test_a_system_with_no_layout_enters_by_new_files(tmp_path):
    root = copies.checkout(tmp_path)
    before = files(root)
    spec0 = json.loads((root / "BENCHMARK.json").read_text())
    cell, name = "moe-smoke.train", "moe-smoke"
    (root / "bench/systems/lm_smoke.py").write_text(LM_SYSTEM)
    (root / "bench/traffic/lm_train.py").write_text(LM_KIND)
    (root / "bench/traffic/lm_smoke_train.json").write_text(json.dumps(
        {"generator": "lm_train", "params": {"batch": 2, "seq_len": 32}}))
    (root / "bench/configs" / f"{name}.json").write_text(json.dumps(
        {"name": name, "system": "lm_smoke", "arch": "deepseek-moe-16b"}))
    (root / "bench/workloads" / f"{cell}.json").write_text(json.dumps(
        {"limits": {"init_loss_gap": 0.05}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": name, "source": "test", "file":
                            f"bench/configs/{name}.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": cell, "config": name,
                              "traffic": "lm_smoke_train", "chips": 1,
                              "why": "test"})
    next(m for m in spec["end_to_end"]
         if m["name"] == "train_step_ms")["workloads"].append(cell)
    spec["per_layer"].append({"name": "mfu.lm", "unit": "%",
                              "better": "higher", "source": "host_clock",
                              "layer": "whole step",
                              "moves": "train_step_ms",
                              "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    code, last, err = copies.run(root, cell)
    assert code == 0, err[-3000:]
    assert set(last["metrics"]) == {"train_step_ms", "setup_s"}
    assert set(last["checks"]) == {"init_loss_gap"}
    assert last["correct"] is True, last["checks"]

    code, last, err = copies.run(root, cell, trace=1, prelude=AS_ON_A_CARD)
    assert code == 0, err[-3000:]
    assert set(last["metrics"]) == {"mfu.lm"}
    assert "probe-flops train=True" in err
    seconds, steps = next(ln.split()[1:] for ln in err.splitlines()
                          if ln.startswith("probe-window"))
    step_s = float(seconds) / int(steps)
    assert last["metrics"]["mfu.lm"]["value"] == (
        100.0 * 3 * 1.25e9 / step_s / 2.5e12)
    assert last["correct"] is True

    after = files(root)
    changed = {k for k in before if after.get(k) != before[k]}
    assert changed == {"BENCHMARK.json"}
    assert only_added(spec0, json.loads((root / "BENCHMARK.json")
                                        .read_text()))
