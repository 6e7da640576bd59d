"""One run of one cell, as ``bench/run.py`` makes it.

The cell (``BENCHMARK.json``'s ``workloads`` entry and its file of
limits, ``bench/workloads/<name>.json``), its configuration
(``bench/configs/<config>.json``), the system under test that the
configuration names (``bench/systems/<system>.py``, ``layout`` where it
names none), its traffic mix (``bench/traffic/<traffic>.json``: the
generator that reads it, ``bench/traffic/<generator>.py``, and its
parameters) and the reader of each per-layer metric
(``bench/metrics/<name>.py``, or ``<name up to its last dot>.py``, which
serves every suffix) are found by name: adding a cell, a configuration, a
system, a mix, a generator or a metric adds files and entries and edits
none; a mix that an existing generator reads adds data alone.

A system module imports the program it drives and gives:

* ``load_kernels(config, device) -> bool``: loads the program's kernel
  library where the configuration's path uses it (on a checkout's first
  run it builds it); whether it did;
* ``System(config, device, graphs)``: the configuration built (``graphs``
  None lets the program capture CUDA graphs, False keeps it eager), with
  ``timings`` (seconds of its set-up's parts, by name);
  ``checks(limits) -> {name: (value, limit)}``, its own comparisons;
  ``values() -> {name: value}``, the end-to-end metrics it gives beside
  the traffic's; ``flops(train) -> float``, the floating-point operations
  of a step (with ``train`` a training step), and ``peak_ops_per_s``, the
  card's peak in the precision it computes in, for the whole step's
  share; ``release()``, which drops the program's entry and its device
  state; and ``model`` and ``dims``, where it has them, for the readers
  of the GNN layers.

A run: set-up (the system's module and with it the program imported, its
kernel library loaded where the cell's path uses it, the configuration
built, the cell's inputs drawn from the seed, the program's entry made
and warmed up) up to ``setup_s``; the measured window; with ``--trace 1``
traced windows after it; the card's peak memory; then, with the program
released, the system's checks and the traffic's comparison with the
plain reference; last, the look for modules of the JAX stack.  The last
line of standard output is the result."""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# Calls in flight in the window's loop.
DEPTH = 8
# The traced window's length, in steps of the measured window's mean,
# between TRACE_STEPS.
TRACE_SECONDS = 0.5
TRACE_STEPS = (8, 1000)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(spec_: dict, name: str) -> dict:
    """The workload entry of ``BENCHMARK.json`` with its ``limits`` (its
    file) and its traffic mix's ``generator`` and ``params``."""
    entry = next((w for w in spec_["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"bench: no workload {name!r} in BENCHMARK.json")
    mix = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    return {**entry, "limits": load_json(
        HERE / "workloads" / f"{name}.json")["limits"],
        "generator": mix["generator"], "params": mix["params"]}


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def system_module(conf: dict):
    """The system under test that a configuration names."""
    return importlib.import_module(
        f"bench.systems.{conf.get('system', 'layout')}")


def generator(name: str):
    """The traffic generator ``bench/traffic/<name>.py``."""
    return importlib.import_module(f"bench.traffic.{name}")


def reader(name: str):
    """The module that reads the per-layer metric ``name``."""
    for stem in (name, name.rsplit(".", 1)[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            mod_spec = importlib.util.spec_from_file_location(
                f"bench.metrics.{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(mod_spec)
            mod_spec.loader.exec_module(mod)
            return mod
    raise SystemExit(f"bench: no reader for metric {name!r}")


def reports(metric: dict, cell_name: str) -> bool:
    """Whether the cell reports a metric: listed for it, or with no list,
    every cell."""
    return "workloads" not in metric or cell_name in metric["workloads"]


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and (
        out.stdout.strip()) else "not read"


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_for(wl: dict, device):
    """(device, graphs) of the run; None when the card the cell needs is
    not there.  ``device`` None asks for the card (a test passes "cpu",
    which runs the program's eager path)."""
    import torch
    if device is not None:
        return torch.device(device), False
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < wl["chips"]):
        print(f"bench: the cell needs {wl['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return None
    torch.cuda.set_device(0)
    return torch.device("cuda", 0), None


def set_up(wl: dict, seed: int, dev, graphs, started: float):
    """The configuration built and the cell's traffic ready: (system,
    traffic, setup_s, the set-up's parts in seconds).  ``build_s`` is the
    kernel library's load, which on a checkout's first run builds it."""
    import torch
    conf = config(wl["config"])
    systems = system_module(conf)     # imports the program
    parts = {"imports": time.perf_counter() - started}
    if dev.type == "cuda":
        mark = time.perf_counter()
        torch.zeros(1, device=dev)
        parts["cuda_init"] = time.perf_counter() - mark
        mark = time.perf_counter()
        if systems.load_kernels(conf, dev):
            parts["build_s"] = time.perf_counter() - mark
    mark = time.perf_counter()
    system = systems.System(conf, dev, graphs)
    parts["system"] = time.perf_counter() - mark
    mark = time.perf_counter()
    traffic = generator(wl["generator"]).Traffic(system, seed,
                                                 wl["params"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts["traffic"] = time.perf_counter() - mark
    parts.update(system.timings)
    gc.collect()
    return system, traffic, time.perf_counter() - started, parts


def judge(system, traffic, limits: dict) -> tuple:
    """Every number compared, with its limit: the system's own checks,
    then the traffic's comparison with the plain reference."""
    compared = system.checks(limits)
    numbers, answers, failed = traffic.check(limits)
    compared.update(numbers)
    return compared, answers, failed


def main(argv, started: float, device: str = None) -> int:
    """Runs the cell once and prints its result; the exit code."""
    args = parse(argv)
    spec_ = spec()
    wl = cell(spec_, args.workload)
    picked = device_for(wl, device)
    if picked is None:
        return 2
    dev, graphs = picked
    import torch
    from bench import loop, trace
    from bench.checks import passes
    system, traffic, setup_s, parts = set_up(wl, args.seed, dev, graphs,
                                             started)

    res = loop.run(traffic.call, args.seconds, DEPTH, dev)
    summary = None
    if args.trace:
        step_s = res["seconds"] / max(res["steps"], 1)
        lo, hi = TRACE_STEPS
        steps = int(min(max(TRACE_SECONDS / step_s, lo), hi))
        summary = trace.traced(traffic.call, steps, DEPTH, dev, res["next"])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    ctx = SimpleNamespace(
        system=system, train=traffic.train,
        mode=getattr(traffic, "mode", None), window=res, summary=summary,
        timings=system.timings, device=dev,
        model=getattr(system, "model", None),
        dims=getattr(system, "dims", None))
    traffic.release()
    system.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    compared, answers, failed = judge(system, traffic, wl["limits"])

    e2e = [m for m in spec_["end_to_end"] if reports(m, args.workload)]
    metrics = {}
    if args.trace:
        for m in spec_["per_layer"]:
            if reports(m, args.workload):
                v = reader(m["name"]).read(ctx, m["name"])
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, **system.values(),
                  **traffic.window(res)}
        missing = [m["name"] for m in e2e if m["name"] not in values]
        if missing:
            print(f"bench: nothing measures {missing}", file=sys.stderr)
            return 4
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e}

    cuda = dev.type == "cuda"
    result = {"correct": all(passes(v, lim) for v, lim in compared.values()),
              "attempted": res["steps"], "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else dev.type,
                         "kind": (torch.cuda.get_device_name(dev) if cuda
                                  else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if summary is not None:
        result["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
        result["breakdown"] = trace.breakdown(summary)
    result["card"] = card_line() if cuda else "cpu"
    result["setup_parts"] = parts
    result["answers_compared"] = answers
    result["checks"] = {k: {"value": _finite(v), "limit": lim}
                        for k, (v, lim) in compared.items()}
    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for k, (v, lim) in compared.items():
        print(f"check {k} = {v!r} limit {lim!r} "
              f"{'ok' if passes(v, lim) else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
