"""A copy of the benchmark in a temporary checkout, with tiny cells added
as files (nothing of the copy edited), and a run of it in a child process
on the CPU through the harness's test entry."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY_GRAPH = {"generator": "siot",
              "params": {"n": 300, "target_links": 1000, "feat_dim": 12,
                         "seed": 0}}


def checkout(tmp: Path) -> Path:
    """``BENCHMARK.json`` and ``bench/`` copied under ``tmp``, with
    ``src`` linked in as the program."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    os.symlink(REPO / "src", root / "src")
    return root


def add_tiny(root: Path, model: str, kind: str,
             limits: dict = None) -> str:
    """A tiny configuration of ``model`` and a cell of traffic ``kind``
    over it, added as files and entries; returns the cell's name."""
    base = json.loads((REPO / "bench/configs" / f"siot-{model}.json")
                      .read_text())
    name = f"tiny-{model}"
    cfg = dict(base, name=name, graph=TINY_GRAPH, layer_dims=[12, 16, 2])
    (root / "bench/configs" / f"{name}.json").write_text(json.dumps(cfg))
    wl_base = json.loads((REPO / "bench/workloads" /
                          f"siot-{model}.{kind}.json").read_text())
    cell = f"{name}.{kind}"
    wl = {"limits": dict(wl_base["limits"], **(limits or {}))}
    (root / "bench/workloads" / f"{cell}.json").write_text(json.dumps(wl))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    like = f"siot-{model}.{kind}"
    spec["configs"].append({"name": name, "source": "test", "file":
                            f"bench/configs/{name}.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": cell, "config": name, "traffic": kind,
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return cell


RUNNER = """
import sys, time
sys.path[0:1] = [{root!r}, {src!r}]
{prelude}
from bench import harness
sys.exit(harness.main({argv!r}, time.perf_counter(), device="cpu"))
"""


def run(root: Path, cell: str, seed: int = 7, seconds: float = 0.3,
        trace: int = 0, prelude: str = "") -> tuple:
    """Runs ``cell`` of the copy at ``root`` on the CPU in a child process,
    with ``prelude`` (Python) run first; returns (exit code, the last line
    of its output as a dict or None, its standard error)."""
    argv = ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    code = RUNNER.format(root=str(root), src=str(root / "src"),
                         prelude=prelude, argv=argv)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    last = None
    if lines:
        try:
            last = json.loads(lines[-1])
        except json.JSONDecodeError:
            last = None
    return proc.returncode, last, proc.stderr
