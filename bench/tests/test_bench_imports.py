"""Nothing the benchmark runs imports JAX or the JAX package, the plain
reference imports nothing of the program, and a run with no card or with
no program prints no result."""
import ast
import json
import os
import subprocess
import sys

import pytest

from bench.tests import copies

BENCH = copies.REPO / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".", 1)[0]


def sources(*parts):
    return [p for p in (BENCH.joinpath(*parts)).rglob("*.py")
            if "tests" not in p.relative_to(BENCH).parts]


@pytest.mark.parametrize("path", sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_package(path):
    assert not set(imported(path)) & FORBIDDEN
    assert "benchmarks/" not in path.read_text()


@pytest.mark.parametrize("path", sources("ref"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(imported(path))


LATE = """import sys
import types


def read(ctx, name):
    sys.modules["jax"] = types.ModuleType("jax")
    return 1.0
"""


@pytest.mark.parametrize("when", ["start", "reader"])
def test_run_refuses_a_loaded_jax(tmp_path, when):
    """A JAX module found when the result is due refuses it, whether it
    came before the window or with a per-layer reader after it."""
    root = copies.checkout(tmp_path)
    cell = copies.add_tiny(root, "gcn", "infer")
    prelude, trace = "", 0
    if when == "start":
        prelude = "import types\nsys.modules['jax'] = types.ModuleType('jax')"
    else:
        (root / "bench/metrics/late_jax.py").write_text(LATE)
        spec = json.loads((root / "BENCHMARK.json").read_text())
        spec["per_layer"].append({
            "name": "late_jax", "unit": "x", "better": "lower",
            "source": "program_counter", "layer": "plan",
            "moves": "infer_ms", "workloads": [cell]})
        (root / "BENCHMARK.json").write_text(json.dumps(spec))
        trace = 1
    code, last, err = copies.run(root, cell, prelude=prelude, trace=trace)
    assert code != 0 and last is None
    assert "jax" in err


def run_cli(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "siot-gcn.infer",
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def no_result(proc):
    return proc.returncode != 0 and not any(
        ln.startswith("{") for ln in proc.stdout.splitlines())


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert no_result(run_cli(copies.REPO))


def test_no_program_no_result(tmp_path):
    import shutil
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(copies.REPO / "BENCHMARK.json", tmp_path)
    assert no_result(run_cli(tmp_path))
