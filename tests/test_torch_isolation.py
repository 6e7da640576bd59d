"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import with
``jax`` and the JAX package blocked, import neither in their sources, and
the smoke script refuses to report success without a card."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"

_BLOCKED_IMPORT = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                    and (m in ("jax", "repro") or m.startswith(
                        ("jax.", "jaxlib", "repro."))))
    print("IMPORTED", len(names), "LEAKED", leaked)
    print("NAMES", " ".join(names))
""")


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_imports_with_jax_and_reference_blocked():
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, str(SMOKE)],
                       env=_env(), capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout, r.stdout
    count = int(r.stdout.split("IMPORTED")[1].split()[0])
    assert count >= 73, r.stdout                 # every module was walked
    names = r.stdout.split("NAMES")[1].split()
    for mod in ("models.transformer", "serve.engine", "launch.serve",
                "kernels.flash_attention", "configs.registry",
                "core.glad_s", "core.engine", "core.multilevel_stream",
                "runtime.fault", "gnn.training", "train.checkpoint",
                "launch.train_gnn", "train.optim", "train.data",
                "train.step", "launch.train", "launch.quickstart",
                "launch.adaptive_relayout", "launch.serve_gnn",
                "launch.expert_placement", "launch.serve_lm",
                "launch.mesh", "launch.sharding", "launch.hlo",
                "launch.dryrun"):
        assert f"repro_torch.{mod}" in names, mod


def test_sources_import_no_jax_and_no_reference():
    files = sorted(PORT.rglob("*.py")) + [SMOKE]
    assert len(files) >= 50
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                if mod.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {mod}")
    assert bad == []


def test_chip_smoke_fails_without_a_card():
    r = subprocess.run([sys.executable, str(SMOKE)], env=_env(),
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no CUDA device" in r.stderr
