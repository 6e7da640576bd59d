"""The port's dry-run (``python -m repro_torch.launch.dryrun``) on pod16x16,
in one subprocess over a fake process group of 256 ranks: llama3.2-1b
``train_4k`` and deepseek-moe-16b ``prefill_32k``, whose per-device
``argument_bytes`` equal the reference dry-run's (243,949,572 and
2,054,082,560: exact functions of the specs and dtypes), with the
reference's roofline gate (``tests/test_dryrun_integration.py``), FSDP
all-gathers and TP all-reduces counted; and llama3.2-1b ``decode_32k``,
one decode step against its 32k cache split by sequence over ``model``,
its argument bytes the reference's (691,474,976: weights, tokens and
cache)."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

PINNED = {("llama3.2-1b", "train_4k"): 243_949_572,
          ("deepseek-moe-16b", "prefill_32k"): 2_054_082_560}
DECODE = ("llama3.2-1b", "decode_32k")
DECODE_ARGUMENT_BYTES = 691_474_976


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    cells = ",".join(f"{a}:{s}" for a, s in list(PINNED) + [DECODE])
    env = dict(os.environ)
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells", cells,
         "--out", str(out)], env=env, capture_output=True, text=True,
        timeout=600)
    recs = {}
    for arch, shape in list(PINNED) + [DECODE]:
        with open(out / "pod16x16" / f"{arch}__{shape}.json") as f:
            recs[(arch, shape)] = json.load(f)
    return r, recs


def test_cli_summary_line(records):
    r, _ = records
    assert r.returncode == 0
    assert "dry-run pod16x16: 3 ok, 0 skipped, 0 failed" in r.stdout, \
        r.stdout + r.stderr[-4000:]


@pytest.mark.parametrize("cell", list(PINNED), ids=lambda c: f"{c[0]}-{c[1]}")
def test_pinned_argument_bytes_and_roofline(records, cell):
    rec = records[1][cell]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["devices"] == 256
    mem = rec["memory"]
    assert mem["argument_bytes"] == PINNED[cell]
    assert mem["peak_estimate_bytes"] >= mem["argument_bytes"]
    rf = rec["roofline"]
    assert 0 < rf["useful_ratio"] <= 1.5
    assert rf["bottleneck"] in ("compute", "memory", "collective")
    assert rf["flops_per_device"] == rec["cost"]["flops"] > 0
    assert rf["hbm_bytes_per_device"] == rec["cost"]["bytes accessed"] > 0
    assert rf["collectives"]["all-reduce"] > 0          # TP
    if cell[1] == "train_4k":
        assert rf["collectives"]["all-gather"] > 0      # FSDP
        assert rf["collectives"]["reduce-scatter"] > 0  # FSDP's adjoint
        # The step's in-place update: its outputs are its arguments, all
        # but the batch's (the optimizer's step counter too, since it is
        # bumped in place).
        assert mem["alias_bytes"] == mem["argument_bytes"] - 524_288


def test_decode_cell_runs_pinned(records):
    """The decode cell runs: one ``decode_step``, its argument
    bytes the reference's, the cache laid out by sequence (the KV heads'
    8 do not divide 16), K2's stats gathered over ``model`` and the TP
    reductions counted, and the record naming the torch that counted
    it."""
    rec = records[1][DECODE]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["memory"]["argument_bytes"] == DECODE_ARGUMENT_BYTES
    rf = rec["roofline"]
    assert rf["flops_per_device"] > 0
    assert rf["collectives"]["all-gather"] > 0
    assert rf["collectives"]["all-reduce"] > 0
    assert rec["torch"] == torch.__version__
