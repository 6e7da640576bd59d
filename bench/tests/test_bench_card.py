"""On the card: ``bench/run.py`` runs a cell for a second and its last
line is a correct result.  Skips without a CUDA device."""
import json
import subprocess
import sys

import pytest

from bench.tests.copies import REPO


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_run_one_second(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "siot-gcn.infer",
         "--seed", "4000000001", "--seconds", "1", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["correct"] is True, last["checks"]
    assert last["device"]["platform"] == "gpu"
    want = {"infer_ms", "layout_cost", "setup_s"} if not trace else {
        "row_use.infer", "k1_roofline.infer", "idle_share.infer"}
    assert want <= set(last["metrics"])
