"""A run whose timed path is broken underneath comes out not correct: each
fault of ``bench/faults.py`` planted in the program, in a whole run of a
small cell of each kind and model (the harness's look for a chip
skipped; the program's eager CPU path)."""
import pytest

from bench import faults
from bench.tests import copies


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = copies.checkout(tmp_path_factory.mktemp("faults"))
    for model in ("gcn", "gat"):
        for kind in ("infer", "train"):
            copies.add_tiny(root, model, kind)
    return root


CELLS = ["tiny-gcn.infer", "tiny-gat.infer", "tiny-gcn.train",
         "tiny-gat.train"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    code, last, err = copies.run(root, cell)
    assert code == 0, err[-3000:]
    assert last["correct"] is True, last["checks"]
    assert list(last)[-1] == "checks"


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(root, cell, fault):
    kind = cell.split(".")[1]
    prelude = (f"from bench import faults\n"
               f"faults.plant({fault!r}, {kind!r})")
    code, last, err = copies.run(root, cell, seconds=2.0, prelude=prelude)
    assert code == 0, err[-3000:]
    assert last["attempted"] >= 16        # a whole pass over the ring
    assert last["correct"] is False, last["checks"]
    assert "FAILED" in err
