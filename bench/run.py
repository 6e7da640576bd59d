"""Runs one cell of the port's benchmark once:

    python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices
(it exits with a non-zero code, and prints no result, without them).
It builds the program's kernels into ``build/`` in the checkout on its
first run there and reuses them after.  The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``,
each number compared with the plain reference beside its limit (also
printed as the last lines of standard error)."""
import os
import sys
import time

STARTED = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")
# Every build and kernel cache at a fixed path inside the checkout.
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(BUILD, "inductor")
# The checkout and its program on the path, in place of this folder.
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

if __name__ == "__main__":
    from bench import harness
    sys.exit(harness.main(sys.argv[1:], STARTED))
