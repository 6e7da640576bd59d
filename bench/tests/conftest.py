"""The benchmark's own tests: ``python -m pytest bench/tests`` from the
root of the repository.  The program (``src``) and the checkout's root are
put on the path, as ``bench/run.py`` puts them."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
