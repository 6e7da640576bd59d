"""Placement baselines the paper compares against (Sec. VI-A).

Only ``Random`` is ported in this slice; it is the layout the chip smoke
run uses until GLAD itself is ported.  It draws the same numbers as
``repro.core.baselines.random_layout`` for the same seed, without needing a
``CostModel`` (which only supplied ``n`` and ``m`` there).
"""
from __future__ import annotations

import numpy as np


def random_layout(n: int, m: int, seed: int = 0) -> np.ndarray:
    """Each of ``n`` clients to an arbitrary one of ``m`` servers."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, m, size=n).astype(np.int64)
