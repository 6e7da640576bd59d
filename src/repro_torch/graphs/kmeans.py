"""Plain Lloyd k-means (paper Sec. VI-A uses k-means on client coordinates to
pick edge-server locations [95][96]).  numpy-only, deterministic given seed.

The port's copy of ``repro.graphs.kmeans``, with ``repro`` renamed ``repro_torch``.
"""
from __future__ import annotations

import numpy as np


def kmeans(points: np.ndarray, k: int, iters: int = 50, seed: int = 0):
    """Return (centers (k,d), assign (n,))."""
    rng = np.random.default_rng(seed)
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    if k >= n:
        centers = pts.copy()
        extra = pts[rng.integers(0, n, size=k - n)] if k > n else pts[:0]
        centers = np.concatenate([centers, extra], axis=0)
        return centers, np.arange(n) % k
    # k-means++ style init for stability.
    centers = [pts[rng.integers(0, n)]]
    for _ in range(k - 1):
        d2 = np.min(
            ((pts[:, None, :] - np.array(centers)[None]) ** 2).sum(-1), axis=1
        )
        p = d2 / max(d2.sum(), 1e-12)
        centers.append(pts[rng.choice(n, p=p)])
    centers = np.array(centers)
    assign = np.zeros(n, dtype=np.int64)
    for _ in range(iters):
        d2 = ((pts[:, None, :] - centers[None]) ** 2).sum(-1)
        new_assign = d2.argmin(axis=1)
        if np.array_equal(new_assign, assign) and _ > 0:
            break
        assign = new_assign
        for c in range(k):
            mask = assign == c
            if mask.any():
                centers[c] = pts[mask].mean(axis=0)
    return centers, assign
