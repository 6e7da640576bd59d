"""The SIoT-like data graph, frozen: a copy of
``repro_torch.graphs.datagraph.synthetic_siot`` (paper Sec. VI-A, Fig. 6:
a long-tail degree distribution by preferential attachment, 8,001
vertices, 33,509 links, 52-d features, binary labels).  The same
arguments give the same bits."""
from __future__ import annotations

import numpy as np


def canonical(edges: np.ndarray, n: int) -> np.ndarray:
    """Deduplicated, sorted undirected edges u < v, self loops dropped."""
    if edges.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    e = e[e[:, 0] != e[:, 1]]
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    _, idx = np.unique(lo * n + hi, return_index=True)
    return np.stack([lo[idx], hi[idx]], axis=1)


def generate(n: int = 8001, target_links: int = 33509, feat_dim: int = 52,
             seed: int = 0, area: float = 10.0) -> dict:
    rng = np.random.default_rng(seed)
    m = max(1, int(round(target_links / max(n - 1, 1))))
    src, dst = [], []
    seed_n = m + 1
    for a in range(seed_n):
        for b in range(a + 1, seed_n):
            src.append(a), dst.append(b)
    targets = list(range(seed_n)) * 2
    for v in range(seed_n, n):
        picks = rng.choice(len(targets), size=m, replace=False)
        chosen = {targets[p] for p in picks}
        for u in chosen:
            src.append(u), dst.append(v)
            targets.append(u)
        targets.extend([v] * len(chosen))
    e = canonical(np.stack([np.array(src), np.array(dst)], axis=1), n)
    if len(e) > target_links:
        keep = rng.choice(len(e), size=target_links, replace=False)
        e = e[keep]
    while len(e) < target_links:
        extra = rng.integers(0, n, size=(target_links - len(e), 2))
        e = canonical(np.concatenate([e, extra]), n)
    feats = rng.normal(size=(n, feat_dim)).astype(np.float32)
    labels = (feats[:, 0] + 0.5 * feats[:, 1] > 0).astype(np.int64)
    coords = rng.uniform(0, area, size=(n, 2)).astype(np.float32)
    return {"n": n, "edges": canonical(e, n), "features": feats,
            "labels": labels, "coords": coords}
