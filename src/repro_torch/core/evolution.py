"""Graph-evolution trace generation (paper Sec. V-A & VI-A).

Per time slot: draw the number of changed links from a Gaussian whose mean is
``pct * |E|`` and std is half of that, then uniformly realize link
insertions/deletions between randomly selected vertices; same recipe for
vertex insertions/deletions.  Changes are restricted to a small extent [75].

The port's copy of ``repro.core.evolution``, with ``repro`` renamed ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.graphs.datagraph import DataGraph


@dataclasses.dataclass
class GraphDelta:
    add_edges: np.ndarray
    del_edges: np.ndarray
    add_vertices: int
    del_vertices: np.ndarray

    @property
    def empty(self) -> bool:
        return (
            len(self.add_edges) == 0 and len(self.del_edges) == 0
            and self.add_vertices == 0 and len(self.del_vertices) == 0
        )


def _gauss_count(rng, mean: float) -> int:
    return max(0, int(round(rng.normal(mean, mean / 2.0))))


def sample_delta(
    graph: DataGraph,
    pct_links: float = 0.01,
    pct_vertices: float = 0.0,
    seed: int = 0,
) -> GraphDelta:
    rng = np.random.default_rng(seed)
    e = graph.edges
    n_changes = _gauss_count(rng, pct_links * max(len(e), 1))

    add_edges, del_edges = [], []
    for _ in range(n_changes):
        if rng.uniform() < 0.5 and len(e):          # deletion
            del_edges.append(e[rng.integers(0, len(e))])
        else:                                        # insertion
            u, v = rng.integers(0, graph.n, size=2)
            if u != v:
                add_edges.append((min(u, v), max(u, v)))

    nv = _gauss_count(rng, pct_vertices * graph.n) if pct_vertices > 0 else 0
    add_vertices, del_vertices = 0, []
    for _ in range(nv):
        if rng.uniform() < 0.5:
            add_vertices += 1
        else:
            del_vertices.append(int(rng.integers(0, graph.n)))
    # New vertices join with a couple of links to existing ones.
    base_n = graph.n
    for k in range(add_vertices):
        vid = base_n + k
        for _ in range(int(rng.integers(1, 4))):
            u = int(rng.integers(0, base_n))
            add_edges.append((min(u, vid), max(u, vid)))

    return GraphDelta(
        add_edges=np.array(add_edges, dtype=np.int64).reshape(-1, 2),
        del_edges=np.array(del_edges, dtype=np.int64).reshape(-1, 2),
        add_vertices=add_vertices,
        del_vertices=np.array(sorted(set(del_vertices)), dtype=np.int64),
    )


def apply_delta(graph: DataGraph, delta: GraphDelta) -> DataGraph:
    return graph.with_changes(
        add_edges=delta.add_edges if len(delta.add_edges) else None,
        del_edges=delta.del_edges if len(delta.del_edges) else None,
        add_vertices=delta.add_vertices,
        del_vertices=delta.del_vertices if len(delta.del_vertices) else None,
    )


def evolution_trace(
    graph: DataGraph,
    slots: int,
    pct_links: float = 0.01,
    pct_vertices: float = 0.0,
    seed: int = 0,
) -> List[GraphDelta]:
    """Pre-generate the whole trace so experiments are reproducible."""
    return [
        sample_delta(graph, pct_links, pct_vertices, seed=seed + 1000 + t)
        for t in range(slots)
    ]


def changed_vertices(
    old: DataGraph, new: DataGraph, assign_old: np.ndarray
) -> np.ndarray:
    """GLAD-E's filter (Alg. 2 line 1): vertices that are newly added OR have
    acquired a new neighbor residing on a *different* server.  Returns a bool
    mask over new.n (padded: new vertices are always True)."""
    mask = np.zeros(new.n, dtype=bool)
    if new.n > old.n:
        mask[old.n:] = True
    n = max(old.n, new.n)
    if len(new.edges) == 0:
        return mask
    # Vectorized: key-match new links against old, then flag the endpoints
    # of genuinely-new links whose endpoints live on different servers
    # (inserted vertices count as their own pseudo-server).
    new_keys = new.edges[:, 0] * n + new.edges[:, 1]
    if len(old.edges):
        old_keys = old.edges[:, 0] * n + old.edges[:, 1]
        fresh = ~np.isin(new_keys, old_keys)
    else:
        fresh = np.ones(len(new_keys), dtype=bool)
    eu, ev = new.edges[fresh, 0], new.edges[fresh, 1]
    pad = np.concatenate([assign_old[:old.n],
                          -1 - np.arange(max(n - old.n, 0))])
    cross = pad[eu] != pad[ev]
    mask[eu[cross]] = True
    mask[ev[cross]] = True
    return mask
