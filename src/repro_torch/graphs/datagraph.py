"""Data graph substrate.

The *data graph* G = (V, E) is the GNN's input: clients are vertices, their
relationships are links (paper Sec. III-A).  Stored as a canonical undirected
edge list plus a CSR view for fast neighbor iteration.  All host-side
scheduling (GLAD) operates on numpy; the JAX models consume the exported
arrays.

The port's copy of ``repro.graphs.datagraph``, with ``repro`` renamed ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def csr_multirange(indptr: np.ndarray, rows: np.ndarray):
    """Vectorized concatenation of CSR row slices.

    Returns ``(flat, rep)`` where ``flat`` indexes the CSR data arrays for
    the concatenation of slices ``indptr[r]:indptr[r+1]`` over ``rows`` (in
    order), and ``rep[i]`` is the position within ``rows`` that produced
    ``flat[i]``.  O(output) with no Python loop — the shared primitive
    behind neighbor gathers, incident-edge queries and residual BFS.
    """
    rows = np.asarray(rows)
    starts = indptr[rows]
    counts = indptr[rows + 1] - starts
    total = int(counts.sum())
    if total == 0:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty
    rep = np.repeat(np.arange(len(rows)), counts)
    flat = (np.arange(total)
            - np.repeat(np.cumsum(counts) - counts, counts)
            + starts[rep])
    return flat, rep


def _canonicalize(edges: np.ndarray, n: int) -> np.ndarray:
    """Dedup + sort an undirected edge list; drop self loops."""
    if edges.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    e = e[e[:, 0] != e[:, 1]]
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    key = lo * n + hi
    _, idx = np.unique(key, return_index=True)
    return np.stack([lo[idx], hi[idx]], axis=1)


@dataclasses.dataclass
class DataGraph:
    """Undirected attributed graph (clients + links).

    ``edge_weights`` (optional, aligned with the canonical ``edges`` order)
    generalizes the paper's unit links: C_T charges tau * weight per cut
    link.  Used by the MoE expert-placement mapping (co-activation counts).
    """

    n: int
    edges: np.ndarray                      # (E, 2) canonical u < v
    features: Optional[np.ndarray] = None  # (n, d) float32
    labels: Optional[np.ndarray] = None    # (n,) int64
    coords: Optional[np.ndarray] = None    # (n, 2) client locations
    edge_weights: Optional[np.ndarray] = None   # (E,) aligned with edges

    # CSR views (built lazily)
    _indptr: Optional[np.ndarray] = None
    _indices: Optional[np.ndarray] = None
    _edge_ids: Optional[np.ndarray] = None
    _degrees: Optional[np.ndarray] = None

    def __post_init__(self):
        self.edges = _canonicalize(self.edges, self.n)

    def weights_or_ones(self) -> np.ndarray:
        if self.edge_weights is None:
            return np.ones(len(self.edges))
        return self.edge_weights

    # ------------------------------------------------------------------ CSR
    def _build_csr(self) -> None:
        E = len(self.edges)
        src = np.concatenate([self.edges[:, 0], self.edges[:, 1]])
        dst = np.concatenate([self.edges[:, 1], self.edges[:, 0]])
        eid = np.concatenate([np.arange(E), np.arange(E)])
        # Sort by (src, dst) — not just src — so every row's neighbor list
        # is ascending.  The layout engine relies on this: auxiliary-graph
        # arcs gathered row-by-row are then already in canonical (row, col)
        # order and the flow-CSR assembly skips its per-solve lexsort.
        order = np.lexsort((dst, src))
        src, dst, eid = src[order], dst[order], eid[order]
        self._indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.add.at(self._indptr, src + 1, 1)
        self._indptr = np.cumsum(self._indptr)
        self._indices = dst
        self._edge_ids = eid

    @property
    def indptr(self) -> np.ndarray:
        if self._indptr is None:
            self._build_csr()
        return self._indptr

    @property
    def indices(self) -> np.ndarray:
        if self._indices is None:
            self._build_csr()
        return self._indices

    @property
    def edge_ids(self) -> np.ndarray:
        """Undirected edge index aligned with ``indices``: entry k says which
        row of ``edges`` produced the CSR slot k (each edge appears twice)."""
        if self._edge_ids is None:
            self._build_csr()
        return self._edge_ids

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        if self._degrees is None:
            deg = np.zeros(self.n, dtype=np.int64)
            if self.num_edges:
                np.add.at(deg, self.edges[:, 0], 1)
                np.add.at(deg, self.edges[:, 1], 1)
            self._degrees = deg
        return self._degrees

    def release_views(self) -> None:
        """Drop the lazily-built CSR/degree caches (``indptr``/``indices``/
        ``edge_ids``/``degrees``).

        They are pure deterministic functions of ``edges`` — the next
        property access rebuilds them BITWISE identical — so releasing is
        always safe; it only trades a rebuild (one ``lexsort`` over the
        directed edge list) for the ~40B/edge the views hold resident.
        The streamed coarsening build calls this on every level it has
        finished with: at the SIoT edge density a level's CSR is over half
        its retained footprint, and the hierarchy's edge count shrinks far
        slower than its vertex count, so a fully-cached hierarchy would
        dominate peak RSS no matter how bounded the transients are."""
        self._indptr = None
        self._indices = None
        self._edge_ids = None
        self._degrees = None

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def incident_edge_ids(self, vertices: np.ndarray) -> np.ndarray:
        """Edge ids with >=1 endpoint in ``vertices``, each id once.

        Vectorized multi-range gather over the CSR slices of ``vertices``
        (O(sum deg) — no per-vertex Python loop, no scan of the edge list).
        """
        vertices = np.asarray(vertices, dtype=np.int64)
        if len(vertices) == 0 or self.num_edges == 0:
            return np.zeros(0, dtype=np.int64)
        flat, _ = csr_multirange(self.indptr, vertices)
        if len(flat) == 0:
            return np.zeros(0, dtype=np.int64)
        return np.unique(self.edge_ids[flat])

    # ------------------------------------------------------------ mutation
    def with_changes(
        self,
        add_edges: Optional[np.ndarray] = None,
        del_edges: Optional[np.ndarray] = None,
        add_vertices: int = 0,
        del_vertices: Optional[np.ndarray] = None,
        new_features: Optional[np.ndarray] = None,
        new_coords: Optional[np.ndarray] = None,
    ) -> "DataGraph":
        """Return an evolved copy (paper Sec. V-A: vertex/link insert/delete).

        Deleted vertices keep their index slot (isolated, masked) so that
        layout vectors stay aligned across time slots; this mirrors a client
        leaving the service while the id space persists.
        """
        n = self.n + add_vertices
        edges = self.edges
        if del_edges is not None and len(del_edges):
            de = _canonicalize(np.asarray(del_edges), n)
            key = edges[:, 0] * n + edges[:, 1]
            dkey = de[:, 0] * n + de[:, 1]
            edges = edges[~np.isin(key, dkey)]
        if add_edges is not None and len(add_edges):
            edges = np.concatenate([edges, np.asarray(add_edges).reshape(-1, 2)])
        if del_vertices is not None and len(del_vertices):
            dv = np.asarray(del_vertices)
            mask = ~(np.isin(edges[:, 0], dv) | np.isin(edges[:, 1], dv))
            edges = edges[mask]

        feats = self.features
        if feats is not None and add_vertices:
            if new_features is None:
                new_features = np.zeros((add_vertices, feats.shape[1]), feats.dtype)
            feats = np.concatenate([feats, new_features], axis=0)
        coords = self.coords
        if coords is not None and add_vertices:
            if new_coords is None:
                new_coords = coords[
                    np.random.default_rng(0).integers(0, self.n, add_vertices)
                ]
            coords = np.concatenate([coords, new_coords], axis=0)
        labels = self.labels
        if labels is not None and add_vertices:
            labels = np.concatenate([labels, np.zeros(add_vertices, labels.dtype)])
        return DataGraph(n=n, edges=edges, features=feats, labels=labels, coords=coords)


# --------------------------------------------------------------- coarsening
#: Largest cluster count whose packed edge key ``lo * nc + hi`` still fits
#: int64 (isqrt(2^63 - 1)).  Past it the key arithmetic would WRAP
#: silently (numpy int64 overflow raises nothing) and alias distinct
#: coarse edges onto each other.
_MAX_CLUSTER_KEY_N = 3_037_000_499


def _check_cluster_key_domain(num_clusters: int) -> None:
    """Refuse, loudly, cluster counts whose packed keys overflow int64."""
    if num_clusters > _MAX_CLUSTER_KEY_N:
        raise ValueError(
            f"num_clusters={num_clusters} overflows the int64 packed edge "
            f"key domain (lo * num_clusters + hi); max supported is "
            f"{_MAX_CLUSTER_KEY_N}")


def contract_graph(graph: DataGraph, cluster_of: np.ndarray,
                   num_clusters: int) -> DataGraph:
    """Cluster-quotient graph (multilevel coarsening): vertices are the
    clusters, intra-cluster links vanish, parallel inter-cluster links merge
    with SUMMED weights — so tau * weight over the coarse links equals the
    fine C_T of any projected layout exactly.

    The merged edge list is built already canonical (unique lo < hi keys in
    sorted order), so ``edge_weights`` aligns with the post-init
    canonical ``edges`` order by construction.  Deterministic: the per-key
    weight sums are sequential ``np.add.reduceat`` segments over the sorted
    key order.
    """
    _check_cluster_key_domain(num_clusters)
    cluster_of = np.asarray(cluster_of, dtype=np.int64)
    e = graph.edges
    if len(e) == 0:
        return DataGraph(n=num_clusters, edges=np.zeros((0, 2), np.int64))
    w = graph.weights_or_ones().astype(np.float64)
    cu = cluster_of[e[:, 0]]
    cv = cluster_of[e[:, 1]]
    keep = cu != cv
    lo = np.minimum(cu[keep], cv[keep])
    hi = np.maximum(cu[keep], cv[keep])
    key = lo * num_clusters + hi
    order = np.argsort(key, kind="stable")
    ks = key[order]
    if len(ks) == 0:
        return DataGraph(n=num_clusters, edges=np.zeros((0, 2), np.int64))
    ws = w[keep][order]
    uniq, start = np.unique(ks, return_index=True)
    wsum = np.add.reduceat(ws, start)
    if not np.isfinite(wsum).all():
        raise ValueError(
            "contracted edge weight sum overflowed to non-finite; "
            "parallel-edge weights saturated the float64 domain")
    edges = np.stack([uniq // num_clusters, uniq % num_clusters], axis=1)
    g = DataGraph(n=num_clusters, edges=edges)
    g.edge_weights = wsum
    return g


# ---------------------------------------------------------------- synthetic
def synthetic_siot(
    n: int = 8001,
    target_links: int = 33509,
    feat_dim: int = 52,
    seed: int = 0,
    area: float = 10.0,
) -> DataGraph:
    """SIoT-like graph: long-tail degree distribution (paper Fig. 6),
    8001 vertices / 33509 links, 52-d features, binary labels.

    Built with a Barabasi-Albert style preferential-attachment process which
    reproduces the long-tail CDF reported for SIoT.
    """
    rng = np.random.default_rng(seed)
    m = max(1, int(round(target_links / max(n - 1, 1))))  # links per new vertex
    src, dst = [], []
    # Seed clique.
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
    edges = np.stack([np.array(src), np.array(dst)], axis=1)
    # Trim / top up to the exact target link count.
    g = DataGraph(n=n, edges=edges)
    e = g.edges
    if len(e) > target_links:
        keep = rng.choice(len(e), size=target_links, replace=False)
        e = e[keep]
    while len(e) < target_links:
        extra = rng.integers(0, n, size=(target_links - len(e), 2))
        e = _canonicalize(np.concatenate([e, extra]), n)
    feats = rng.normal(size=(n, feat_dim)).astype(np.float32)
    labels = (feats[:, 0] + 0.5 * feats[:, 1] > 0).astype(np.int64)  # public/private
    coords = rng.uniform(0, area, size=(n, 2)).astype(np.float32)
    return DataGraph(n=n, edges=e, features=feats, labels=labels, coords=coords)


def synthetic_yelp(
    n: int = 3912,
    target_links: int = 4677,
    feat_dim: int = 100,
    seed: int = 1,
    area: float = 10.0,
) -> DataGraph:
    """Yelp-like graph: sparse with many isolated vertices (paper Fig. 6),
    3912 vertices / 4677 links, 100-d features (Word2Vec-like), spam labels.

    Links connect reviews by the same user: we emulate by grouping vertices
    into 'users' with heavy-tailed review counts and forming small cliques.
    """
    rng = np.random.default_rng(seed)
    edges = []
    v = 0
    while v < n:
        c = int(min(n - v, max(1, rng.pareto(2.5) + 1)))
        group = list(range(v, v + c))
        for a in range(len(group)):
            for b in range(a + 1, len(group)):
                edges.append((group[a], group[b]))
        v += c
    edges = np.array(edges, dtype=np.int64) if edges else np.zeros((0, 2), np.int64)
    g = DataGraph(n=n, edges=edges)
    e = g.edges
    if len(e) > target_links:
        keep = rng.choice(len(e), size=target_links, replace=False)
        e = e[keep]
    while len(e) < target_links:
        extra = rng.integers(0, n, size=(target_links - len(e), 2))
        e = _canonicalize(np.concatenate([e, extra]), n)
    feats = rng.normal(size=(n, feat_dim)).astype(np.float32)
    labels = (rng.uniform(size=n) < 0.15).astype(np.int64)  # spam ratio
    # Clients' spatial coords synthesized from a taxi-trace-like mixture
    # ("workload composition", paper Sec. VI-A): dense downtown + sparse tail.
    centers = rng.uniform(0, area, size=(8, 2))
    which = rng.integers(0, 8, size=n)
    coords = centers[which] + rng.normal(scale=0.6, size=(n, 2))
    solitary = rng.uniform(size=n) < 0.1
    coords[solitary] = rng.uniform(-area * 0.3, area * 1.3, size=(solitary.sum(), 2))
    return DataGraph(
        n=n, edges=e, features=feats, labels=labels, coords=coords.astype(np.float32)
    )
