"""Edge network substrate (paper Sec. III-A, VI-A).

An EdgeNetwork holds the server fleet (heterogeneous A/B/C SKUs per Table II),
their connectivity W, and all unit-cost parameters:

  mu[v, i]     client-v -> server-i upload cost         (distance-based)
  tau[i, j]    per-unit cross-edge traffic cost          (distance-based)
  alpha/beta/gamma[i]  GNN compute coefficients          (profiled per SKU)
  rho[i], eps[i]       maintenance costs                 (Gaussian, [100])

The same class doubles as the TPU-pod abstraction: servers = mesh slices,
tau = ICI/DCN hop cost, alpha = per-device step-time coefficient (used by the
straggler-mitigation runtime).  See DESIGN.md §3.

The port's copy of ``repro.graphs.edgenet``, with ``repro`` renamed ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.graphs.datagraph import DataGraph
from repro_torch.graphs.kmeans import kmeans

# Table II SKU profile -> relative compute-cost multipliers.  Profiled offline
# on the paper's three machine classes (weak/moderate/powerful); the absolute
# scale is folded into alpha/beta/gamma units.
SKU_PROFILES = {
    "A": {"compute_scale": 1.00},   # 3.40GHz i7-6700, 4GB  (weak)
    "B": {"compute_scale": 0.60},   # 3.40GHz i7-6700, 8GB  (moderate)
    "C": {"compute_scale": 0.25},   # 3.70GHz W-2145, 32GB  (powerful)
}

# Base per-op unit costs for a type-A machine (arbitrary cost units; the paper
# profiles operator-wise wall time and folds a price factor in).
_BASE_ALPHA = 2.0e-4   # vector-add per element
_BASE_BETA = 1.0e-4    # matvec MAC
_BASE_GAMMA = 5.0e-5   # activation per element

# Fixed sentinel for unusable routes (failed server, disconnected pair).
# A CONSTANT, not derived from the current tau: deriving BIG from
# max(tau) re-inflates it by 1e6 on every successive failure (the previous
# sentinel is already the max), overflowing float64 after a handful of
# events and corrupting the flow solver's integer quantization.  1e12 is
# ~9 orders above any realistic tau/mu unit cost in this repo, and the
# sentinel never reaches the quantizer anyway: dead servers have w=0, so
# `pairs` excludes them from every sweep and orphans are reassigned before
# a solve.
OFFLINE_COST = 1.0e12


@dataclasses.dataclass
class EdgeNetwork:
    m: int
    w: np.ndarray                # (m, m) {0,1} connectivity
    tau: np.ndarray              # (m, m) unit traffic cost (BIG if w=0)
    alpha: np.ndarray            # (m,)
    beta: np.ndarray             # (m,)
    gamma: np.ndarray            # (m,)
    rho: np.ndarray              # (m,)
    eps: np.ndarray              # (m,)
    mu: np.ndarray               # (n, m) upload cost per client
    sku: Optional[np.ndarray] = None      # (m,) of 'A'|'B'|'C'
    coords: Optional[np.ndarray] = None   # (m, 2) server locations

    @property
    def pairs(self) -> np.ndarray:
        """Connected server pairs (i < j)."""
        ii, jj = np.where(np.triu(self.w, 1) > 0)
        return np.stack([ii, jj], axis=1)

    def degrade(self, i: int, factor: float) -> "EdgeNetwork":
        """Model a straggler: server i's compute coefficients scale up."""
        net = dataclasses.replace(
            self,
            alpha=self.alpha.copy(),
            beta=self.beta.copy(),
            gamma=self.gamma.copy(),
        )
        net.alpha[i] *= factor
        net.beta[i] *= factor
        net.gamma[i] *= factor
        return net

    def without_server(self, i: int) -> "EdgeNetwork":
        """Model a node failure: disconnect server i (tau -> OFFLINE_COST,
        w -> 0).  Idempotent, and repeated failures of DIFFERENT servers
        write the same fixed sentinel — costs stay finite and bit-stable no
        matter how many on_failure events stack up."""
        w = self.w.copy()
        tau = self.tau.copy()
        mu = self.mu.copy()
        w[i, :] = 0
        w[:, i] = 0
        tau[i, :] = OFFLINE_COST
        tau[:, i] = OFFLINE_COST
        mu[:, i] = OFFLINE_COST
        return dataclasses.replace(self, w=w, tau=tau, mu=mu)


def build_edge_network(
    graph: DataGraph,
    num_servers: int,
    seed: int = 0,
    mu_factor: float = 0.05,
    tau_factor: float = 0.5,
    rho_mean: float = 0.5,
    rho_std: float = 0.1,
    eps_mean: float = 5.0,
    eps_std: float = 1.0,
    connectivity: float = 1.0,
) -> EdgeNetwork:
    """Construct the heterogeneous fleet per the paper's methodology:

    - Server locations = k-means pivots over client coordinates (Sec. VI-A).
    - SKU labels round-robin A/B/C in equal proportion, remainders assigned in
      priority A, B, C (Sec. VI-A "Methodology").
    - mu = mu_factor * distance(client, server); tau = tau_factor * distance.
      tau_factor defaults high enough that cross-edge traffic dominates the
      total cost — the regime the paper reports ("the cross-edge traffic cost
      contributes a majority of the total system cost", Sec. VI-B).
    - rho/eps drawn from a Gaussian process (hourly electricity price, [100]).
    """
    rng = np.random.default_rng(seed)
    assert graph.coords is not None, "data graph needs client coordinates"
    centers, _ = kmeans(graph.coords, num_servers, seed=seed)

    # SKU assignment in equal proportion with A,B,C priority on remainders.
    skus = []
    base, rem = divmod(num_servers, 3)
    counts = {"A": base, "B": base, "C": base}
    for t in ["A", "B", "C"][:rem]:
        counts[t] += 1
    for t in ["A", "B", "C"]:
        skus += [t] * counts[t]
    skus = np.array(skus[:num_servers])
    rng.shuffle(skus)

    scale = np.array([SKU_PROFILES[t]["compute_scale"] for t in skus])
    alpha = _BASE_ALPHA * scale
    beta = _BASE_BETA * scale
    gamma = _BASE_GAMMA * scale
    rho = np.abs(rng.normal(rho_mean, rho_std, size=num_servers)) * scale
    eps = np.abs(rng.normal(eps_mean, eps_std, size=num_servers))

    # Distances.
    d_cs = np.linalg.norm(
        graph.coords[:, None, :] - centers[None, :, :], axis=-1
    )  # (n, m)
    d_ss = np.linalg.norm(centers[:, None, :] - centers[None, :, :], axis=-1)
    mu = mu_factor * d_cs
    tau = tau_factor * d_ss
    np.fill_diagonal(tau, 0.0)

    # Connectivity: city WAN is (near-)fully connected; optionally sparsify.
    w = np.ones((num_servers, num_servers), dtype=np.int64)
    np.fill_diagonal(w, 0)
    if connectivity < 1.0:
        drop = rng.uniform(size=(num_servers, num_servers)) > connectivity
        drop = np.triu(drop, 1)
        drop = drop | drop.T
        w[drop] = 0
        # Keep the graph connected via a ring.
        for i in range(num_servers):
            j = (i + 1) % num_servers
            w[i, j] = w[j, i] = 1
    big = tau[w > 0].max() * 1e6 if (w > 0).any() else 1e12
    tau = np.where(w > 0, tau, big)
    np.fill_diagonal(tau, 0.0)

    return EdgeNetwork(
        m=num_servers, w=w, tau=tau, alpha=alpha, beta=beta, gamma=gamma,
        rho=rho, eps=eps, mu=mu, sku=skus, coords=centers,
    )


def pod_edge_network(
    num_slices: int,
    vertices: int,
    pods: int = 1,
    link_cost: float = 1.0,
    cross_pod_factor: float = 4.0,
    seed: int = 0,
) -> EdgeNetwork:
    """TPU-pod flavoured EdgeNetwork: slices are homogeneous, tau is the
    ICI hop cost (cross-pod DCN hops cost `cross_pod_factor` more).  Used by
    the runtime layer (expert layout, straggler re-balance)."""
    rng = np.random.default_rng(seed)
    per_pod = num_slices // max(pods, 1)
    pod_of = np.arange(num_slices) // max(per_pod, 1)
    tau = np.full((num_slices, num_slices), link_cost)
    cross = pod_of[:, None] != pod_of[None, :]
    tau[cross] = link_cost * cross_pod_factor
    np.fill_diagonal(tau, 0.0)
    w = np.ones((num_slices, num_slices), dtype=np.int64)
    np.fill_diagonal(w, 0)
    ones = np.ones(num_slices)
    return EdgeNetwork(
        m=num_slices, w=w, tau=tau,
        alpha=_BASE_ALPHA * ones, beta=_BASE_BETA * ones, gamma=_BASE_GAMMA * ones,
        rho=0.0 * ones, eps=0.0 * ones,
        mu=np.zeros((vertices, num_slices)),
        sku=np.array(["C"] * num_slices),
        coords=rng.uniform(0, 1, size=(num_slices, 2)),
    )
