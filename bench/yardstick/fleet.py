"""The edge-server fleet, frozen: a copy of
``repro_torch.graphs.edgenet.build_edge_network`` and of the k-means it
places the servers with (paper Sec. VI-A, Table II), returning the arrays
as a dict.  The same arguments give the same bits."""
from __future__ import annotations

import numpy as np

# Table II SKU -> relative compute-cost multiplier.
COMPUTE_SCALE = {"A": 1.00, "B": 0.60, "C": 0.25}
BASE_ALPHA = 2.0e-4      # vector-add per element
BASE_BETA = 1.0e-4       # matvec MAC
BASE_GAMMA = 5.0e-5      # activation per element


def kmeans(points: np.ndarray, k: int, iters: int = 50, seed: int = 0):
    """Plain Lloyd k-means with a k-means++ style start: (centers, assign)."""
    rng = np.random.default_rng(seed)
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    if k >= n:
        centers = pts.copy()
        extra = pts[rng.integers(0, n, size=k - n)] if k > n else pts[:0]
        centers = np.concatenate([centers, extra], axis=0)
        return centers, np.arange(n) % k
    centers = [pts[rng.integers(0, n)]]
    for _ in range(k - 1):
        d2 = np.min(
            ((pts[:, None, :] - np.array(centers)[None]) ** 2).sum(-1), axis=1)
        p = d2 / max(d2.sum(), 1e-12)
        centers.append(pts[rng.choice(n, p=p)])
    centers = np.array(centers)
    assign = np.zeros(n, dtype=np.int64)
    for it in range(iters):
        d2 = ((pts[:, None, :] - centers[None]) ** 2).sum(-1)
        new_assign = d2.argmin(axis=1)
        if np.array_equal(new_assign, assign) and it > 0:
            break
        assign = new_assign
        for c in range(k):
            mask = assign == c
            if mask.any():
                centers[c] = pts[mask].mean(axis=0)
    return centers, assign


def build(coords: np.ndarray, num_servers: int, seed: int = 0,
          mu_factor: float = 0.05, tau_factor: float = 0.5,
          rho_mean: float = 0.5, rho_std: float = 0.1, eps_mean: float = 5.0,
          eps_std: float = 1.0, connectivity: float = 1.0) -> dict:
    """The fleet over clients at ``coords`` (n, 2): servers at k-means
    pivots, SKUs A/B/C in equal shares (remainders A, B, C) shuffled,
    mu = mu_factor * client-server distance, tau = tau_factor *
    server-server distance, rho and eps Gaussian."""
    rng = np.random.default_rng(seed)
    centers, _ = kmeans(coords, num_servers, seed=seed)
    skus = []
    base, rem = divmod(num_servers, 3)
    counts = {"A": base, "B": base, "C": base}
    for t in ["A", "B", "C"][:rem]:
        counts[t] += 1
    for t in ["A", "B", "C"]:
        skus += [t] * counts[t]
    skus = np.array(skus[:num_servers])
    rng.shuffle(skus)

    scale = np.array([COMPUTE_SCALE[t] for t in skus])
    alpha = BASE_ALPHA * scale
    beta = BASE_BETA * scale
    gamma = BASE_GAMMA * scale
    rho = np.abs(rng.normal(rho_mean, rho_std, size=num_servers)) * scale
    eps = np.abs(rng.normal(eps_mean, eps_std, size=num_servers))

    d_cs = np.linalg.norm(coords[:, None, :] - centers[None, :, :], axis=-1)
    d_ss = np.linalg.norm(centers[:, None, :] - centers[None, :, :], axis=-1)
    mu = mu_factor * d_cs
    tau = tau_factor * d_ss
    np.fill_diagonal(tau, 0.0)

    w = np.ones((num_servers, num_servers), dtype=np.int64)
    np.fill_diagonal(w, 0)
    if connectivity < 1.0:
        drop = rng.uniform(size=(num_servers, num_servers)) > connectivity
        drop = np.triu(drop, 1)
        drop = drop | drop.T
        w[drop] = 0
        for i in range(num_servers):
            j = (i + 1) % num_servers
            w[i, j] = w[j, i] = 1
    big = tau[w > 0].max() * 1e6 if (w > 0).any() else 1e12
    tau = np.where(w > 0, tau, big)
    np.fill_diagonal(tau, 0.0)
    return {"m": num_servers, "w": w, "tau": tau, "alpha": alpha,
            "beta": beta, "gamma": gamma, "rho": rho, "eps": eps, "mu": mu,
            "sku": skus, "coords": centers}
