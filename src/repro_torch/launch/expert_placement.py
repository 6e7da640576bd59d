"""GLAD beyond the paper: MoE expert placement as a graph-layout problem.

Experts = vertices (weighted by routed-token load), co-activation = links
(tokens routed to both experts pay cross-slice traffic when separated),
mesh slices = servers.  GLAD-S minimizes exactly the paper's C_P + C_T:
here that means balanced expert load with co-activated experts co-located.

  PYTHONPATH=src python -m repro_torch.launch.expert_placement [--device cpu]

The counterpart of the reference's ``examples/expert_placement.py``, line
for line.  The layout is host code (numpy and scipy); like every entry point
of the port it takes ``device=`` and refuses a missing card, the device the
placed experts would serve on.  ``main`` returns a JSON-able record of every
printed field and the assignment.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.partition import coactivation_graph, expert_layout

SLICES = 8                      # mesh slices, in 2 pods


def synth_routing(E=64, groups=8, tokens=200_000, seed=0):
    """Co-routing histogram with planted expert communities (tokens prefer
    experts in the same latent group: the structure GLAD should discover)."""
    rng = np.random.default_rng(seed)
    counts = np.zeros((E, E))
    per = E // groups
    for _ in range(tokens // 100):
        gidx = rng.integers(0, groups)
        pool = np.arange(gidx * per, (gidx + 1) * per)
        # top-6-of-group with a little leakage
        k = rng.choice(pool, size=4, replace=False)
        if rng.uniform() < 0.2:
            k[-1] = rng.integers(0, E)
        for a in k:
            counts[a, a] += 100 / 4
            for b in k:
                if a < b:
                    counts[a, b] += 100 / 12
                    counts[b, a] += 100 / 12
    return counts


def main(device: str = "cuda") -> dict:
    dev = resolve_device(device)
    print("== MoE expert layout via GLAD (deepseek-moe geometry) ==")
    counts = synth_routing()
    experts = counts.shape[0]
    part = expert_layout(counts, num_slices=SLICES, pods=2, seed=0)
    g = coactivation_graph(counts)
    rng = np.random.default_rng(0)
    rand_assign = rng.integers(0, SLICES, size=experts)
    rand_cut_w = sum(counts[u, v] for u, v in g.edges
                     if rand_assign[u] != rand_assign[v])
    glad_cut_w = sum(counts[u, v] for u, v in g.edges
                     if part.assign[u] != part.assign[v])
    load = counts.diagonal()
    glad_load = np.array([load[part.assign == s].sum()
                          for s in range(SLICES)])
    rand_load = np.array([load[rand_assign == s].sum()
                          for s in range(SLICES)])
    less = 1 - glad_cut_w / max(rand_cut_w, 1)
    imbalance = {"random": rand_load.max() / rand_load.mean(),
                 "glad": glad_load.max() / glad_load.mean()}
    per_slice = np.bincount(part.assign, minlength=SLICES)
    print(f"cross-slice co-activation weight: random={rand_cut_w:.0f} "
          f"GLAD={glad_cut_w:.0f} ({less:.1%} less all-to-all)")
    print(f"load imbalance (max/mean): random={imbalance['random']:.2f} "
          f"GLAD={imbalance['glad']:.2f}")
    print("per-slice experts:", per_slice)
    return {"experts": experts, "slices": SLICES, "device": str(dev),
            "cut_weight": {"random": float(rand_cut_w),
                           "glad": float(glad_cut_w)},
            "less_all_to_all": float(less),
            "imbalance": {k: float(v) for k, v in imbalance.items()},
            "per_slice_experts": per_slice.tolist(),
            "assign": [int(a) for a in part.assign]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(device=a.device)
