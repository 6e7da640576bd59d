"""Quickstart: cost-optimized graph layout for distributed GNN processing.

Builds a Yelp-like data graph and a heterogeneous 8-server edge fleet,
compares the Random, Greedy and GLAD-S layouts, then runs the distributed
GNN under the Random and GLAD-S layouts and checks its numerics against the
whole-graph forward.

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu] \
      [--n 600] [--links 800]

The counterpart of the reference's ``examples/quickstart.py``, line for
line.  On the card the BSP forward aggregates with the ``spmm_csr`` kernel
(K1, one launch per GCN layer), so ``max_err`` is a rounding difference
rather than 0.  ``--n 3912 --links 4677`` is the paper's Yelp.  ``main``
returns a JSON-able record of every printed field.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import (CostModel, glad_s, greedy_layout,
                              partition_from_assign, random_layout,
                              workload_for)
from repro_torch.gnn import (GNNConfig, compile_plan, directed_edges, forward,
                             params_or_init, simulate_bsp_forward)
from repro_torch.graphs import build_edge_network, synthetic_yelp


def main(n: int = 600, links: int = 800, device: str = "cuda",
         params=None) -> dict:
    dev = resolve_device(device)
    print("== GLAD quickstart ==")
    g = synthetic_yelp(n=n, target_links=links)
    net = build_edge_network(g, 8, seed=0)
    cm = CostModel(net, g, workload_for("gcn", 100))

    rand = random_layout(cm, seed=0)
    greedy = greedy_layout(cm)
    res = glad_s(cm, seed=0)
    costs = {"random": cm.total(rand), "greedy": cm.total(greedy),
             "glad_s": res.cost}
    print(f"cost: random={costs['random']:9.1f}  "
          f"greedy={costs['greedy']:9.1f}"
          f"  GLAD-S={res.cost:9.1f}  "
          f"({1 - res.cost / costs['random']:.1%} cheaper than random, "
          f"{res.iterations} iterations, {res.wall_time_s:.2f}s)")
    print("factors:", {k: round(v, 1) for k, v in res.factors.items()})

    # Execute the distributed GNN under both layouts; numerics must agree.
    cfg = GNNConfig("gcn", (100, 16, 2))
    params = params_or_init(cfg, params, dev)
    ref = forward(cfg, params, torch.from_numpy(g.features).to(dev),
                  directed_edges(g.edges)).cpu().numpy()
    layouts = {}
    for name, assign in (("random", rand), ("GLAD-S", res.assign)):
        part = partition_from_assign(g, assign, net.m, cm.factors(assign))
        plan = compile_plan(g, part)
        out = simulate_bsp_forward(cfg, params, plan, g.features, device=dev)
        err = float(np.abs(out - ref).max())
        layouts[name] = {"cut_links": int(part.cut_links),
                         "halo_rows_exchanged": int(plan.halo_bytes_ppermute),
                         "ppermute_rounds": len(plan.rounds),
                         "max_err": err, "shape": list(out.shape),
                         "finite": bool(np.isfinite(out).all())}
        print(f"{name:8s}: cut_links={part.cut_links:5d} "
              f"halo_rows_exchanged={plan.halo_bytes_ppermute:6d} "
              f"ppermute_rounds={len(plan.rounds):3d}  max_err={err:.2e}")
    print("the GLAD layout moves fewer halo rows for identical outputs.")
    return {"n": g.n, "links": g.num_edges, "servers": net.m,
            "device": str(dev), "costs": costs,
            "cheaper_than_random": 1 - res.cost / costs["random"],
            "iterations": res.iterations, "glad_s_s": res.wall_time_s,
            "factors": dict(res.factors), "layouts": layouts}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=600)
    ap.add_argument("--links", type=int, default=800)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.n, a.links, device=a.device)
