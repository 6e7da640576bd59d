"""Closed loop: request-driven GNN serving over a live layout that survives
a server failure mid-stream.

  build graph/fleet -> GLAD layout (traffic-aware) -> compile ShardPlan
  -> serve a Zipf request stream -> server dies -> ElasticCoordinator
  re-layouts -> patch_plan patches the live plan -> serving continues
  (the engine re-seeds its caches off the new plan; no engine rebuild).

  PYTHONPATH=src python -m repro_torch.launch.serve_gnn [--device cpu] \
      [--requests 2000] [--graph yelp|siot] [--n 800] [--links 1000]

The counterpart of the reference's ``examples/serve_gnn_requests.py``, line
for line, with the ego forward's ``stats['traces']`` (distinct input
shapes).  ``--graph siot --n 8001 --links 33509`` is the paper's SIoT.
``main`` returns a JSON-able record of every printed field, the latency
and throughput of each half, and the largest distance of the served
answers from the whole-graph forward before and after the failure.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import (CostModel, glad_s, partition_from_assign,
                              workload_for)
from repro_torch.gnn import (GNNConfig, GNNServeEngine, compile_plan,
                             directed_edges, forward, link_traffic,
                             params_or_init, patch_plan, request_traffic,
                             zipf_requests)
from repro_torch.graphs import (build_edge_network, synthetic_siot,
                                synthetic_yelp)
from repro_torch.runtime import ElasticCoordinator

GRAPHS = {"yelp": synthetic_yelp, "siot": synthetic_siot}


def _window(eng, stats, window: str) -> dict:
    lat = eng.latency_percentiles(window=window)
    return {"requests": stats.requests, "req_per_s": stats.throughput_rps,
            "p50_ms": lat["p50"] * 1e3, "p99_ms": lat["p99"] * 1e3}


def main(requests: int = 2000, servers: int = 6, graph: str = "yelp",
         n: int = 800, links: int = 1000, device: str = "cuda",
         params=None) -> dict:
    dev = resolve_device(device)
    print("== request-driven serving over a live, fault-tolerant layout ==")
    g = GRAPHS[graph](n=n, target_links=links)
    net = build_edge_network(g, servers, seed=0, mu_factor=2.0)
    gnn = workload_for("gcn", g.features.shape[1])

    # The stream is known-skewed (Zipf): hand GLAD the traffic histogram
    # (unary compute rows) and ego-crossing edge weights (pairwise C_T)
    # so hot neighborhoods dominate the placement on both axes.
    stream = zipf_requests(g.n, requests, s=1.1, seed=0)
    g_aware = dataclasses.replace(
        g, edge_weights=g.weights_or_ones() * link_traffic(g, stream, 2))
    cm = CostModel(net, g_aware, gnn,
                   traffic=request_traffic(g.n, stream, graph=g, hops=2))
    res = glad_s(cm, R=servers, seed=0, sweep="batched")
    part = partition_from_assign(g, res.assign, servers, res.factors)
    plan = compile_plan(g, part, slack=0.5)
    version0 = plan.version
    print(f"layout: cost {res.cost:.1f} over {servers} servers, "
          f"plan v{plan.version}")

    cfg = GNNConfig("gcn", (g.features.shape[1], 16, 4))
    params = params_or_init(cfg, params, dev)
    eng = GNNServeEngine(cfg, params, g, plan, batch=16, net=net, device=dev)
    ref = forward(cfg, params, torch.from_numpy(g.features).to(dev),
                  directed_edges(g.edges)).cpu().numpy()

    half = requests // 2
    out1 = eng.serve(stream[:half])
    s = eng.stats
    first = {**_window(eng, s, "all"), "local_rows": s.local_rows,
             "cache_hit_rows": s.cache_hit_rows,
             "fetched_rows": s.fetched_rows}
    print(f"first half: {s.requests} served, "
          f"{s.throughput_rps:.0f} req/s, p99 "
          f"{eng.latency_percentiles()['p99'] * 1e3:.1f} ms, rows "
          f"local/hit/fetched = {s.local_rows}/{s.cache_hit_rows}/"
          f"{s.fetched_rows}")

    # A server dies mid-stream.  The coordinator disconnects it, GLAD
    # re-layouts incrementally, and the move delta patches the LIVE plan.
    dead = int(np.bincount(part.assign, minlength=servers).argmax())
    coord = ElasticCoordinator(net, g, gnn, part)
    new_part = coord.on_failure([dead])
    ev = coord.events[-1]
    pd = patch_plan(plan, g, new_part.assign)
    failure = {"dead": dead, "moved": ev.migrated,
               "relayout_ms": ev.wall_time_s * 1e3, "old_cost": ev.old_cost,
               "new_cost": ev.new_cost,
               "plan": "patched" if pd.patched else "rebuilt",
               "plan_version": plan.version,
               "dirty": int(len(pd.dirty_parts)), "num_parts": plan.num_parts}
    print(f"server {dead} FAILED: re-layout moved {ev.migrated} vertices "
          f"in {ev.wall_time_s * 1e3:.0f} ms "
          f"(cost {ev.old_cost:.0f} -> {ev.new_cost:.0f}); plan "
          f"{'patched' if pd.patched else 'rebuilt'} to v{plan.version}, "
          f"dirty {len(pd.dirty_parts)}/{plan.num_parts} partitions")

    out2 = eng.serve(stream[half:])
    s = eng.stats
    left = int(np.isin(plan.assign, [dead]).sum())
    if left:
        raise RuntimeError(f"{left} vertices left on dead server {dead}")
    second = {**_window(eng, eng.epoch_stats, "epoch"),
              "total_requests": s.requests, "plan_refreshes": s.plan_refreshes,
              "local_rows": s.local_rows, "cache_hit_rows": s.cache_hit_rows,
              "fetched_rows": s.fetched_rows, "fetch_cost": s.fetch_cost}
    print(f"second half: {s.requests} total served, cache re-seeds "
          f"{s.plan_refreshes}, rows local/hit/fetched = "
          f"{s.local_rows}/{s.cache_hit_rows}/{s.fetched_rows}, "
          f"fetch cost {s.fetch_cost:.1f}")
    overall = {**_window(eng, s, "all"), "traces": eng.fwd.stats["traces"]}
    print(f"overall: {s.throughput_rps:.0f} req/s, p99 "
          f"{eng.latency_percentiles()['p99'] * 1e3:.1f} ms, "
          f"forward traces {eng.fwd.stats['traces']}")
    outs = (out1, out2)
    return {"graph": graph, "n": g.n, "links": g.num_edges,
            "servers": servers, "device": str(dev), "layout_cost": res.cost,
            "plan_version0": version0, "first_half": first, "failure": failure,
            "second_half": second, "overall": overall,
            "dead_vertices_left": left,
            "served_shape": [list(o.shape) for o in outs],
            "served_finite": all(bool(np.isfinite(o).all()) for o in outs),
            "served_max_err": [
                float(np.abs(o - ref[t]).max()) if len(o) else 0.0
                for o, t in zip(outs, (stream[:half], stream[half:]))]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--servers", type=int, default=6)
    ap.add_argument("--graph", choices=sorted(GRAPHS), default="yelp")
    ap.add_argument("--n", type=int, default=800)
    ap.add_argument("--links", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.requests, a.servers, a.graph, a.n, a.links, device=a.device)
