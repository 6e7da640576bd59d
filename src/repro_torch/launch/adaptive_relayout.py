"""Online scenario: the data graph evolves every time slot; GLAD-A decides
between incremental (GLAD-E) and global (GLAD-S) re-layout under an SLA,
and a live ShardPlan follows the layout through the incremental plan
pipeline: evolve -> relayout -> patch_plan -> resumed forward, with a full
plan recompile only when a capacity actually grows.

  PYTHONPATH=src python -m repro_torch.launch.adaptive_relayout \
      [--slots 30] [--device cpu] [--n 800] [--links 1000]

The counterpart of the reference's ``examples/adaptive_relayout.py``.  The
forward is the form the reference's comment describes: ONE resident BSP
forward (:func:`make_bsp_forward`, GCN on the block-sparse aggregate: K1 on
the card, one launch per layer) bound to the live plan, which refreshes its
plan tensors in place after a value-only patch and rebuilds them only when
the patch grew a capacity (``PlanDelta.retrace_expected``).  Each slot's
output is held against the whole-graph forward on the new graph
(``max_err`` in the record).  ``--n 3912 --links 4677`` is the paper's
Yelp.  ``main`` returns a JSON-able record of every printed field.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import (GladA, apply_delta, evolution_trace,
                              partition_from_assign, workload_for)
from repro_torch.gnn import (GNNConfig, compile_plan, directed_edges, forward,
                             gather_outputs, make_bsp_forward,
                             params_or_init, patch_plan, scatter_features)
from repro_torch.graphs import build_edge_network, synthetic_yelp


def main(slots: int = 30, theta: float = 10.0, n: int = 800,
         links: int = 1000, device: str = "cuda", params=None) -> dict:
    dev = resolve_device(device)
    print("== adaptive layout scheduling under graph evolution ==")
    g = synthetic_yelp(n=n, target_links=links)
    net = build_edge_network(g, 8, seed=0)
    gnn = workload_for("gat", 100)
    sched = GladA(net, gnn, g, theta=theta, R=3, seed=0)
    print(f"initial layout cost {sched.last_cost:.1f} (SLA theta={theta})")

    # Serving side: one ShardPlan compiled with capacity headroom, PATCHED
    # in place every slot (dirty partitions only), and one forward bound to
    # it: a value-only patch refreshes its plan tensors, growth rebuilds.
    cfg = GNNConfig("gcn", (g.features.shape[1], 16, 4))
    params = params_or_init(cfg, params, dev)
    plan = compile_plan(
        g, partition_from_assign(g, sched.assign, net.m, {}), slack=0.5)
    fwd = make_bsp_forward(cfg, plan, aggregate="bsr", device=dev)

    def run(graph):
        """The resident forward over ``graph`` and its largest distance
        from the whole-graph forward."""
        out = fwd(params, torch.from_numpy(
            scatter_features(plan, graph.features)).to(dev))
        out = gather_outputs(plan, out.cpu().numpy(), graph.n)
        ref = forward(cfg, params, torch.from_numpy(graph.features).to(dev),
                      directed_edges(graph.edges)).cpu().numpy()
        return out, float(np.abs(out - ref).max())

    _, err0 = run(g)
    builds0 = fwd.stats["builds"]
    patched = rebuilt = 0
    rows = []

    cur = g
    for delta in evolution_trace(g, slots, pct_links=0.02,
                                 pct_vertices=0.01, seed=1):
        new_graph = apply_delta(cur, delta)
        t0 = time.perf_counter()
        rec = sched.step(new_graph)
        step_s = time.perf_counter() - t0
        # Structure deltas: endpoints of inserted/removed links (inserted
        # vertices are movers by construction, patch_plan derives them).
        # Deleted vertices keep their id slot but lose every incident arc
        # -- those arcs are invisible in the NEW edge set, so their
        # pre-delta neighborhoods must be marked dirty explicitly.
        dirty = [delta.add_edges.ravel(), delta.del_edges.ravel(),
                 delta.del_vertices]
        dirty += [cur.neighbors(int(v)) for v in delta.del_vertices]
        dirty = np.unique(np.concatenate([d for d in dirty if len(d)])) \
            if any(len(d) for d in dirty) else None
        t0 = time.perf_counter()
        pd = patch_plan(plan, new_graph, sched.assign, dirty_vertices=dirty)
        patch_s = time.perf_counter() - t0
        patched += pd.patched
        rebuilt += not pd.patched
        t0 = time.perf_counter()
        out, err = run(new_graph)
        run_s = time.perf_counter() - t0
        cur = new_graph
        emb = float(np.abs(out).mean())
        rows.append({
            "t": rec.t, "algorithm": rec.algorithm, "cost": rec.cost,
            "drift": rec.drift_estimate, "migrated": rec.migrated_vertices,
            "plan": "patch" if pd.patched else "REBUILD",
            "dirty": int(len(pd.dirty_parts)), "num_parts": plan.num_parts,
            "emb": emb, "max_err": err, "finite": bool(np.isfinite(out).all()),
            "grew": list(pd.grew), "retrace_expected": pd.retrace_expected,
            "builds": fwd.stats["builds"], "step_s": step_s,
            "patch_s": patch_s, "forward_s": run_s})
        bar = "#" * int(40 * min(rec.cost / sched.records[0].cost, 2) / 2)
        print(f"t={rec.t:3d} {rec.algorithm:6s} cost={rec.cost:9.1f} "
              f"drift={rec.drift_estimate:8.2f} "
              f"migrated={rec.migrated_vertices:4d} "
              f"plan={'patch' if pd.patched else 'REBUILD':7s} "
              f"dirty={len(pd.dirty_parts)}/{plan.num_parts} "
              f"emb={emb:.4f} |{bar}")
    n_s = sum(1 for r in sched.records[1:] if r.algorithm == "glad-s")
    print(f"GLAD-S invoked {n_s}/{slots} slots; "
          f"final cost {sched.last_cost:.1f}")
    print(f"plan lifecycle: {patched} in-place patches, {rebuilt} full "
          f"rebuilds (capacity growth), plan v{plan.version} "
          f"cap={plan.cap} halo_cap={plan.halo_cap} e_cap={plan.e_cap}")
    return {"n": g.n, "links": g.num_edges, "device": str(dev),
            "theta": theta, "initial_cost": sched.records[0].cost,
            "initial_max_err": err0, "slots": rows, "glad_s_slots": n_s,
            "num_slots": slots, "final_cost": sched.last_cost,
            "patched": patched, "rebuilt": rebuilt,
            "plan_version": plan.version, "cap": plan.cap,
            "halo_cap": plan.halo_cap, "e_cap": plan.e_cap,
            "builds_first": builds0, "builds": fwd.stats["builds"],
            "retrace_expected": sum(r["retrace_expected"] for r in rows)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=30)
    ap.add_argument("--theta", type=float, default=10.0)
    ap.add_argument("--n", type=int, default=800)
    ap.add_argument("--links", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.slots, a.theta, a.n, a.links, device=a.device)
