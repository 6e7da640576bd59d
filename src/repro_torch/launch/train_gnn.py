"""End-to-end GNN training: train a node classifier over a
GLAD-partitioned graph, with a checkpoint, a simulated server failure and an
elastic re-layout mid-run.

  PYTHONPATH=src python -m repro_torch.launch.train_gnn [--steps 300] \
      [--device cpu]

The counterpart of the reference's ``examples/train_gnn_e2e.py``, step for
step: GLAD layout of ``synthetic_siot(1200, 4000)`` over 6 servers, half the
steps of full-batch training, a checkpoint, a failure that the
``FailureDetector`` picks up, a GLAD-E re-layout of the survivors through the
``ElasticCoordinator``, a restore, and the other half of the steps.  It
asserts at the end that the loss fell and the accuracy rose.  ``--device``
defaults to the card; the weights are random, drawn from seed 0.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch._device import resolve_device
from repro_torch.core import data_partition, workload_for
from repro_torch.gnn import GNNConfig, directed_edges, init_params
from repro_torch.gnn.training import accuracy, train_step
from repro_torch.graphs import build_edge_network, synthetic_siot
from repro_torch.runtime import ElasticCoordinator, FailureDetector
from repro_torch.train import CheckpointManager

SERVERS = 6
LR = 0.05


def main(steps: int = 300, device: str = "cuda", ckdir: str = None):
    dev = resolve_device(device)
    print("== distributed GNN training with GLAD layout + fault handling ==")
    g = synthetic_siot(n=1200, target_links=4000)
    gnn_w = workload_for("gcn", 52)
    net = build_edge_network(g, SERVERS, seed=0)
    part = data_partition(g, gnn_w, num_parts=SERVERS, net=net, seed=0)
    print(f"GLAD layout: cut_links={part.cut_links} "
          f"cost={part.cost_factors['total']:.1f}")

    cfg = GNNConfig("gcn", (52, 32, 2))
    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    sd = directed_edges(g.edges)
    ckdir = ckdir or tempfile.mkdtemp(prefix="gnn_ck_")
    ck = CheckpointManager(ckdir, keep=2, async_write=False)

    fd = FailureDetector(SERVERS, timeout_s=5.0)
    coord = ElasticCoordinator(net, g, gnn_w, part)

    feats = torch.from_numpy(g.features).to(dev)
    sdt = torch.from_numpy(sd).to(dev).long()
    lab = torch.from_numpy(g.labels).to(dev)
    a0 = accuracy(cfg, params, feats, sdt, g.labels, dev)
    half = steps // 2
    losses = []
    for s in range(half):
        params, loss = train_step(cfg, params, feats, sdt, lab, LR,
                                  device=dev)
        losses.append(float(loss))
        for d in range(SERVERS):
            fd.heartbeat(d, now=float(s))
    ck.save(half, {"params": params})
    print(f"step {half}: loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"checkpointed to {ckdir}")

    # Server 4 dies: the detector notices, GLAD-E re-layouts the survivors.
    for d in (0, 1, 2, 3, 5):
        fd.heartbeat(d, now=float(half + 6))
    dead = fd.sweep(now=float(half + 6))
    print(f"failure detected on servers {dead}")
    coord.on_failure(dead)
    ev = coord.events[-1]
    print(f"elastic re-layout: migrated={ev.migrated} vertices, "
          f"cost {ev.old_cost:.1f} -> {ev.new_cost:.1f}, "
          f"{ev.wall_time_s * 1e3:.0f} ms")

    # Restore and continue on the shrunken fleet.
    restored, _ = ck.restore(half, {"params": params})
    params = restored["params"]
    for s in range(half, steps):
        params, loss = train_step(cfg, params, feats, sdt, lab, LR,
                                  device=dev)
        losses.append(float(loss))
    a1 = accuracy(cfg, params, feats, sdt, g.labels, dev)
    print(f"step {steps}: loss {losses[-1]:.3f}; "
          f"accuracy {a0:.3f} -> {a1:.3f} on {dev}")
    assert losses[-1] < losses[0] and a1 > a0
    print("OK")
    return losses, a0, a1


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.steps, args.device)
