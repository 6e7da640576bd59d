#!/usr/bin/env python3
"""Host time of a value-only relayout on one CUDA card: the patch, then each
model's first BSP forward after it.

    python3 tools/relayout_probe.py [--src DIR] [--rounds N]

It builds the SIoT plan that ``chip_smoke.py`` builds (8 partitions of a
random layout, slack 0.5, BSR bm = 8, bk = 128), runs one GCN and one SAGE
ppermute forward over it, and then, ``--rounds`` times, moves 2% of the
vertices to other partitions with ``patch_plan`` and times, on the host
clock with the card synchronised: the patch, each model's first forward
after it (which refreshes that forward's resident plan tensors), and each
model's second forward.  A round whose patch grows the plan ends the run.
``--src`` imports ``repro_torch`` from another checkout's ``src`` directory
(a parent commit unpacked with ``git archive``), so that two trees are
timed by the same probe in one call.
Prints one JSON line per round and a summary line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch

    from repro_torch.configs import gnn_paper
    from repro_torch.core import partition_from_assign
    from repro_torch.gnn import (
        build_plan_bsr, compile_plan, init_params, make_bsp_forward,
        patch_plan, scatter_features)
    from repro_torch.graphs import synthetic_siot

    if not torch.cuda.is_available():
        raise SystemExit("relayout_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    parts, seed = 8, 0
    g = synthetic_siot()
    # The draws of random_layout (the same in every tree this probe times).
    assign = np.random.default_rng(seed).integers(0, parts, size=g.n)
    plan = compile_plan(g, partition_from_assign(g, assign, parts, {}),
                        slack=0.5)
    build_plan_bsr(plan)
    models = ("gcn", "sage")
    fwds, params = {}, {}
    for m in models:
        cfg = gnn_paper.ALL[("siot", m)]
        params[m] = init_params(cfg, torch.Generator().manual_seed(seed), dev)
        fwds[m] = make_bsp_forward(cfg, plan, exchange="ppermute", device=dev)

    def timed(m, blocks):
        t0 = time.perf_counter()
        fwds[m](params[m], blocks)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    blocks = torch.from_numpy(scatter_features(plan, g.features)).to(dev)
    for m in models:
        timed(m, blocks)
    rng = np.random.default_rng(seed + 1)
    rows = []
    for rnd in range(args.rounds):
        k = g.n // 50
        movers = rng.choice(g.n, size=k, replace=False)
        new = plan.assign.copy()
        new[movers] = (new[movers] + rng.integers(1, parts, size=k)) % parts
        t0 = time.perf_counter()
        delta = patch_plan(plan, g, new)
        patch_s = time.perf_counter() - t0
        if delta.retrace_expected:           # rounds are value-only patches
            print(json.dumps({"round": rnd, "grew": list(delta.grew)}))
            break
        blocks = torch.from_numpy(scatter_features(plan, g.features)).to(dev)
        first = {m: timed(m, blocks) for m in models}
        second = {m: timed(m, blocks) for m in models}
        builds = {m: f.stats["builds"] for m, f in fwds.items()}
        if builds != {m: 1 for m in models}:
            raise SystemExit(f"relayout_probe: a value-only patch rebuilt "
                             f"a forward: {builds}")
        row = {"round": rnd, "moved": int(len(delta.moved)),
               "host_patch_s": patch_s, "first_forward_s": first,
               "second_forward_s": second,
               "relayout_s": patch_s + sum(first.values())}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if not rows:
        raise SystemExit("relayout_probe: the first patch grew the plan")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=120).stdout.strip()
    print(json.dumps({
        "src": os.path.relpath(os.path.abspath(args.src)), "card": smi,
        "relayout_s": [r["relayout_s"] for r in rows],
        "first_forward_s": {m: [r["first_forward_s"][m] for r in rows]
                            for m in models},
        "second_forward_s": {m: [r["second_forward_s"][m] for r in rows]
                             for m in models}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
