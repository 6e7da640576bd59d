"""The readings a cell's limits are set from, on the card at the cell's
own size, in one process:

    python bench/calibrate.py --workload <name> --seeds 12 [--faults 3]

For each of ``--seeds`` seeds the program's numbers (the cell's set-up
and a short window, then the comparison, as a run makes them): the lower
readings.  For the first ``--controls`` seeds the control's: the plain
reference in TF32 in the program's place.  For the first ``--faults``
seeds each planted fault's (``bench/faults.py``).  One JSON line each,
and a summary line with the largest program reading and the smallest
control and fault readings of every number.  Not part of a run."""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]


def main(argv, device: str = "cuda") -> dict:
    ap = argparse.ArgumentParser(prog="bench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    args = ap.parse_args(argv)

    import torch
    from bench import faults, harness, loop
    wl = harness.cell(harness.spec(), args.workload)
    dev = torch.device(device)
    graphs = None if dev.type == "cuda" else False
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("calibrate: no CUDA device")
    conf = harness.config(wl["config"])
    system = harness.system_module(conf).System(conf, dev, graphs)
    kind = harness.generator(wl["generator"])
    limits = wl["limits"]
    ring = wl["params"].get("ring", 1)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    def one(seed, what, fault=None):
        undo = faults.plant(fault, wl["generator"]) if fault else None
        try:
            system.release()
            t0 = time.perf_counter()
            tr = kind.Traffic(system, seed, wl["params"])
            loop.run_steps(tr.call, 2 * ring + 1, harness.DEPTH, dev)
            tr.release()
            system.release()
            if what == "control":
                numbers, _, _ = tr.control(limits)
            else:
                numbers, _, _ = tr.check(limits)
        finally:
            if undo:
                undo()
        emit({"workload": args.workload, "what": what, "fault": fault,
              "seed": seed, "seconds": time.perf_counter() - t0,
              "numbers": {k: v for k, (v, _) in numbers.items()},
              **({"leaves": tr.leaf_norms}
                 if hasattr(tr, "leaf_norms") else {})})

    for seed in seeds:
        one(seed, "program")
    for seed in seeds[: args.controls]:
        one(seed, "control")
    for fault in faults.FAULTS:
        for seed in seeds[: args.faults]:
            one(seed, "fault", fault)

    summary = {"workload": args.workload, "what": "summary",
               **system.values(),
               **{k: v for k, (v, _) in system.checks(limits).items()}}
    names = rows[0]["numbers"].keys()
    for k in names:
        prog = [r["numbers"][k] for r in rows if r["what"] == "program"]
        summary[k] = {
            "lower": max(prog),
            "control": min((r["numbers"][k] for r in rows
                            if r["what"] == "control"), default=None),
            **{f: min((r["numbers"][k] for r in rows if r["fault"] == f),
                      default=None) for f in faults.FAULTS}}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
