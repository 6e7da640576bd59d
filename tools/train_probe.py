#!/usr/bin/env python3
"""The LM families' training on one CUDA card: whether the installed
torch differentiates ``torch._grouped_mm`` (the grouped GEMM's backward),
each family's peak memory at full width, and ``chip_smoke.py``'s training
phases alone (a quicker loop than the whole script while the training path
changes).

    python3 tools/train_probe.py [--phases support,memory,...]
                                 [--moe-layers 4,5]

Runs ``chip_smoke.py``'s device and build phases, then the named phases in
order (default: ``support,memory``):

  support  autograd through ``torch._grouped_mm`` on a small ragged case
           (an empty group, rows past the last group) on the card in bf16
           and fp32: dx and dw against a per-group loop in fp32, the empty
           group's dw 0, and whether the backward synchronises with the
           host (``torch.cuda.set_sync_debug_mode("error")``);
  memory   one ``make_train_step`` step (bf16 compute, fp32 weights, AdamW)
           of each family at full width on 4 x 1024 tokens (xlstm 4 x
           256): peak memory and the step's time, deepseek-moe-16b cut to
           1 dense + n MoE layers for each n of ``--moe-layers``; an
           out-of-memory step is recorded;
  sweep    zamba2-1.2b at full width, ten AdamW steps on one 4 x 1024
           batch (chip_smoke.py's main run) for each of bf16 compute at
           lr 1e-3, fp32 compute at lr 1e-3 and bf16 compute at lr 3e-4
           (``OptConfig``'s default): each step's loss and gradient norm,
           to tell bf16 rounding from the optimisation's own course;
  train_kernels, lm_train, moe_train, hybrid_train, vlm_train,
  encdec_train, xlstm_train
           ``chip_smoke.py``'s phases of those names (their gates hold;
           each train phase counts from 0 as the script's main path does;
           lm_train with its 2-layer parity pass first).

Prints the card's name and power limit last.  Weights are random from
seed 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src on the path)
import torch  # noqa: E402

from repro_torch import models as lm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.common import ShapeCfg  # noqa: E402
from repro_torch.train import (batch_at_step, init_opt_state,  # noqa: E402
                               make_train_step, optim)

CHIP_PHASES = ("train_kernels", "lm_train", "moe_train", "hybrid_train",
               "vlm_train", "encdec_train", "xlstm_train")
PHASES = ("support", "memory", "sweep") + CHIP_PHASES
SWEEP_ARCH = "zamba2-1.2b"


def _support(dev, dtype):
    """Autograd through ``torch._grouped_mm`` over 40 rows in 4 groups (one
    empty), 3 rows past the last group, against a per-group loop in
    fp32."""
    gen = torch.Generator().manual_seed(0)
    m, k, n = 40, 64, 32
    x = torch.randn((m, k), generator=gen)
    w = torch.randn((4, k, n), generator=gen)
    dy = torch.randn((m, n), generator=gen)
    ends = torch.tensor([11, 0, 19, 7]).cumsum(0).to(torch.int32)
    dx_ref, dw_ref, start = torch.zeros((m, k)), torch.zeros((4, k, n)), 0
    for e, end in enumerate(ends.tolist()):
        dx_ref[start:end] = dy[start:end] @ w[e].t()
        dw_ref[e] = x[start:end].t() @ dy[start:end]
        start = end
    xa, wa = (t.to(dev, dtype).requires_grad_(True) for t in (x, w))
    dyd, ed = dy.to(dev, dtype), ends.to(dev)
    y = torch._grouped_mm(xa, wa, offs=ed)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gx, gw = torch.autograd.grad(y, (xa, wa), dyd, retain_graph=True)
        torch.cuda.synchronize()
        row = {"runs": True, "host_sync": False}
    except RuntimeError as err:                 # a probe records, not hides
        row = {"runs": False, "error": str(err).splitlines()[0][:200],
               "host_sync": "synchroniz" in str(err)}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not row["runs"] and row["host_sync"]:
        gx, gw = torch.autograd.grad(y, (xa, wa), dyd)  # runs, with a sync
        row["runs"] = True
    if row["runs"]:
        row.update(
            dx_max_abs_err=float((gx.float().cpu()[:37] - dx_ref[:37])
                                 .abs().max()),
            dw_max_abs_err=float((gw.float().cpu() - dw_ref).abs().max()),
            ref_max_abs=float(max(dx_ref.abs().max(), dw_ref.abs().max())),
            dw_of_empty_group_zero=bool((gw[1] == 0).all()))
    return {"check": "support", "dtype": str(dtype), **row}


def _memory(dev, cfg, seq: int):
    """One AdamW step at 4 x ``seq`` tokens: peak GB and step seconds, or
    the out-of-memory error."""
    cs._fresh_device()
    row = {"check": "memory", "arch": cfg.name, "n_layers": cfg.n_layers,
           "batch": [4, seq]}
    try:
        params = lm.init_params(cfg, torch.Generator(dev).manual_seed(
            cs.SEED), dev)
        opt_cfg = dataclasses.replace(optim.for_model(cfg), lr=1e-3)
        state = init_opt_state(opt_cfg, params)
        batch = {k: torch.from_numpy(x).to(dev) for k, x in batch_at_step(
            cfg, ShapeCfg("probe", seq, 4, "train"), 0).items()}
        row["params"] = sum(t.numel() for t in optim.leaves(params))
        row["state_gb"] = torch.cuda.memory_allocated() / 1e9
        step = make_train_step(cfg, opt_cfg, graphs=False)
        times = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, state, _, m = step(params, state, None, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        row.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   step_s=times, loss=float(m["loss"]))
    except torch.cuda.OutOfMemoryError as err:  # a probe records, not hides
        row.update(oom=True, error=str(err).splitlines()[0][:160])
    return row


def _sweep(dev, steps: int = 10):
    """Ten steps of zamba2-1.2b at full width on chip_smoke.py's batch for
    each (compute dtype, lr): the losses and gradient norms."""
    for dtype, lr in ((torch.bfloat16, 1e-3), (torch.float32, 1e-3),
                      (torch.bfloat16, 3e-4)):
        cs._fresh_device()
        cfg = dataclasses.replace(get_config(SWEEP_ARCH), dtype=dtype)
        params = lm.init_params(cfg, torch.Generator(dev).manual_seed(
            cs.SEED), dev)
        opt_cfg = dataclasses.replace(optim.for_model(cfg), lr=lr)
        state = init_opt_state(opt_cfg, params)
        batch = {k: torch.from_numpy(x).to(dev) for k, x in batch_at_step(
            cfg, ShapeCfg("hybrid_train", 1024, 4, "train"), 0).items()}
        step = make_train_step(cfg, opt_cfg, graphs=False)
        losses, norms = [], []
        for _ in range(steps):
            params, state, _, m = step(params, state, None, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        cs.emit({"check": "sweep", "arch": SWEEP_ARCH,
                 "dtype": str(dtype), "lr": lr, "losses": losses,
                 "grad_norms": norms})
        del params, state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="support,memory")
    ap.add_argument("--moe-layers", default="4,5")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        raise SystemExit(f"unknown phases {unknown}; known: {PHASES}")
    t0 = time.perf_counter()
    _, smi_line = cs.phase_device()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    for name in phases:
        t = time.perf_counter()
        if name == "support":
            for dtype in (torch.bfloat16, torch.float32):
                cs.emit(_support(dev, dtype))
        elif name == "sweep":
            _sweep(dev)
        elif name == "memory":
            for n in map(int, args.moe_layers.split(",")):
                ds = get_config("deepseek-moe-16b")
                cs.emit(_memory(dev, dataclasses.replace(
                    ds, n_layers=ds.first_dense_layers + n), 1024))
            for arch in ("zamba2-1.2b", "internvl2-2b",
                         "seamless-m4t-medium"):
                cs.emit(_memory(dev, get_config(arch), 1024))
            cs.emit(_memory(dev, get_config("xlstm-1.3b"), 256))
        elif name == "train_kernels":
            cs.phase_train_kernels(dev)
        elif name == "lm_train":
            cs.phase_lm_train(dev)
        else:
            cs.phase_family_train(name, dev)
        cs.emit({"phase": f"{name}_seconds",
                 "seconds": time.perf_counter() - t})
    cs.emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(smi_line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
