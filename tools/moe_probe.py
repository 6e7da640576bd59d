#!/usr/bin/env python3
"""The MoE layer's grouped GEMM on one CUDA card: which dtypes and devices
the installed torch's ``torch._grouped_mm`` takes, whether a call waits on
the host, and the routed MoE FFN's times at deepseek-moe-16b's width.

    python3 tools/moe_probe.py [--reps N]

Prints one JSON line per check, then the card's name and power limit:

  support  ``torch._grouped_mm`` on a small ragged case (an empty group,
           rows past the last group) for CUDA and CPU in bf16 and fp32:
           whether it runs, its error against a per-group loop, and on the
           card whether it synchronises with the host
           (``torch.cuda.set_sync_debug_mode("error")``);
  ffn      ``models.moe.moe_ffn`` at deepseek-moe-16b's width (d 2048, 64
           experts of 1408, top-6) in bf16 on the card, for 8 tokens (a
           decode tick's) and 1024 (a prefill's): the route, that it runs
           with host syncs made errors, bit-equal twice, its error against
           ``moe_ffn_dense_ref``, its device time (``torch.profiler``) and
           each grouped GEMM's beside its bound (the touched experts'
           weights and the rows once, over 3.35 TB/s, or 2·rows·k·n over
           989 TFLOP/s) and beside a loop of ``torch.matmul`` over the
           experts (the loop route), and fp32 on the card (the 2-layer
           parity pass's dtype);
  k2       the flash-attention kernel (built from the checkout) at
           deepseek-moe-16b's attention shapes (16/16 heads of 128, bf16):
           causal prefill at L = 1024 and a decode of 8 slots over a
           2048-position cache with ragged kv_len, against its plain
           version, on the kernels ``kernel_path`` names.

With ``--serve`` it runs only ``chip_smoke.py``'s build and its
``moe_serve`` phase (the full 28-layer bf16 deepseek-moe-16b behind the
serving engine), whose ``moe_serve_routes`` line compares, by layer and
kind of position, the router's own choices in a teacher-forced pass that
is routed as serving routed against serving's.

``chip_smoke.py`` holds the model's gates; this probe is where the route
was chosen.  Weights are random from seed 0.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src on the path)
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402


def _support(dev, dtype):
    """torch._grouped_mm on 40 rows in 4 groups (one empty), 3 rows past
    the last group, against a per-group loop in fp32."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((40, 64), generator=gen)
    w = torch.randn((4, 64, 32), generator=gen)
    sizes = [11, 0, 19, 7]
    ends = torch.tensor(sizes).cumsum(0).to(torch.int32)
    ref, start = torch.zeros((40, 32)), 0
    for e, end in enumerate(ends.tolist()):
        ref[start:end] = x[start:end] @ w[e]
        start = end
    row = {"check": "support", "device": dev.type, "dtype": str(dtype)}
    xd, wd, ed = x.to(dev, dtype), w.to(dev, dtype), ends.to(dev)
    try:
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        out = torch._grouped_mm(xd, wd, offs=ed)
        row["host_sync"] = False
    except RuntimeError as err:                 # a probe records, not hides
        row.update(runs=False, error=str(err).splitlines()[0][:200])
        if "synchroniz" in str(err):
            row["host_sync"] = True
        return row
    finally:
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("default")
    got = out.float().cpu()
    row.update(runs=True, out_dtype=str(out.dtype),
               max_abs_err=float((got[:37] - ref[:37]).abs().max()),
               rows_past_last_group_zero=bool((got[37:] == 0).all()))
    return row


def _touched_bound(rows, k, n, experts, esize):
    """(bytes, ops, bound ms) of one grouped GEMM: the touched experts'
    weights, the rows and the output once; 2·rows·k·n operations."""
    nbytes = (experts * k * n + rows * (k + n)) * esize
    ops = 2 * rows * k * n
    t_b, t_o = nbytes / cs.HBM_BYTES_PER_S * 1e3, ops / cs.BF16_OPS_PER_S * 1e3
    return nbytes, ops, max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def _ffn(dev, cfg, T, dtype, reps):
    d, E, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    gen = torch.Generator(dev).manual_seed(cs.SEED)
    p = {"router": torch.randn((d, E), generator=gen, device=dev) * d ** -0.5,
         "w13": (torch.randn((E, d, 2 * f), generator=gen, device=dev)
                 * d ** -0.5).to(dtype),
         "w2": (torch.randn((E, f, d), generator=gen, device=dev)
                * f ** -0.5).to(dtype)}
    x = torch.randn((1, T, d), generator=gen, device=dev).to(dtype)
    route = moe.grouped_gemm_route(x[0], p["w13"])
    before = dict(moe.grouped_gemm.launches_by_route)
    torch.cuda.synchronize()
    if route == "grouped_mm":
        torch.cuda.set_sync_debug_mode("error")
    try:
        out, _ = moe.moe_ffn(cfg, p, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    again, _ = moe.moe_ffn(cfg, p, x)
    counted = {r: n - before[r]
               for r, n in moe.grouped_gemm.launches_by_route.items()}
    ref, _ = moe.moe_ffn_dense_ref(cfg, p, x)
    torch.cuda.synchronize()
    scale = float(ref.float().abs().max())
    row = {"check": "ffn", "tokens": T, "dtype": str(dtype), "route": route,
           "launches_by_route_two_calls": counted,
           "no_host_sync": route == "grouped_mm",
           "bit_equal_twice": bool(torch.equal(out, again)),
           "max_abs_err_vs_dense_ref": float((out.float() - ref.float())
                                             .abs().max()),
           "ref_max_abs": scale,
           "ffn_device_ms": cs.device_ms(lambda: moe.moe_ffn(cfg, p, x),
                                         reps=reps, label=f"ffn T{T}"),
           "ffn_ms": cs.time_ms(lambda: moe.moe_ffn(cfg, p, x), reps=reps)}
    # Each product alone, on this routing, and the loop route beside it.
    idx, _, _ = moe.router_topk(x, p["router"], cfg.top_k)
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    ends = torch.searchsorted(flat[order], torch.arange(E, device=dev),
                              right=True, out_int32=True)
    rows = x.reshape(T, d)[order // cfg.top_k].contiguous()
    act = torch.randn((rows.shape[0], f), generator=gen, device=dev).to(dtype)
    touched = int(torch.unique(flat).numel())
    esize = x.element_size()
    host_ends = ends.tolist()

    def loop(a, w):
        parts, start = [], 0
        for e, end in enumerate(host_ends):
            if end > start:
                parts.append(a[start:end] @ w[e])
            start = end
        return torch.cat(parts)

    for name, a, w in (("w13", rows, p["w13"]), ("w2", act, p["w2"])):
        nbytes, ops, bound, by = _touched_bound(a.shape[0], w.shape[1],
                                                w.shape[2], touched, esize)
        prod = {"rows": a.shape[0], "experts_touched": touched,
                "bytes": nbytes, "ops": ops, "bound_ms": bound,
                "bound_by": by,
                "loop_device_ms": cs.device_ms(lambda: loop(a, w), reps=reps,
                                               label=f"loop {name} T{T}")}
        if route == "grouped_mm":
            gm = lambda: torch._grouped_mm(a, w, offs=ends)  # noqa: E731
            err = float((gm().float() - loop(a, w).float()).abs().max())
            prod.update(grouped_mm_device_ms=cs.device_ms(
                gm, reps=reps, label=f"grouped {name} T{T}"),
                grouped_mm_vs_loop_max_abs=err)
        row[name] = prod
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--serve", action="store_true")
    args = ap.parse_args(argv)
    kind, smi_line = cs.phase_device()
    dev = torch.device("cuda", 0)
    if args.serve:
        cs.phase_build()
        cs.phase_moe_serve(dev, [])
        print(smi_line, flush=True)
        return 0
    for d in (dev, torch.device("cpu")):
        for dtype in (torch.bfloat16, torch.float32):
            cs.emit(_support(d, dtype))
    cfg = get_config("deepseek-moe-16b")
    cs.phase_build()
    gen = torch.Generator(dev).manual_seed(cs.SEED)
    H, D = cfg.n_heads, cfg.hd
    q, k, v = cs._bhld_views(gen, dev, 1, H, H, 1024, 1024, D, torch.bfloat16)
    _, err = cs._check_flash("prefill", q, k, v, None, True, "prefill_tc")
    cs.emit({"check": "k2", "shape": "prefill_L1024_D128", "max_abs_err": err})
    q, k, v = cs._bhld_views(gen, dev, 8, H, H, 1, 2048, D, torch.bfloat16)
    kl = torch.tensor([64, 1056, 700, 129, 1, 0, 2048, 511],
                      dtype=torch.int32, device=dev)
    _, err = cs._check_flash("decode", q, k, v, kl, False, "decode")
    cs.emit({"check": "k2", "shape": "decode_B8_S2048_D128",
             "max_abs_err": err})
    for T in (8, 1024):
        cs.emit(_ffn(dev, cfg, T, torch.bfloat16, args.reps))
    cs.emit(_ffn(dev, cfg, 8, torch.float32, 5))
    if cs.LOST_WINDOWS:
        cs.emit({"check": "profiler_windows", "off": len(cs.LOST_WINDOWS)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi_line, flush=True)
    print(json.dumps({"ok": True, "kind": kind}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
