#!/usr/bin/env python3
"""A/B timing of the flash-attention kernel (K2) across source trees, on
one CUDA card.

    python3 tools/flash_probe.py [--src DIR ...] [--reps N]

``chip_smoke.py`` is the source of K2's rows (errors, event and device
times, bounds, the library calls, ptxas registers).  This probe only times
two or more versions of the kernel in turns: each ``--src`` tree (a
checkout's ``src`` directory, e.g. a parent unpacked by ``git archive``
into an ignored directory) runs in its own process, in the order A, B, B,
A for two trees, builds its own kernels and is timed on the same card.
The timing helper and the shapes are copies of ``chip_smoke.py``'s, so
that a tree older than them is timed alike.

Shapes (llama3.2-1b: 32/8 heads, head dim 64, bf16, seed 0): causal
prefill at L = 512 and 1024 (B = 1), decode of 8 slots against a
2048-position cache with kv_len drawn from [64, 1056], and the causal
backward at the LM train step's shape (B = 4, L = 1024) and at L = 512
(trees that have ``flash_attention_bwd``).  For each it prints the
kernel's device time per call (``torch.profiler``'s CUDA time over
``--reps`` calls; for the backward also by kernel, and the path when the
tree counts one) and, as the yardstick of that process, the same for
``scaled_dot_product_attention`` on the same inputs (at decode also over
the cache cut to the longest live row; for the backward its autograd
backward), with the card's name and power limit, and a SHA-256 of the
forward's output bytes: the inputs come from one seed, so two trees whose
digests agree give the same bits.  One JSON line per tree and shape.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device_ms(torch, fn, reps, tries=3, parts=None):
    """CUDA time per call over ``reps`` calls, as ``chip_smoke.device_ms``
    (kept here so that older trees given by ``--src`` are timed alike): a
    window that lost device events is measured again.  ``parts``, if
    given, receives each kernel's time per call by its name."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev and all(e.count % reps == 0 for e in dev):
            if parts is not None:
                parts.update({e.key[:60]: e.self_device_time_total / 1e3
                              / reps for e in dev})
            return sum(e.self_device_time_total for e in dev) / 1e3 / reps
    return "not measured"


def probe(src: str, reps: int) -> None:
    sys.path.insert(0, os.path.abspath(src))
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    if not torch.cuda.is_available():
        raise SystemExit("flash_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=120).stdout.strip()
    print(json.dumps({"src": src, "build_s": _build.build().seconds}),
          flush=True)
    Hq, Hkv, D, bf16 = 32, 8, 64, torch.bfloat16
    gen = torch.Generator(dev).manual_seed(0)

    def views(B, L):
        t = [torch.randn((B, L, h, D), generator=gen, device=dev, dtype=bf16)
             for h in (Hq, Hkv, Hkv)]
        return [x.transpose(1, 2) for x in t]

    def sdpa(q, k, v, kl, causal):
        mask = None
        if kl is not None:
            pos = torch.arange(k.shape[2], device=dev)
            mask = (pos[None, :] < kl[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)

    cases = [(f"prefill_L{L}", *views(1, L), None, True) for L in (512, 1024)]
    cache = torch.randn((2, 8, 2048, Hkv, D), generator=gen, device=dev,
                        dtype=bf16)
    q = torch.randn((8, 1, Hq, D), generator=gen, device=dev,
                    dtype=bf16).transpose(1, 2)
    kl = torch.from_numpy(np.random.default_rng(0).integers(
        64, 1057, size=8)).to(dev, torch.int32)
    cases.append(("decode_B8_S2048", q, cache[1].transpose(1, 2),
                  cache[0].transpose(1, 2), kl, False))
    for label, q, k, v, kl, causal in cases:
        out = flash_attention(q, k, v, kl, causal=causal)
        ref = flash_attention_plain(q, k, v, kl, causal)
        err = float((out.float() - ref.float()).abs().max())
        digest = hashlib.sha256(out.contiguous().view(torch.uint8)
                                .cpu().numpy().tobytes()).hexdigest()
        row = {"src": src, "shape": label, "max_abs_err": err,
               "out_sha256": digest,
               "device_ms": _device_ms(
                   torch, lambda: flash_attention(q, k, v, kl, causal=causal),
                   reps),
               "library_device_ms": _device_ms(
                   torch, lambda: sdpa(q, k, v, kl, causal), reps),
               "nvidia_smi": smi}
        if kl is not None:
            cut = int(kl.max())
            kc, vc = k[:, :, :cut], v[:, :, :cut]
            row["library_cut_device_ms"] = _device_ms(
                torch, lambda: sdpa(q, kc, vc, kl, causal), reps)
        print(json.dumps(row), flush=True)
    if not hasattr(FA, "flash_attention_bwd"):
        return
    for L in (1024, 512):
        q, k, v = views(4, L)
        out = flash_attention(q, k, v)
        dout = torch.randn((4, L, Hq, D), generator=gen, device=dev,
                           dtype=bf16).transpose(1, 2)
        by_path = dict(getattr(flash_attention, "backward_launches_by_path",
                               {}))
        got = FA.flash_attention_bwd(q, k, v, out, dout, None, True)
        ref = FA.flash_attention_bwd_plain(q, k, v, out, dout, None, True)
        path = [key for key, n in getattr(
            flash_attention, "backward_launches_by_path", {}).items()
            if n != by_path.get(key)]
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                 enable_gqa=True)
        parts = {}
        row = {"src": src, "shape": f"bwd_B4_L{L}",
               "path": path[0] if path else "general",
               "max_rel_err": max(
                   float((g.float() - r.float()).abs().max()
                         / r.float().abs().max()) for g, r in zip(got, ref)),
               "device_ms": _device_ms(torch, lambda: FA.flash_attention_bwd(
                   q, k, v, out, dout, None, True), reps, parts=parts),
               "device_ms_by_kernel": parts,
               "library_device_ms": _device_ms(
                   torch, lambda: torch.autograd.grad(
                       lib_out, leaves, dout, retain_graph=True), reps),
               "nvidia_smi": smi}
        print(json.dumps(row), flush=True)
        del got, ref, leaves, lib_out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    srcs = args.src or [os.path.join(HERE, "src")]
    if args.one or len(srcs) == 1:
        probe(srcs[0], args.reps)
        return 0
    order = srcs + srcs[::-1]
    for src in order:
        rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                              "--one", "--src", src, "--reps", str(args.reps)])
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
