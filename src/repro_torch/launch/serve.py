"""Serving launcher CLI — continuous batching over a reduced (or full) arch.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --requests 8 --max-new 12

The counterpart of ``repro.launch.serve``.  ``--device`` defaults to the
card; the weights are random, drawn from seed 0 on that device.  At full
width (without ``--smoke``) they are held in ``cfg.dtype``
(``param_dtype = dtype``), so deepseek-moe-16b's 16.4 B parameters take
32.8 GB in bf16 and the engine keeps no second copy:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b

The recurrent families run the same way (``--arch zamba2-1.2b``, ``--arch
xlstm-1.3b``), and the VLM family as text only (``--arch internvl2-2b``);
they prefill each prompt at its exact length.  The enc-dec family
(``--arch seamless-m4t-medium``) is refused, as the reference refuses it.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import models as zoo
from repro_torch._device import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.serve import Request, ServeEngine


def serve_config(arch: str, smoke: bool):
    """``arch``'s config as the launchers serve it: the reduced config in
    fp32 under ``smoke``, else the full one with its weights held in
    ``cfg.dtype``."""
    if smoke:
        return dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    cfg = get_config(arch)
    return dataclasses.replace(cfg, param_dtype=cfg.dtype)


def serve_random(cfg, params, dev, *, requests: int, slots: int = 4,
                 max_len: int = 96, max_new: int = 12):
    """Serve ``requests`` random prompts (4-19 tokens of ids 1..vocab,
    drawn from ``default_rng(0)``) of ``max_new`` tokens each through one
    ``ServeEngine``; returns its stats, the requests and the seconds the
    submissions and the run took."""
    eng = ServeEngine(cfg, params, slots=slots, max_len=max_len, device=dev)
    rng = np.random.default_rng(0)
    reqs = []
    t0 = time.perf_counter()
    for uid in range(requests):
        plen = int(rng.integers(4, 20))
        prompt = rng.integers(1, cfg.vocab, size=plen).astype(np.int32)
        reqs.append(Request(uid=uid, prompt=prompt, max_new_tokens=max_new,
                            eos_id=-1))
        eng.submit(reqs[-1])
    stats = eng.run()
    return stats, reqs, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = serve_config(args.arch, args.smoke)
    if cfg.family in ("encdec",):
        raise SystemExit("serve CLI drives decoder-only archs; "
                         "enc-dec serving needs frames input (see tests)")
    params = zoo.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    stats, _, dt = serve_random(cfg, params, dev, requests=args.requests,
                                slots=args.slots, max_len=args.max_len,
                                max_new=args.max_new)
    print(f"{stats.completed}/{args.requests} requests, "
          f"{stats.generated_tokens} tokens in {stats.ticks} ticks, "
          f"{dt:.2f}s ({stats.generated_tokens / dt:.1f} tok/s) on {dev}")


if __name__ == "__main__":
    main()
