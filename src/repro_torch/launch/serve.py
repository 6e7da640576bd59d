"""Serving launcher CLI — continuous batching over a reduced (or full) arch.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --requests 8 --max-new 12

The counterpart of ``repro.launch.serve``.  ``--device`` defaults to the
card; the weights are random, drawn from seed 0 on that device.
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
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = zoo.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    eng = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len,
                      device=dev)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for uid in range(args.requests):
        plen = int(rng.integers(4, 20))
        prompt = rng.integers(1, cfg.vocab, size=plen).astype(np.int32)
        eng.submit(Request(uid=uid, prompt=prompt,
                           max_new_tokens=args.max_new, eos_id=-1))
    stats = eng.run()
    dt = time.perf_counter() - t0
    print(f"{stats.completed}/{args.requests} requests, "
          f"{stats.generated_tokens} tokens in {stats.ticks} ticks, "
          f"{dt:.2f}s ({stats.generated_tokens / dt:.1f} tok/s) on {dev}")


if __name__ == "__main__":
    main()
