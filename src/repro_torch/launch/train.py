"""Training launcher CLI.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --steps 20 --smoke --device cpu [--ckpt-dir DIR] [--resume]

The counterpart of ``repro.launch.train`` on one device.  ``--device``
defaults to the card (the run raises without one); ``--smoke`` runs the
arch's reduced config in fp32, as the reference does.  The weights are
random, drawn from seed 0 on the device; the optimizer is the arch's
(``optim.for_model``) at ``--lr``.  Checkpoints are atomic step
directories in the reference's layout; ``--resume`` restores the latest
and replays the deterministic data stream from that step.  On the card the
step is captured into a CUDA graph at its first call and replayed after
(``make_train_step``'s ``graphs``, the reference's ``jax.jit``): each
step writes its batch into the graph's buffers, and the parameters and
optimizer state live in the tensors the step returns.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import models as zoo
from repro_torch._device import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.common import ShapeCfg
from repro_torch.train import (CheckpointManager, batch_at_step,
                               init_opt_state, make_train_step, optim)


def main(argv=None):
    """Runs the CLI; returns the losses of the steps it took."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, fp32")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    shape = ShapeCfg("cli", args.seq_len, args.batch, "train",
                     microbatches=args.microbatches)

    params = zoo.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt_cfg = dataclasses.replace(optim.for_model(cfg), lr=args.lr)
    state = init_opt_state(opt_cfg, params)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)

    ck = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ck and args.resume and ck.latest_step() is not None:
        start = ck.latest_step()
        restored, _ = ck.restore(start, {"p": params, "o": state})
        params, state = restored["p"], restored["o"]
        print(f"resumed from step {start}")

    losses = []
    t0 = time.perf_counter()
    for s in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in batch_at_step(cfg, shape, s).items()}
        params, state, _, m = step_fn(params, state, None, batch)
        losses.append(float(m["loss"]))
        if s % max(1, args.steps // 10) == 0 or s == args.steps - 1:
            print(f"step {s:5d} loss {losses[-1]:8.4f} "
                  f"|g| {float(m['grad_norm']):8.3f}")
        if ck and (s + 1) % args.ckpt_every == 0:
            ck.save(s + 1, {"p": params, "o": state})
    if ck:
        ck.wait()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    toks = (args.steps - start) * args.batch * args.seq_len
    dt = time.perf_counter() - t0
    print(f"done: {toks} tokens in {dt:.1f}s ({toks / dt:.0f} tok/s) "
          f"on {dev}")
    return losses


if __name__ == "__main__":
    main()
