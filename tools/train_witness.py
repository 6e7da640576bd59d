#!/usr/bin/env python3
"""zamba2-1.2b's training, the port against the JAX reference on the CPU:
the full width cut in depth (12 layers by default: two sites of the shared
attention + MLP block, so its gradient sums over sites), fp32 compute,
AdamW from ``optim.for_model`` at lr 1e-3 (the CLI's default),
``--steps`` steps on one batch of ``train.data.batch_at_step`` (step 0,
``--batch`` x 1024 tokens, the card's ``hybrid_train`` batch at
``--batch 4``).  Both sides start from
the reference's initial weights (``params_from_jax``).  Prints each step's
loss and gradient norm on each side and their largest relative
difference, one JSON object a line.

    python3 tools/train_witness.py [--layers 12] [--batch 4] [--steps 8]

At 12 layers and 4 x 1024 tokens a side takes about 10 minutes and 20 GB
of host memory on 8 cores; ``--layers 38 --batch 1`` runs the full depth
on one row of that batch.

Like ``tests/test_torch_*.py`` it imports both packages: it is a
comparison, not part of the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import models as jz  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models.common import ShapeCfg  # noqa: E402
from repro.models.transformer import Dist  # noqa: E402
from repro.train import data as j_data  # noqa: E402
from repro.train import optim as j_optim  # noqa: E402
from repro.train.step import make_train_step as j_make_train_step  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import (init_opt_state, make_train_step,  # noqa: E402
                               optim)

ARCH = "zamba2-1.2b"
LR = 1e-3


def _emit(row):
    print(json.dumps(row), flush=True)


def _reference(cfg, params, batch, lr, steps):
    opt = dataclasses.replace(j_optim.for_model(cfg), lr=lr)
    state = j_optim.init_opt_state(opt, params)
    # Donated: the step updates the weights and moments in place, as the
    # port's does, so the full depth fits a host's memory.
    step = jax.jit(j_make_train_step(cfg, Dist(), opt),
                   donate_argnums=(0, 1))
    losses, norms, secs = [], [], []
    for _ in range(steps):
        t = time.perf_counter()
        params, state, _, m = step(params, state, None, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        secs.append(time.perf_counter() - t)
    return losses, norms, secs


def _port(cfg, params, batch, lr, steps):
    opt = dataclasses.replace(optim.for_model(cfg), lr=lr)
    state = init_opt_state(opt, params)
    step = make_train_step(cfg, opt)
    losses, norms, secs = [], [], []
    for _ in range(steps):
        t = time.perf_counter()
        params, state, _, m = step(params, state, None, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        secs.append(time.perf_counter() - t)
    return losses, norms, secs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    jcfg = dataclasses.replace(j_get_config(ARCH), n_layers=args.layers,
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(ARCH), n_layers=args.layers,
                               dtype=torch.float32)
    shape = ShapeCfg("hybrid_train", 1024, args.batch, "train")
    batch = j_data.batch_at_step(jcfg, shape, 0)
    jp = jz.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    head = {"arch": ARCH, "n_layers": args.layers,
            "batch": [args.batch, 1024], "lr": LR,
            "steps": args.steps, "dtype": "float32",
            "shared_sites": args.layers // jcfg.attn_every}
    j = _reference(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()},
                   LR, args.steps)
    del jp
    _emit({**head, "side": "reference", "losses": j[0], "grad_norms": j[1],
           "step_s": j[2]})
    t = _port(tcfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()},
              LR, args.steps)
    _emit({**head, "side": "port", "losses": t[0], "grad_norms": t[1],
           "step_s": t[2]})
    rel = lambda a, b: max(abs(x - y) / abs(y)  # noqa: E731
                           for x, y in zip(a, b))
    _emit({**head, "loss_max_rel_diff": rel(t[0], j[0]),
           "grad_norm_max_rel_diff": rel(t[1], j[1]),
           "reference_last_below_first": j[0][-1] < j[0][0],
           "port_last_below_first": t[0][-1] < t[0][0]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
