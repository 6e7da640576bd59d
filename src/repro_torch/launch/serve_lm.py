"""Serve an LM with continuously-batched requests: the reduced llama config
in fp32 by default; ``--full`` serves the full-width llama3.2-1b in bf16 on
the same engine.

  PYTHONPATH=src python -m repro_torch.launch.serve_lm [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --full

The counterpart of the reference's ``examples/serve_lm.py``: 12 requests of
12 new tokens, prompts of 4-19 tokens drawn from ``default_rng(0)``, behind
``ServeEngine(slots=4, max_len=96)``, served by ``launch.serve``'s own
body: ``--full`` serves what ``launch.serve --arch llama3.2-1b --requests
12`` serves, with this example's printed line and record.  The reduced
model's weights are drawn from a CPU generator seeded 0, so the card and
the CPU serve the same model; the full model's are drawn on the device (as
``launch.serve`` draws them) and held in bf16.  On the card every
attention call goes through the ``flash_attention`` kernel (K2).  ``main``
returns a JSON-able record of every printed field, the engine's
``max_len`` and each request's prompt and tokens.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import models as zoo
from repro_torch._device import resolve_device
from repro_torch.launch.serve import serve_config, serve_random

ARCH = "llama3.2-1b"
SLOTS, MAX_LEN = 4, 96


def main(full: bool = False, device: str = "cuda", params=None) -> dict:
    dev = resolve_device(device)
    print("== batched LM serving (continuous batching) ==")
    cfg = serve_config(ARCH, smoke=not full)
    if params is None:
        gen = torch.Generator(dev if full else "cpu").manual_seed(0)
        params = zoo.init_params(cfg, gen, dev)
    stats, reqs, dt = serve_random(cfg, params, dev, requests=12,
                                   slots=SLOTS, max_len=MAX_LEN, max_new=12)
    print(f"completed {stats.completed} requests in {stats.ticks} decode "
          f"ticks ({stats.prefills} prefills), "
          f"{stats.generated_tokens} tokens in {dt:.2f}s "
          f"({stats.generated_tokens / dt:.1f} tok/s on {dev})")
    return {"arch": cfg.name, "full": full, "dtype": str(cfg.dtype),
            "device": str(dev), "n_layers": cfg.n_layers,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.d_model // cfg.n_heads, "max_len": MAX_LEN,
            "completed": stats.completed, "ticks": stats.ticks,
            "prefills": stats.prefills,
            "generated_tokens": stats.generated_tokens, "seconds": dt,
            "tok_per_s": stats.generated_tokens / dt,
            "prompts": [r.prompt.tolist() for r in reqs],
            "tokens": [list(map(int, r.out_tokens)) for r in reqs]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the full-width llama3.2-1b in bf16")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.full, device=a.device)
