#!/usr/bin/env python3
"""Where a serving engine's CUDA graph and its eager twin part, on one card.

    python3 tools/graph_probe.py [--arch llama3.2-1b] [--dtype bfloat16]
                                 [--smoke] [--head-dim 64] [--device cpu]

Serves the same prompts through ``ServeEngine`` twice on the same weights,
with CUDA graphs and without, and prints the first tick whose logits
differ.  Then one decode step from one cache, eagerly and replayed from a
graph captured after a warm-up (the cache restored in place before the
replay), with each layer's output, each attention's query and output and
the logits tapped: the first tap that differs names the op.  Prints JSON
lines; exits 1 without a card (``--device cpu`` rehearses it eagerly).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import models as zoo  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.step import Step  # noqa: E402


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _serve(cfg, params, dev, graphs, prompts):
    eng = ServeEngine(cfg, params, slots=2, max_len=64, device=dev,
                      graphs=graphs)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=6, eos_id=-1)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    ticks = []
    while eng.queue or any(r is not None for r in eng.live):
        n = eng.stats.ticks
        eng.tick()
        if eng.stats.ticks > n:
            ticks.append(eng.steps["decode"].out[0].clone())
    return [r.out_tokens for r in reqs], ticks


def _tapped_decode(cfg, params, cache):
    """decode_step with taps: (logits, each tap), the taps' names."""
    names = []

    def fn(tokens):
        taps = []
        attn, layer = transformer.attention_any, transformer._one_layer

        def attention_any(q, k, v, **kw):
            out = attn(q, k, v, **kw)
            taps.append(("attn_q", q.clone()))
            taps.append(("attn_out", out.clone()))
            return out

        def one_layer(*a, **kw):
            res = layer(*a, **kw)
            taps.append(("layer", res[0].clone()))
            return res
        transformer.attention_any = attention_any
        transformer._one_layer = one_layer
        try:
            logits, _ = zoo.decode_step(cfg, params, tokens, cache)
        finally:
            transformer.attention_any, transformer._one_layer = attn, layer
        names[:] = [n for n, _ in taps] + ["logits"]
        return [t for _, t in taps] + [logits]
    return fn, names


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--head-dim", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("graph_probe: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = dataclasses.replace(cfg, dtype=getattr(torch, args.dtype))
    if args.head_dim:
        cfg = dataclasses.replace(cfg, head_dim=args.head_dim)
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0), dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 400, size=n) for n in (20, 17, 30, 25, 40)]
    g_tok, g_ticks = _serve(cfg, params, dev, None, prompts)
    e_tok, e_ticks = _serve(cfg, params, dev, False, prompts)
    differ = [i for i, (a, b) in enumerate(zip(g_ticks, e_ticks))
              if not torch.equal(a, b)]
    emit({"probe": "engines", "arch": cfg.name, "dtype": args.dtype,
          "tokens_equal": g_tok == e_tok, "ticks": len(g_ticks),
          "ticks_differ": differ,
          "first_max_abs": (float((g_ticks[differ[0]].float()
                                   - e_ticks[differ[0]].float()).abs().max())
                            if differ else 0.0)})

    # One decode step from one cache, eager against a replay.
    eng = ServeEngine(cfg, params, slots=2, max_len=64, device=dev,
                      graphs=False)
    for i, p in enumerate(prompts[:2]):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=40, eos_id=-1))
    for _ in range(3):
        eng.tick()
    start = {k: t.clone() for k, t in eng.cache.items()}
    tokens = torch.tensor([[5], [7]], device=dev)
    cache = eng.cache
    fn, names = _tapped_decode(cfg, eng.params, cache)
    eager = [t.clone() for t in fn(tokens)]
    for k, t in cache.items():
        t.copy_(start[k])
    again = [t.clone() for t in fn(tokens)]
    step = Step("probe", fn, {"tokens": tokens.clone()},
                torch.cuda.graph_pool_handle() if dev.type == "cuda"
                else None)
    for k, t in cache.items():
        t.copy_(start[k])
    step()                                   # warm-up, then the capture
    for k, t in cache.items():
        t.copy_(start[k])
    replay = [t.clone() for t in step()]
    rows = []
    for name, a, b, c in zip(names, eager, again, replay):
        rows.append({"tap": name, "eager_twice_equal": torch.equal(a, b),
                     "replay_equal": torch.equal(a, c),
                     "replay_max_abs": float((a.float() - c.float())
                                             .abs().max())})
    first = next((r for r in rows if not r["replay_equal"]), None)
    emit({"probe": "decode_step", "arch": cfg.name, "taps": len(rows),
          "first_differing": first, "rows": rows[:12]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
