#!/usr/bin/env python3
"""The recurrent families' phases of ``chip_smoke.py`` alone, on one CUDA
card: a quicker loop than the whole script while the hybrid (zamba2-1.2b)
and xLSTM (xlstm-1.3b) paths change.

    python3 tools/recurrent_probe.py [--phases kernels,hybrid_parity,...]

Runs ``chip_smoke.py``'s device and build phases, then the named phases in
order (default: all of them): ``kernels`` (every K2 row of the script,
zamba2's shapes among them), ``hybrid_parity``, ``hybrid_serve``,
``xlstm_parity``, ``xlstm_serve``, ``recurrent_fp32``, and the probe's
own ``faults`` (what the serve phases' rounding check reads under injected
state-path faults: :func:`phase_faults`).  The script's phases print its
JSON lines and hold its gates; the serve phases count K2's launches from 0
as the script's main path does.  Prints the card's name and power limit
last.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

PHASES = ("kernels", "hybrid_parity", "hybrid_serve", "xlstm_parity",
          "xlstm_serve", "recurrent_fp32", "faults")


class _KVOnlySplice:
    """While entered, a prefill's cache keeps only its ``k``, ``v`` and
    ``len`` keys, so the engine splices a request's KV cache into its slot
    and none of its recurrent state: the engine's splice before the
    recurrent families were ported."""

    def __enter__(self):
        self.prefill = cs.lm.prefill

        def prefill(*args):
            logits, cache = self.prefill(*args)
            return logits, {k: v for k, v in cache.items()
                            if k in ("k", "v", "len")}
        cs.lm.prefill = prefill
        return self

    def __exit__(self, *exc):
        cs.lm.prefill = self.prefill


def phase_faults(dev):
    """What the recurrent serve phases' rounding check reads under two
    state-path faults injected into the engine, for each recurrent arch:
    ``bucketed`` (prompts padded to a power-of-two bucket, so pad tokens
    pass through the state) and ``kv_only_splice`` (:class:`_KVOnlySplice`).
    The same traffic and weights as ``chip_smoke.py``'s serve phases;
    prints serving's and the bf16 forward's distances from the fp32 model
    and their ratio, beside ``REC_NOISE_RATIO``."""
    import contextlib
    for arch in ("zamba2-1.2b", "xlstm-1.3b"):
        for fault in ("bucketed", "kv_only_splice"):
            cs._fresh_device()
            cfg = cs.get_config(arch)
            cfg = cs.dataclasses.replace(cfg, param_dtype=cfg.dtype)
            params = cs.lm.init_params(
                cfg, cs.torch.Generator(dev).manual_seed(cs.SEED), dev)
            engine = cs.ServeEngine(cfg, params, slots=cs.REC_SLOTS,
                                    max_len=cs.REC_MAX_LEN, device=dev,
                                    graphs=False)
            del params
            engine._bucketed = fault == "bucketed"
            rng = cs.np.random.default_rng(cs.SEED)
            reqs = [cs.Request(uid=i, prompt=rng.integers(
                        1, cfg.vocab, size=int(n)), max_new_tokens=32,
                        eos_id=-1)
                    for i, n in enumerate(rng.integers(64, 1025, size=16))]
            for r in reqs:
                engine.submit(r)
            splice = (_KVOnlySplice() if fault == "kv_only_splice"
                      else contextlib.nullcontext())
            with splice, cs._LogitLog(engine, reqs) as log:
                engine.run()
            gaps, d_served, d_forward, exact = cs._rescore_recurrent(
                cfg, engine.params, reqs, log.logits, dev)
            cs.emit({"phase": "faults", "arch": cfg.name, "fault": fault,
                     "served_vs_fp32": {"median": float(d_served.median()),
                                        "max": float(d_served.max())},
                     "bf16_forward_vs_fp32": {
                         "median": float(d_forward.median()),
                         "max": float(d_forward.max())},
                     "noise_ratio": {
                         "median": float(d_served.median()
                                         / d_forward.median()),
                         "max": float(d_served.max() / d_forward.max())},
                     "noise_ratio_tol": cs.REC_NOISE_RATIO,
                     "teacher_forced_exact": exact,
                     "teacher_forced_max_gap": float(gaps.max()),
                     "tokens": int(gaps.numel())})
            del engine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        raise SystemExit(f"unknown phases {unknown}; known: {PHASES}")
    t0 = time.perf_counter()
    _, smi_line = cs.phase_device()
    dev = cs.torch.device("cuda", 0)
    cs.phase_build()
    for name in phases:
        t = time.perf_counter()
        if name == "kernels":
            cs.phase_flash_kernels(dev)
        elif name == "faults":
            phase_faults(dev)
        else:
            getattr(cs, f"phase_{name}")(dev)
        cs.emit({"phase": f"{name}_seconds",
                 "seconds": time.perf_counter() - t})
    cs.emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(smi_line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
