"""Deterministic synthetic data pipeline: a numpy copy of
``repro.train.data`` whose batches are bit-equal to the reference's.

Per-step batches are derived from (seed, step) only — any host can produce
its own shard without coordination, and restart-at-step-N replays the exact
stream (the property checkpoint/restart correctness tests rely on).  The
token stream mimics packed documents: zipf-ish unigram draw + EOS resets,
labels = next token with EOS boundaries masked.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.common import LMConfig, ShapeCfg

EOS = 0


@dataclasses.dataclass
class DataConfig:
    seed: int = 0
    mean_doc_len: int = 512
    zipf_a: float = 1.2


def batch_at_step(cfg: LMConfig, shape: ShapeCfg, step: int,
                  data_cfg: DataConfig = DataConfig(),
                  host_slice: Optional[slice] = None) -> Dict[str, np.ndarray]:
    """Materialize the global (or per-host slice of the) batch for ``step``."""
    B, L = shape.global_batch, shape.seq_len
    rows = range(B)[host_slice] if host_slice is not None else range(B)
    # Per-ROW seeding so any host materializes exactly its slice of the
    # global batch (coordination-free sharded loading).
    tokens = np.empty((len(rows), L), np.int32)
    labels = np.empty((len(rows), L), np.int32)
    for k, r in enumerate(rows):
        rng = np.random.default_rng(
            np.random.SeedSequence([data_cfg.seed, step, r]))
        toks = rng.zipf(data_cfg.zipf_a, size=L + 1)
        toks = np.clip(toks, 1, cfg.vocab - 1).astype(np.int32)
        eos = rng.random(L + 1) < 1.0 / data_cfg.mean_doc_len
        toks[eos] = EOS
        tokens[k] = toks[:L]
        lab = toks[1:L + 1].astype(np.int32)
        labels[k] = np.where(tokens[k] == EOS, -100, lab)
    out = {"tokens": tokens, "labels": labels}
    rng = np.random.default_rng(np.random.SeedSequence(
        [data_cfg.seed, step, 1 << 20]))
    if cfg.family == "encdec":
        F = min(max(cfg.frontend_len, L // 4), 4096)
        out["frames"] = rng.standard_normal(
            (len(rows), F, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (len(rows), cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return out


def stream(cfg: LMConfig, shape: ShapeCfg, start_step: int = 0,
           data_cfg: DataConfig = DataConfig()) -> Iterator[Dict]:
    step = start_step
    while True:
        yield batch_at_step(cfg, shape, step, data_cfg)
        step += 1
