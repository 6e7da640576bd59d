"""Architecture registry: ``--arch <id>`` resolution, shape applicability,
and the dry-run's input stand-ins (meta tensors: shapes and dtypes, no
storage).

The reference's ten archs keep their ids, and every one of them runs in
the port (``QUEUED``, the archs whose family waits for a later slice, is
empty).  An unknown id raises ``KeyError``.
"""
from __future__ import annotations

import importlib
from typing import Dict, Optional

import torch

from repro_torch.models.common import LMConfig, SHAPES, ShapeCfg

ARCHS = {
    "llama3.2-1b": "llama3_2_1b",
    "qwen2.5-32b": "qwen2_5_32b",
    "yi-9b": "yi_9b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "zamba2-1.2b": "zamba2_1_2b",
    "xlstm-1.3b": "xlstm_1_3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "internvl2-2b": "internvl2_2b",
}

# Archs of the reference whose family has no port yet -> family: none.
QUEUED: dict = {}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> LMConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> LMConfig:
    return _module(arch).SMOKE


def skip_reason(arch: str, shape: str) -> Optional[str]:
    return getattr(_module(arch), "SKIP_SHAPES", {}).get(shape)


def applicable_shapes(arch: str):
    return [s for s in SHAPES if skip_reason(arch, s) is None]


def all_cells():
    """Every (arch, shape) baseline cell, with skips resolved (40 total,
    minus documented long_500k skips)."""
    for arch in ARCHS:
        for shape in SHAPES:
            yield arch, shape, skip_reason(arch, shape)


def frames_len(cfg: LMConfig, shape: ShapeCfg) -> int:
    """Audio-frontend stub length: frames scale with the text length but are
    capped (a 30 s utterance ~ 1500 frames)."""
    return min(max(cfg.frontend_len, shape.seq_len // 4), 4096)


def input_specs(cfg: LMConfig, shape: ShapeCfg) -> Dict:
    """Meta-tensor stand-ins for one step's inputs (the dry-run contract).

    train/prefill: the full batch.  decode: one new token + the KV/state
    cache at seq_len occupancy (the family's ``init_cache`` on the meta
    device)."""
    B = shape.global_batch
    L = shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": meta((B, L), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = meta((B, L), torch.int32)
        if cfg.family == "encdec":
            specs["frames"] = meta((B, frames_len(cfg, shape),
                                    cfg.frontend_dim), cfg.dtype)
        if cfg.family == "vlm":
            specs["patches"] = meta((B, cfg.frontend_len, cfg.frontend_dim),
                                    cfg.dtype)
        return specs
    # decode: one token against a cache filled to seq_len.
    from repro_torch import models as zoo
    return {"tokens": meta((B, 1), torch.int32),
            "cache": zoo.init_cache(cfg, B, L, device="meta")}

