"""Architecture registry: ``--arch <id>`` resolution.

The reference's ten archs keep their ids, and every one of them runs in
the port (``QUEUED``, the archs whose family waits for a later slice, is
empty).  An unknown id raises ``KeyError``.  The dry-run input specs
(``input_specs``, ``all_cells``) belong to ``launch/`` and come with it.
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import LMConfig

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
