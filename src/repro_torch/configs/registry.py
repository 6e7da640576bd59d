"""Architecture registry: ``--arch <id>`` resolution.

The reference's ten archs keep their ids.  The dense family runs in the
port; an arch of a family not ported yet raises ``NotImplementedError``
naming the slice queued for it (``ROADMAP.md``).  The dry-run input specs
(``input_specs``, ``all_cells``) belong to ``launch/`` and come with it.
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import LMConfig, check_family

ARCHS = {
    "llama3.2-1b": "llama3_2_1b",
    "qwen2.5-32b": "qwen2_5_32b",
    "yi-9b": "yi_9b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
}

# Archs of the reference whose family has no port yet -> family.
QUEUED = {
    "zamba2-1.2b": "hybrid",
    "xlstm-1.3b": "ssm",
    "seamless-m4t-medium": "encdec",
    "internvl2-2b": "vlm",
    "deepseek-moe-16b": "moe",
    "kimi-k2-1t-a32b": "moe",
}


def _module(arch: str):
    if arch in QUEUED:
        check_family(arch, QUEUED[arch])
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(ARCHS) + sorted(QUEUED)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> LMConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> LMConfig:
    return _module(arch).SMOKE
