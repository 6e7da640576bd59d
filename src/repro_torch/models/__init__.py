"""Model zoo: family dispatch.

The dense family runs in the port; the others raise ``NotImplementedError``
naming the slice queued for them (``common.QUEUED_FAMILIES``).
"""
from repro_torch.models.common import (LMConfig, QUEUED_FAMILIES, SHAPES,
                                       ShapeCfg, check_family)
from repro_torch.models import transformer


def family_module(cfg: LMConfig):
    check_family(cfg.name, cfg.family)
    return transformer


def init_params(cfg, generator=None, device="cuda"):
    return family_module(cfg).init_params(cfg, generator, device)


def forward(cfg, params, batch):
    return family_module(cfg).forward(cfg, params, batch)


def prefill(cfg, params, batch, max_len):
    return family_module(cfg).prefill(cfg, params, batch, max_len)


def decode_step(cfg, params, tokens, cache):
    return family_module(cfg).decode_step(cfg, params, tokens, cache)


def init_cache(cfg, batch, max_len, device="cuda"):
    return family_module(cfg).init_cache(cfg, batch, max_len, device=device)


__all__ = [
    "LMConfig", "QUEUED_FAMILIES", "SHAPES", "ShapeCfg", "family_module",
    "init_params", "forward", "prefill", "decode_step", "init_cache",
    "transformer",
]
