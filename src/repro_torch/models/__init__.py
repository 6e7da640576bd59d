"""Model zoo: family dispatch.

The dense and MoE families run through ``transformer``, the hybrid (Mamba2
+ shared attention) family through ``ssm`` and the xLSTM family through
``xlstm``; the others raise ``NotImplementedError`` naming the slice queued
for them (``common.QUEUED_FAMILIES``).
"""
from repro_torch.models.common import (LMConfig, QUEUED_FAMILIES, SHAPES,
                                       ShapeCfg, check_family)
from repro_torch.models import moe, ssm, transformer, xlstm

_FAMILY = {
    "dense": transformer,
    "moe": transformer,
    "hybrid": ssm,
    "ssm": xlstm,
}


def family_module(cfg: LMConfig):
    check_family(cfg.name, cfg.family)
    return _FAMILY[cfg.family]


def init_params(cfg, generator=None, device="cuda"):
    return family_module(cfg).init_params(cfg, generator, device)


def forward(cfg, params, batch):
    return family_module(cfg).forward(cfg, params, batch)


def loss_fn(cfg, params, batch):
    return family_module(cfg).loss_fn(cfg, params, batch)


def prefill(cfg, params, batch, max_len):
    return family_module(cfg).prefill(cfg, params, batch, max_len)


def decode_step(cfg, params, tokens, cache):
    return family_module(cfg).decode_step(cfg, params, tokens, cache)


def init_cache(cfg, batch, max_len, device="cuda"):
    return family_module(cfg).init_cache(cfg, batch, max_len, device=device)


__all__ = [
    "LMConfig", "QUEUED_FAMILIES", "SHAPES", "ShapeCfg", "family_module",
    "init_params", "forward", "loss_fn", "prefill", "decode_step",
    "init_cache", "moe", "ssm", "transformer", "xlstm",
]
