"""Model zoo: family dispatch.

The dense, MoE and VLM families run through ``transformer``, the hybrid
(Mamba2 + shared attention) family through ``ssm``, the xLSTM family
through ``xlstm`` and the enc-dec family through ``encdec``: every family
of the reference.  A family the reference does not have raises
``NotImplementedError`` (``common.check_family``).

``forward``, ``loss_fn``, ``prefill`` and ``decode_step`` take the
reference's ``dist`` (default: no mesh); every family runs under a mesh.
"""
from repro_torch.models.common import (NO_DIST, Dist, LMConfig,
                                       QUEUED_FAMILIES, SHAPES, ShapeCfg,
                                       check_family)
from repro_torch.models import encdec, moe, ssm, transformer, xlstm

_FAMILY = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "hybrid": ssm,
    "ssm": xlstm,
    "encdec": encdec,
}


def family_module(cfg: LMConfig):
    check_family(cfg.name, cfg.family)
    return _FAMILY[cfg.family]


def init_params(cfg, generator=None, device="cuda"):
    return family_module(cfg).init_params(cfg, generator, device)


def param_specs(cfg, dist):
    return family_module(cfg).param_specs(cfg, dist)


def forward(cfg, params, batch, dist=NO_DIST):
    return family_module(cfg).forward(cfg, params, batch, dist)


def loss_fn(cfg, params, batch, dist=NO_DIST):
    return family_module(cfg).loss_fn(cfg, params, batch, dist)


def prefill(cfg, params, batch, max_len, dist=NO_DIST):
    return family_module(cfg).prefill(cfg, params, batch, max_len, dist)


def decode_step(cfg, params, tokens, cache, dist=NO_DIST):
    return family_module(cfg).decode_step(cfg, params, tokens, cache, dist)


def init_cache(cfg, batch, max_len, device="cuda"):
    return family_module(cfg).init_cache(cfg, batch, max_len, device=device)


__all__ = [
    "Dist", "LMConfig", "QUEUED_FAMILIES", "SHAPES",
    "ShapeCfg", "family_module", "init_params", "param_specs", "forward",
    "loss_fn", "prefill", "decode_step", "init_cache", "encdec", "moe",
    "ssm", "transformer", "xlstm",
]
