"""Model zoo: family dispatch.

The dense, MoE and VLM families run through ``transformer``, the hybrid
(Mamba2 + shared attention) family through ``ssm``, the xLSTM family
through ``xlstm`` and the enc-dec family through ``encdec``: every family
of the reference.  A family the reference does not have raises
``NotImplementedError`` (``common.check_family``).

``forward``, ``loss_fn`` and ``prefill`` take the reference's ``dist``
(default: no mesh).  Under a mesh the transformer families run; the
hybrid, xLSTM and enc-dec families have their ``param_specs`` and raise
``NotImplementedError`` under a mesh until ROADMAP.md's slice 16.
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

# Families whose forward, loss and prefill run under a mesh.
MESH_FAMILIES = ("dense", "moe", "vlm")


def family_module(cfg: LMConfig):
    check_family(cfg.name, cfg.family)
    return _FAMILY[cfg.family]


def _meshed(cfg: LMConfig, dist: Dist):
    """The family's module, after refusing a mesh it cannot run under."""
    mod = family_module(cfg)
    if dist.mesh is not None and cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family under a mesh is "
            f"ROADMAP.md slice 16")
    return mod


def init_params(cfg, generator=None, device="cuda"):
    return family_module(cfg).init_params(cfg, generator, device)


def param_specs(cfg, dist):
    return family_module(cfg).param_specs(cfg, dist)


def forward(cfg, params, batch, dist=NO_DIST):
    if dist.mesh is None:
        return family_module(cfg).forward(cfg, params, batch)
    return _meshed(cfg, dist).forward(cfg, params, batch, dist)


def loss_fn(cfg, params, batch, dist=NO_DIST):
    if dist.mesh is None:
        return family_module(cfg).loss_fn(cfg, params, batch)
    return _meshed(cfg, dist).loss_fn(cfg, params, batch, dist)


def prefill(cfg, params, batch, max_len, dist=NO_DIST):
    if dist.mesh is None:
        return family_module(cfg).prefill(cfg, params, batch, max_len)
    return _meshed(cfg, dist).prefill(cfg, params, batch, max_len, dist)


def decode_step(cfg, params, tokens, cache):
    return family_module(cfg).decode_step(cfg, params, tokens, cache)


def init_cache(cfg, batch, max_len, device="cuda"):
    return family_module(cfg).init_cache(cfg, batch, max_len, device=device)


__all__ = [
    "Dist", "LMConfig", "MESH_FAMILIES", "QUEUED_FAMILIES", "SHAPES",
    "ShapeCfg", "family_module", "init_params", "param_specs", "forward",
    "loss_fn", "prefill", "decode_step", "init_cache", "encdec", "moe",
    "ssm", "transformer", "xlstm",
]
