"""Input and cache specs per (arch family x shape kind), the counterpart of
``repro.launch.sharding`` (its rules, spec for spec):

  * batch dims shard over ('pod','data') when divisible, else replicate;
  * KV caches shard batch normally; the long-context B=1 shape switches to
    SEQUENCE sharding of the cache, and a cache whose KV heads do not
    divide the 'model' axis is split by sequence over 'model';
  * SSM/xLSTM recurrent states shard batch when possible, else heads when
    divisible, else replicate (they are small).

The functions read only the mesh's axis names and sizes
(``mesh.mesh_dim_names``, ``mesh.size(i)``), so any object with those two
stands in for a production mesh.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.models.common import Dist, LMConfig, P, ShapeCfg


def _div(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


def _size(mesh, axis: str) -> int:
    return mesh.size(list(mesh.mesh_dim_names).index(axis))


def _axes_size(mesh, axes: Tuple[str, ...]) -> int:
    s = 1
    for a in axes:
        s *= _size(mesh, a)
    return s


def batch_dim_spec(B: int, dist: Dist):
    """The sharding of a leading batch dim, or None when not divisible."""
    bs = _axes_size(dist.mesh, dist.batch_axes)
    if _div(B, bs):
        return dist.batch
    # Try data axis alone (e.g. B=16 on a 2x16x16 mesh).
    if "data" in dist.mesh.mesh_dim_names and _div(B, _size(dist.mesh,
                                                             "data")):
        return "data"
    return None


def input_sharding_specs(cfg: LMConfig, shape: ShapeCfg, dist: Dist) -> Dict:
    B = shape.global_batch
    b = batch_dim_spec(B, dist)
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": P(b, None)}
        if shape.kind == "train":
            specs["labels"] = P(b, None)
        if cfg.family == "encdec":
            specs["frames"] = P(b, None, None)
        if cfg.family == "vlm":
            specs["patches"] = P(b, None, None)
        return specs
    return {"tokens": P(b, None), "cache": cache_specs(cfg, shape, dist)}


def cache_specs(cfg: LMConfig, shape: ShapeCfg, dist: Dist) -> Dict:
    B = shape.global_batch
    b = batch_dim_spec(B, dist)
    long_ctx = b is None               # B too small -> sequence-shard
    m = dist.model_axis
    names = dist.mesh.mesh_dim_names

    def heads_spec(h):
        if _div(h, _size(dist.mesh, m)):
            return m
        return None

    def kv_seq_spec():
        """S-dim sharding of a KV cache.  When kv-heads don't divide the TP
        axis, split the SEQUENCE over 'model' instead (each shard holds a
        slice of the positions) — otherwise a replicated cache costs TP-way
        memory."""
        axes = []
        if (long_ctx and "data" in names
                and _div(shape.seq_len, _size(dist.mesh, "data"))):
            axes.append("data")
        if heads_spec(cfg.n_kv_heads) is None and \
                _div(shape.seq_len, _size(dist.mesh, m)):
            axes.append(m)
        if not axes:
            return None
        return tuple(axes) if len(axes) > 1 else axes[0]

    if cfg.family in ("dense", "moe", "vlm"):
        kv = P(None, b, kv_seq_spec(), heads_spec(cfg.n_kv_heads), None)
        return {"k": kv, "v": kv, "len": P(None)}
    if cfg.family == "encdec":
        kv = P(None, b, kv_seq_spec(), heads_spec(cfg.n_kv_heads), None)
        xkv = P(None, b, None, heads_spec(cfg.n_kv_heads), None)
        return {"k": kv, "v": kv, "xk": xkv, "xv": xkv,
                "len": P(None), "xlen": P(None)}
    if cfg.family == "hybrid":
        din = cfg.ssm_expand * cfg.d_model
        H = din // cfg.ssm_head_dim
        # States live model-sharded on heads: the in/out projections are
        # TP-sharded on din = H*P.
        specs = {
            "ssm": P(None, b, heads_spec(H), None, None),
            "conv": P(None, b, None, heads_spec(cfg.ssm_expand * cfg.d_model
                                                + 2 * cfg.ssm_state)),
            "len": P(None),
        }
        from repro_torch.models.ssm import num_shared_calls
        if num_shared_calls(cfg):
            kv = P(None, b, kv_seq_spec(), heads_spec(cfg.n_kv_heads), None)
            specs["k"] = kv
            specs["v"] = kv
        return specs
    if cfg.family == "ssm":           # xlstm
        din = (cfg.ssm_expand or 2) * cfg.d_model
        Pm = din // cfg.n_heads                      # mLSTM head width
        Ps = cfg.d_model // cfg.n_heads              # sLSTM head width
        # The matrix memory C (B,H,Pk,Pv) follows the TP sharding of the
        # q/k/v projections (din over 'model'): the value dim is sharded.
        pv = m if _div(Pm, _size(dist.mesh, m)) else None
        ps = m if _div(Ps, _size(dist.mesh, m)) else None
        st = P(None, b, None, ps)
        return {
            "mC": P(None, b, None, None, pv),
            "mn": P(None, b, None, pv), "len": P(None),
            "sh": st, "sc": st, "sn": st, "sm": st,
        }
    raise ValueError(cfg.family)


def decode_cache_present_keys(cfg: LMConfig) -> Tuple[str, ...]:
    if cfg.family in ("dense", "moe", "vlm"):
        return ("k", "v", "len")
    if cfg.family == "encdec":
        return ("k", "v", "xk", "xv", "len", "xlen")
    if cfg.family == "hybrid":
        from repro_torch.models.ssm import num_shared_calls
        base = ("ssm", "conv", "len")
        return base + (("k", "v") if num_shared_calls(cfg) else ())
    if cfg.family == "ssm":
        from repro_torch.models.xlstm import _layer_kinds
        base = ("mC", "mn", "len")
        if "s" in _layer_kinds(cfg):
            base = base + ("sh", "sc", "sn", "sm")
        return base
    raise ValueError(cfg.family)
