"""Collective bytes and the three-term roofline, the counterpart of
``repro.launch.hlo`` in an NVIDIA H100's terms.

The reference scrapes the collectives out of XLA's optimized HLO text
(``parse_collectives``, ``_shape_bytes``); the port has no HLO.  Its
dry-run records each collective the process group is asked for (kind,
buffer bytes, group size: :class:`Collective`) and counts FLOPs and bytes
on each device's local shards (``launch/dryrun.py``).  The wire-bytes model
is the reference's (ring algorithms, group size N):

  all-reduce        2 (N-1)/N x buffer
  all-gather        (N-1)/N x output
  reduce-scatter    (N-1) x output
  all-to-all        (N-1)/N x buffer
  collective-permute  1 x buffer

Hardware constants: NVIDIA H100 SXM5 80GB, the data sheet's dense rates at
the 700 W power limit: 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of
HBM3, and NVLink 4 at 900 GB/s per GPU in both directions together, 450
GB/s each way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

PEAK_FLOPS = 989e12            # bf16 dense, H100 SXM5 data sheet, 700 W
HBM_BW = 3.35e12               # HBM3, bytes/s
LINK_BW = 450e9                # NVLink 4, bytes/s each way
HARDWARE = ("NVIDIA H100 SXM5 80GB data sheet, 700 W: 989 TFLOP/s bf16 "
            "dense, 3.35 TB/s HBM3, NVLink 450 GB/s each way")


@dataclasses.dataclass
class Collective:
    kind: str
    bytes_buffer: int            # per-device buffer (output for gathers)
    group_size: int
    wire_bytes: float            # per-device bytes on the wire (ring model)


def _wire_bytes(kind: str, buf: int, n: int) -> float:
    if kind == "collective-permute":
        return float(buf)        # point-to-point: group size is irrelevant
    if n <= 1:
        return 0.0
    f = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * f * buf
    if kind == "all-gather":
        return f * buf                     # buf = gathered output
    if kind == "reduce-scatter":
        return (n - 1) * buf               # buf = scattered output
    if kind == "all-to-all":
        return f * buf
    return float(buf)


def collective(kind: str, buf: int, n: int) -> Collective:
    return Collective(kind, int(buf), int(n), _wire_bytes(kind, buf, n))


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0
    collectives: Optional[Dict[str, float]] = None

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline(flops: float, hbm_bytes: float,
             colls: Iterable[Collective], mesh_devices: int,
             model_flops: float = 0.0) -> Roofline:
    """The three terms of one device's step from its counts: FLOPs over the
    bf16 peak, HBM bytes over the HBM rate, wire bytes over one NVLink
    direction; the largest names the bottleneck.  ``useful_ratio`` is
    ``model_flops`` over the FLOPs of all devices together."""
    per_kind: Dict[str, float] = {}
    for c in colls:
        per_kind[c.kind] = per_kind.get(c.kind, 0.0) + c.wire_bytes
    cbytes = sum(per_kind.values())
    terms = {
        "compute": flops / PEAK_FLOPS,
        "memory": hbm_bytes / HBM_BW,
        "collective": cbytes / LINK_BW,
    }
    bott = max(terms, key=terms.get)
    useful = (model_flops / (flops * mesh_devices)
              if flops > 0 and model_flops else 0.0)
    return Roofline(
        flops_per_device=float(flops), hbm_bytes_per_device=float(hbm_bytes),
        collective_bytes_per_device=cbytes,
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"], bottleneck=bott,
        model_flops=model_flops, useful_ratio=useful,
        collectives=per_kind,
    )


def model_flops_for(cfg, shape) -> float:
    """6*N*D accounting (N = params, active params for MoE; D = tokens)."""
    n = cfg.params_count()
    if cfg.n_experts:
        per_exp = 3 * cfg.d_model * cfg.expert_d_ff
        moe_layers = cfg.n_layers - cfg.first_dense_layers
        routed_total = moe_layers * cfg.n_experts * per_exp
        routed_active = moe_layers * cfg.top_k * per_exp
        n = n - routed_total + routed_active
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch                    # decode: one token each
    return 2.0 * n * tokens
