"""The numbers a run compares with the plain reference, each against its
limit: a number passes when it is finite and at most its limit."""
from __future__ import annotations

import math

import torch


def passes(value: float, limit: float) -> bool:
    return math.isfinite(value) and value <= limit


def rel_max_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |got - ref| over the largest |ref|, in float64."""
    ref = ref.double()
    scale = float(ref.abs().max())
    return float((got.double() - ref).abs().max()) / max(scale, 1e-300)


def norm(t: torch.Tensor) -> float:
    return float(t.double().norm())


def leaf_gaps(got: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's
    (not the norm of their difference), over the larger of that leaf's
    reference norm and the median leaf's; ``keep`` limits the leaves."""
    names = [k for k in ref if keep is None or k in keep]
    if not names:
        return 0.0
    ref_n = {k: norm(ref[k]) for k in names}
    med = sorted(ref_n.values())[len(names) // 2]
    return max(abs(norm(got[k]) - ref_n[k]) / max(ref_n[k], med, 1e-300)
               for k in names)


def leaves(params) -> dict:
    """A parameter list's leaves by name, ``p<layer>.<key>``."""
    return {f"p{i}.{k}": v for i, p in enumerate(params) for k, v in p.items()}
