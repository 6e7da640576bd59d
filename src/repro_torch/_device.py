"""Device selection shared by the port's entry points.

Every entry point takes ``device=`` and defaults to the card.  A request for
CUDA on a machine without one raises: the port never carries on quietly on
the CPU.  Callers that want the CPU (the tests) pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent.  "meta" (shapes and dtypes, no storage) is taken for the
    dry-run's abstract inputs.  On CUDA, float32 matmuls and convolutions are pinned to full
    fp32 (no TF32), the precision the JAX reference computes in."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA device requested but torch.cuda is not "
                "available; pass device='cpu' to run on the host")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
