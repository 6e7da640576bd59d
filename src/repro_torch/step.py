"""A step compiled once and replayed: the port's counterpart of a function
under ``jax.jit``.  The serving engine's steps (``serve/engine.py``), the
BSP forward and the distributed train step (``gnn/distributed.py``,
``gnn/training.py``) and the ego forward (``gnn/serving.py``) are such
steps.

A :class:`Step` holds a function and the static input buffers it reads
(:func:`static_inputs`).  The caller writes each call's inputs into those
buffers (:meth:`Step.write`) and calls the step.  On the card, with a
graph pool, the first call runs the function eagerly (its results are
used: the warm-up) and then captures it into a
``torch.cuda.CUDAGraph``; every later call replays the graph, whose
outputs are static tensors in the pool, rewritten by each replay.
Without a pool (the CPU, or a caller that asks for eager running) every
call runs the function eagerly on the same buffers.

Capture records kernels and executes none, so a function that updates
state in place (a decode step's cache) advances it once per call.  A
capture that fails raises; nothing falls back to eager running.

The port's launch counters are Python integers that the kernels' wrappers
bump when they launch, which a replay does not run.  The step records each
counter's change during the capture, takes the capture's own change back
out (the capture launched nothing), and adds the change on every replay,
so the counters count what ran.

Steps that share a pool may reuse each other's memory: they must not run
concurrently, and one step's outputs are read before another step of the
pool is replayed.
"""
from __future__ import annotations

import gc
import time
import weakref
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gnn_aggregate import spmm
from repro_torch.models.moe import grouped_gemm

# The launch counters of the kernels a step runs: (holder, attribute), an
# int or a dict of ints.  Looked up at each use: callers replace them with
# fresh objects.
COUNTERS = (
    (flash_attention, "launches"), (flash_attention, "launches_by_path"),
    (flash_attention, "stats_launches"),
    (flash_attention, "backward_launches"),
    (flash_attention, "backward_launches_by_path"),
    (grouped_gemm, "launches_by_route"),
    (grouped_gemm, "backward_launches_by_route"),
    (spmm, "launches"), (spmm, "launches_by_dir"))


def resolve_graphs(graphs: Optional[bool], device: torch.device,
                   what: str) -> bool:
    """Whether ``what``'s steps are captured: ``graphs`` None means on a
    CUDA device; True off one raises."""
    if graphs is None:
        return device.type == "cuda"
    if graphs and device.type != "cuda":
        raise ValueError(f"{what}(graphs=True) needs a CUDA device; it runs "
                         f"on {device}")
    return bool(graphs)


def spec(x) -> tuple:
    """A tensor's or an array's shape and dtype (as a torch dtype)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return tuple(t.shape), t.dtype


def static_inputs(device, **tensors) -> Dict[str, torch.Tensor]:
    """Zeroed buffers of the given tensors' (or arrays') shapes and dtypes
    on ``device``: a step's static inputs."""
    out = {}
    for name, x in tensors.items():
        shape, dtype = spec(x)
        out[name] = torch.zeros(shape, dtype=dtype, device=device)
    return out


def _read_counts():
    return [dict(v) if isinstance(v, dict) else v
            for v in (getattr(obj, attr) for obj, attr in COUNTERS)]


def _counts_since(before):
    return [{k: now[k] - was.get(k, 0) for k in now}
            if isinstance(now, dict) else now - was
            for now, was in zip(_read_counts(), before)]


def _add_counts(delta, sign: int) -> None:
    for (obj, attr), d in zip(COUNTERS, delta):
        if isinstance(d, dict):
            counts = getattr(obj, attr)
            for k, n in d.items():
                counts[k] = counts.get(k, 0) + sign * n
        else:
            setattr(obj, attr, getattr(obj, attr) + sign * d)


class Step:
    """``fn(**inputs)`` over static input buffers, run eagerly or replayed
    from a CUDA graph (module docstring).  ``pool`` (a
    ``torch.cuda.graph_pool_handle()``) turns capture on; ``name`` labels
    a failed capture.  After each call ``out`` holds the call's outputs;
    ``capture_s`` and ``pool_bytes`` the capture's host seconds and the
    device memory the pool grew by for it."""

    def __init__(self, name: str, fn: Callable,
                 inputs: Dict[str, torch.Tensor], pool=None):
        self.name, self.fn, self.inputs, self.pool = name, fn, inputs, pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.capture_s = 0.0
        self.pool_bytes = 0
        self._static = self._delta = None
        self._written: Dict[str, tuple] = {}

    def write(self, name: str, src) -> None:
        """Copy ``src`` (a tensor or an array) into the input buffer
        ``name``.  No copy is made when ``src`` is the buffer itself, or
        the tensor last written there and not changed in place since (its
        version counter has not moved)."""
        buf = self.inputs[name]
        if src is buf:
            return
        if isinstance(src, torch.Tensor):
            last = self._written.get(name)
            if (last is not None and last[0]() is src
                    and last[1] == src._version):
                return
            buf.copy_(src)
            self._written[name] = (weakref.ref(src), src._version)
        else:
            buf.copy_(torch.from_numpy(np.ascontiguousarray(src)))
            self._written.pop(name, None)

    def __call__(self):
        if self.graph is not None:
            self.graph.replay()
            _add_counts(self._delta, +1)
            self.out = self._static
            return self.out
        self.out = self.fn(**self.inputs)
        if self.pool is not None:
            self._capture()
        return self.out

    def _capture(self) -> None:
        before = _read_counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # Destroying a graph during another's capture invalidates the
        # capture, and an engine's graphs live in a reference cycle (its
        # steps hold its methods): let no collection run until the capture
        # ends.  Only the collector frees such garbage, so no collection
        # is needed before the capture either; a full one costs time in
        # proportion to the process's live objects, at every capture.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                reserved = torch.cuda.memory_reserved()
                static = self.fn(**self.inputs)
        except Exception as err:
            raise RuntimeError(f"{self.name}: CUDA graph capture failed "
                               f"({type(err).__name__}: {err})") from err
        finally:
            if collecting:
                gc.enable()
            delta = _counts_since(before)
            _add_counts(delta, -1)
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.capture_s = time.perf_counter() - t0
        self.graph, self._static, self._delta = graph, static, delta
