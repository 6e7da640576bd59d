"""A step compiled once and replayed: the port's counterpart of a function
under ``jax.jit``.  The serving engine's steps (``serve/engine.py``), the
BSP forward, the distributed and the whole-graph train steps and
``predict`` (``gnn/distributed.py``, ``gnn/training.py``,
``gnn/models.py``), the ego forward (``gnn/serving.py``) and the LM train
step (``train/step.py``) are such steps, with or without a mesh.

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

The port's counters (:func:`repro_torch.tracing.register`: the kernels'
launch counters, the exchange's rows) are Python integers that the code
bumps when it runs, which a replay does not run.  The step records each
counter's change during the capture, takes the capture's own change back
out (the capture launched nothing), and adds the change on every replay,
so the counters count what ran.

While tracing is on (:mod:`repro_torch.tracing`) each replay is the host
span ``step.replay`` and the input copies of :func:`step_for` the span
``step.write``.  A step marks nothing on the device itself: the callers
whose bodies mark their phases key their steps by whether tracing is on
(:func:`repro_torch.gnn.distributed.call_captured`).

Steps that share a pool may reuse each other's memory: they must not run
concurrently, and one step's outputs are read before another step of the
pool is replayed.

:func:`cached_step` keeps one step per input signature, as the jit keeps
one trace per signature.  State that a step updates in place (a train
step's parameters and moments) can be the caller's own tensors rather than
copies: the step adopts them as its buffers, so while the caller passes
back what it was given, nothing is copied.

Under a mesh the buffers, the adopted state and the outputs are DTensors.
A DTensor's signature is its global shape, dtype, mesh and placements; its
buffer is a DTensor over a zeroed local shard of its local shape, so a
replay reads the shard it was captured over.  DTensor's dispatch and
sharding propagation run once, in the capture, and never at a replay:
nothing the function does may depend on them running again.
"""
from __future__ import annotations

import gc
import time
import weakref
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import tracing


def capture_refusal(device: torch.device, mesh=None) -> Optional[str]:
    """Why steps on ``device``, or under ``mesh`` (a ``DeviceMesh``), cannot
    be captured into CUDA graphs; None where they can."""
    if mesh is not None:
        if mesh.device_type == "cuda":
            return None
        import torch.distributed as tdist
        return (f"needs a CUDA device; it runs under a mesh on the "
                f"{mesh.device_type.upper()} "
                f"({tdist.get_backend(mesh.get_group(0))})")
    if device.type == "cuda":
        return None
    return f"needs a CUDA device; it runs on {device}"


def resolve_graphs(graphs: Optional[bool], device: torch.device,
                   what: str, mesh=None) -> bool:
    """Whether ``what``'s steps are captured: ``graphs`` None means on a
    CUDA device (under ``mesh``, a mesh of CUDA devices); True elsewhere
    raises (:func:`capture_refusal`)."""
    why = capture_refusal(device, mesh)
    if graphs is None:
        return why is None
    if graphs and why:
        raise ValueError(f"{what}(graphs=True) {why}")
    return bool(graphs)


def _is_dtensor(x) -> bool:
    return hasattr(x, "placements")


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (its data, not a copy), or ``t``."""
    if not _is_dtensor(t):
        return t
    with torch.no_grad():
        return t.to_local()


def spec(x) -> tuple:
    """A tensor's or an array's shape and dtype (as a torch dtype); a
    DTensor's global shape, dtype, mesh and placements."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    if _is_dtensor(t):
        return tuple(t.shape), t.dtype, t.device_mesh, tuple(t.placements)
    return tuple(t.shape), t.dtype


def static_inputs(device, **tensors) -> Dict[str, torch.Tensor]:
    """Zeroed buffers of the given tensors' (or arrays') shapes and dtypes
    on ``device``: a step's static inputs.  A DTensor's buffer is a DTensor
    laid out as it is, over a zeroed local shard on its shard's device."""
    from torch.distributed.tensor import DTensor
    out = {}
    for name, x in tensors.items():
        shape, dtype, *layout = spec(x)
        if not layout:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        local = _local(x)
        out[name] = DTensor.from_local(
            torch.zeros(local.shape, dtype=dtype, device=local.device),
            *layout, run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())
    return out


def _copy_into(buf: torch.Tensor, src: torch.Tensor) -> None:
    """``src`` written into the buffer ``buf``.  Into a DTensor buffer: a
    DTensor's local shard, redistributed first where its layout differs; a
    whole tensor (the same on every process), this process's part of it."""
    if not _is_dtensor(buf):
        buf.copy_(src)
        return
    from torch.distributed.tensor import distribute_tensor
    mesh, pls = buf.device_mesh, tuple(buf.placements)
    with torch.no_grad():
        if not _is_dtensor(src):
            src = distribute_tensor(src.to(_local(buf).device), mesh, pls,
                                    src_data_rank=None)
        elif src.device_mesh != mesh or tuple(src.placements) != pls:
            src = src.redistribute(mesh, pls)
        _local(buf).copy_(_local(src))


def step_for(steps: dict, key, name: str, fn: Callable, pool, device,
             own=(), **inputs) -> "Step":
    """The :class:`Step` of ``key`` in ``steps`` that runs
    ``fn(**buffers)``, with ``inputs`` written into its buffers
    (:meth:`Step.write`).  It is made at its first use over zeroed buffers
    of ``inputs`` on ``device`` (:func:`static_inputs`), but for the names
    in ``own``, whose buffers are the tensors given (adopted: the step
    updates them in place), and over ``pool`` (None: run eagerly)."""
    step = steps.get(key)
    if step is None:
        bufs = static_inputs(device, **{k: v for k, v in inputs.items()
                                        if k not in own})
        bufs.update((k, inputs[k]) for k in own)
        step = steps[key] = Step(name, fn, bufs, pool)
    with tracing.span("step.write"):
        for k, v in inputs.items():
            step.write(k, v)
    return step


def cached_step(steps: dict, key, name: str, fn: Callable, pool, device,
                own=(), **inputs):
    """Runs :func:`step_for`'s step; returns its outputs, which its next
    call rewrites."""
    return step_for(steps, key, name, fn, pool, device, own, **inputs)()


class Step:
    """``fn(**inputs)`` over static input buffers, run eagerly or replayed
    from a CUDA graph (module docstring).  ``pool`` (a
    ``torch.cuda.graph_pool_handle()``) turns capture on; ``name`` labels
    a failed capture.  After each call ``out`` holds the call's outputs;
    ``capture_s`` and ``pool_bytes`` the capture's host seconds and the
    device memory the pool grew by for it; ``replays`` counts the replays
    and ``per_replay`` holds what each adds to the launch counters, by
    counter ("flash_attention.launches_by_path": its dict or int)."""

    def __init__(self, name: str, fn: Callable,
                 inputs: Dict[str, torch.Tensor], pool=None):
        self.name, self.fn, self.inputs, self.pool = name, fn, inputs, pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.replays = 0
        self.per_replay: Dict[str, object] = {}
        self._static = self._delta = None
        self._written: Dict[str, tuple] = {}

    def write(self, name: str, src) -> None:
        """Copy ``src`` (a tensor or an array) into the input buffer
        ``name`` (:func:`_copy_into`).  No copy is made when ``src`` is the
        buffer itself, or the tensor last written there and not changed in
        place since (its version counter, a DTensor's local shard's, has
        not moved)."""
        buf = self.inputs[name]
        if src is buf:
            return
        if isinstance(src, torch.Tensor):
            last = self._written.get(name)
            version = _local(src)._version
            if (last is not None and last[0]() is src
                    and last[1] == version):
                return
            _copy_into(buf, src)
            self._written[name] = (weakref.ref(src), version)
        else:
            _copy_into(buf, torch.from_numpy(np.ascontiguousarray(src)))
            self._written.pop(name, None)

    def __call__(self):
        if self.graph is not None:
            with tracing.span("step.replay"):
                self.graph.replay()
                tracing.add(self._delta)
            self.replays += 1
            self.out = self._static
            return self.out
        self.out = self.fn(**self.inputs)
        if self.pool is not None:
            self._capture()
        return self.out

    def _capture(self) -> None:
        before = tracing.counters()
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
            delta = tracing.since(before)
            tracing.add(delta, -1)
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.capture_s = time.perf_counter() - t0
        self.graph, self._static, self.per_replay = graph, static, delta
        self._delta = {k: d for k, d in delta.items()
                       if (any(d.values()) if isinstance(d, dict) else d)}
