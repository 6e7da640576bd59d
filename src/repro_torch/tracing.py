"""The port's tracing: host spans, device marks and counters.

Tracing is off until :func:`enable` and off again after :func:`disable`.
Off, a span is one shared no-op context and a mark returns at once, so the
program launches exactly the kernels it launches untraced.

Host spans.  ``with span(name):`` records (name, start ns, end ns, parent
span, call id) on the host's ``time.perf_counter_ns`` clock; :func:`call`
opens a span with a new call id, which the spans inside it inherit.
While a ``torch.profiler`` is active each span also opens
``torch.profiler.record_function(name)``, so it lies in the profiler's
trace on the clock of the device events.

Device marks.  ``mark(phase, device)`` closes the phase open on ``device``
and opens ``phase`` (one of :data:`PHASES`): on a CUDA device it enqueues a
one-thread kernel (``kernels/csrc/mark.cu``) that takes the next slot of a
device ring by ``atomicAdd`` and writes (phase id, ``%globaltimer`` ns)
there; on the CPU it writes (phase id, ``perf_counter_ns``) into a host
ring of the same format.  A mark runs where a step's body runs, eagerly or
in a capture: captured into a CUDA graph it writes fresh slots on every
replay, and nothing is synchronised until :func:`read` copies the ring.
Past the ring's :data:`CAPACITY` slots a mark writes nothing and counts a
drop.  A device's ring is made at its first mark, which must fall outside
a capture (a step's first call runs eagerly before it captures), and lives
as long as the process: the marked graphs hold its address.

A call of the BSP forward or of the distributed train step runs in the
phases ``write`` (from the call-begin mark: the input copies), ``launch``
(from the mark after the copies to the graph's first node: its entry),
``step`` (from the step's begin mark: its index tables), per layer
``exchange``, ``aggregate`` (GAT: ``attention``, then ``messages``) and
``dense``, for a train step then ``loss``, ``backward`` and ``sgd``, then
``exit`` (from the step's end mark, the graph's last node, to the mark
after it: the graph's exit) and ``clone`` (the outputs' copies); the
call-end mark opens ``idle``, which lasts until the next call's begin
mark.  Run eagerly a call has no graph, and no ``launch`` or ``exit``.

Counters.  The kernels' wrappers and the exchange keep their counters as
attributes of an object (an int, or a dict of ints), bumped when their
code runs; :func:`register` lists them, looked up at each use, since
callers may replace them with fresh objects.  A captured step
(:class:`repro_torch.step.Step`) takes each counter's change during its
capture from :func:`counters` and adds it on every replay.
"""
from __future__ import annotations

import itertools
import time
from typing import Optional

import numpy as np
import torch
from torch.autograd import profiler as _profiler

PHASES = ("write", "launch", "step", "exchange", "aggregate", "attention",
          "messages", "dense", "loss", "backward", "sgd", "exit", "clone",
          "idle")
_PHASE_ID = {p: i for i, p in enumerate(PHASES)}
CAPACITY = 1 << 16          # marks a ring holds between clears

_on = False
_spans: list = []           # (id, name, start ns, end ns, parent id, call id)
_open: list = []            # the spans entered and not yet left
_span_ids = itertools.count()
_call_ids = itertools.count(1)
_rings: dict = {}           # device -> _Ring
_counters: list = []        # (name, holder, attribute)


def enable() -> None:
    """Turn tracing on."""
    global _on
    _on = True


def disable() -> None:
    """Turn tracing off; what was recorded stays readable."""
    global _on
    _on = False


def on() -> bool:
    """Whether tracing is on."""
    return _on


# ------------------------------------------------------------- host spans
class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "new_call", "id", "parent", "call", "start",
                 "profiled")

    def __init__(self, name: str, new_call: bool):
        self.name, self.new_call = name, new_call

    def __enter__(self):
        outer = _open[-1] if _open else None
        self.id = next(_span_ids)
        self.parent = outer.id if outer is not None else -1
        self.call = (next(_call_ids) if self.new_call
                     else outer.call if outer is not None else 0)
        self.profiled = None
        if _profiler._is_profiler_enabled:
            self.profiled = torch.profiler.record_function(self.name)
            self.profiled.__enter__()
        _open.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _open.pop()
        if self.profiled is not None:
            self.profiled.__exit__(*exc)
        _spans.append((self.id, self.name, self.start, end, self.parent,
                       self.call))
        return False


def span(name: str):
    """A context that records a host span ``name`` while tracing is on."""
    if not _on:
        return _NOOP
    return _Span(name, False)


class _Call:
    __slots__ = ("span", "device")

    def __init__(self, name: str, device):
        self.span, self.device = _Span(name, True), device

    def __enter__(self):
        self.span.__enter__()
        mark("write", self.device)
        return self

    def __exit__(self, *exc):
        mark("idle", self.device)
        return self.span.__exit__(*exc)


def call(name: str, device):
    """A program call while tracing is on: the span ``name`` with a new
    call id, the call-begin mark (``write``) on entering and the call-end
    mark (``idle``) on leaving."""
    if not _on:
        return _NOOP
    return _Call(name, device)


# ----------------------------------------------------------- device marks
def _key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class _Ring:
    """:data:`CAPACITY` slots of (phase id, ns) and the count of marks
    made since the last clear, on the device or on the host."""

    def __init__(self, device: torch.device):
        self.device, self.capacity = device, CAPACITY
        if device.type == "cuda":
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"tracing: the first mark on {device} falls inside a "
                    "CUDA graph capture; its ring must exist before")
            self.slots = torch.zeros((self.capacity, 2), dtype=torch.int64,
                                     device=device)
            self.head = torch.zeros(1, dtype=torch.int64, device=device)
        else:
            self.slots = np.zeros((self.capacity, 2), np.int64)
            self.head = 0

    def mark(self, phase: int) -> None:
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            lib = _build.load_library()
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = lib.repro_torch_mark(self.slots.data_ptr(),
                                       self.head.data_ptr(), self.capacity,
                                       phase, stream)
            _build.check(lib, err, "mark launch")
            return
        slot, self.head = self.head, self.head + 1
        if slot < self.capacity:
            self.slots[slot] = (phase, time.perf_counter_ns())

    def clear(self) -> None:
        if self.device.type == "cuda":
            self.head.zero_()
        else:
            self.head = 0

    def read(self) -> tuple:
        """(the marks in the order they were made, the drops)."""
        head = (int(self.head.item()) if self.device.type == "cuda"
                else self.head)
        slots = self.slots[:min(head, self.capacity)]
        if self.device.type == "cuda":
            slots = slots.cpu().numpy()
        return ([(PHASES[int(p)], int(t)) for p, t in slots],
                max(head - self.capacity, 0))


def mark(phase: str, device) -> None:
    """Close the phase open on ``device`` and open ``phase``, while
    tracing is on."""
    if not _on:
        return
    key = _key(device)
    ring = _rings.get(key)
    if ring is None:
        ring = _rings[key] = _Ring(key)
    ring.mark(_PHASE_ID[phase])


# --------------------------------------------------------------- counters
def register(holder, attr: str, name: Optional[str] = None) -> None:
    """List ``holder.attr`` (an int, or a dict of ints) as a counter, under
    ``name`` (default ``"<holder.__name__>.<attr>"``)."""
    name = name or f"{holder.__name__}.{attr}"
    if all(n != name for n, _, _ in _counters):
        _counters.append((name, holder, attr))


def counters() -> dict:
    """Every registered counter's value by name (dicts copied)."""
    out = {}
    for name, holder, attr in _counters:
        v = getattr(holder, attr)
        out[name] = dict(v) if isinstance(v, dict) else v
    return out


def since(before: dict) -> dict:
    """Each counter's change since ``before`` (a :func:`counters`)."""
    out = {}
    for name, now in counters().items():
        was = before.get(name)
        if isinstance(now, dict):
            was = was or {}
            out[name] = {k: n - was.get(k, 0) for k, n in now.items()}
        else:
            out[name] = now - (was or 0)
    return out


def add(delta: dict, sign: int = 1) -> None:
    """Add ``sign`` times ``delta`` (a :func:`since`) to the counters."""
    for name, holder, attr in _counters:
        d = delta.get(name)
        if not d:
            continue
        if isinstance(d, dict):
            counts = getattr(holder, attr)
            for k, n in d.items():
                counts[k] = counts.get(k, 0) + sign * n
        else:
            setattr(holder, attr, getattr(holder, attr) + sign * d)


# ---------------------------------------------------------------- reading
def clear() -> None:
    """Forget the spans and empty every ring."""
    _spans.clear()
    for ring in _rings.values():
        ring.clear()


def read() -> dict:
    """What was recorded since the last :func:`clear`: ``spans`` (dicts of
    ``id``, ``name``, ``start``, ``end`` in ns, ``parent`` (-1 for none)
    and ``call``, in the order they ended), ``marks`` by device (lists of
    (phase, ns) in the order they ran), ``drops`` by device, and
    ``counters``.  Copies each device ring to the host once."""
    marks, drops = {}, {}
    for key, ring in _rings.items():
        marks[str(key)], drops[str(key)] = ring.read()
    spans = [dict(zip(("id", "name", "start", "end", "parent", "call"), s))
             for s in _spans]
    return {"spans": spans, "marks": marks, "drops": drops,
            "counters": counters()}
