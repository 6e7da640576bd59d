"""Windows 3 and 4: the program's own spans, marks and counters
(``repro_torch.tracing``), read under ``--trace 1``.

The harness reads each per-layer metric after the program has been
released and its answers compared (``bench/harness.py``).  The first
reader that needs these windows runs both, once a run (:func:`result`),
over the run's own cell (:func:`_cell`: its generator and its traffic's
parameters) built again on the run's system: the program's entry made
anew, with tracing on, over inputs drawn from :data:`SEED` (only times
are read; no answer is compared).  Its first call captures
the marked graph.  Each window runs as many steps as the traced windows
of ``bench/trace.py``, in the measured window's dispatched-ahead loop:

* window 3, with no profiler: its length on the host clock, the card
  synchronized at both ends; the ring of marks, the spans and the
  counters read after it;
* window 4, the same under ``torch.profiler`` (CPU and CUDA), as the
  active step of a schedule after a warm-up step: each mark kernel's start
  in the trace against its ring value (one offset, and the residual left
  after it), the card's ten longest idle gaps, placed by the ring's
  clock (:func:`on_ring`), named by the innermost program span at their
  middle, and the kernels a step in each phase.

Then tracing is turned off and the program released.  The result,
``program_trace``, goes to standard error as one line, ``bench:
program_trace {...}``.  A program without ``repro_torch.tracing`` gives
None, and every reader that needs it then returns None."""
from __future__ import annotations

import bisect
import copy
import gc
import json
import sys
import time
from types import SimpleNamespace

from bench import harness, loop, trace

SEED = 1_000_003
MARK = "mark_kernel"
IDLE = "idle"
WINDOW = "bench.window"     # the span bench.trace.gaps reads
AGGREGATE = ("aggregate", "attention", "messages")
# Cross-check: a phase's ring time within this share of its trace time,
# or within ABS_S where the phase is shorter than SHORT_S.
REL, ABS_S, SHORT_S = 0.10, 5e-6, 50e-6


def result(ctx):
    """``program_trace`` of the run, measured at the first call."""
    if not hasattr(ctx, "program_trace"):
        ctx.program_trace = measure(ctx)
        if ctx.program_trace is not None:
            print("bench: program_trace " + json.dumps(ctx.program_trace),
                  file=sys.stderr, flush=True)
    return ctx.program_trace


def phase_ms(ctx, phases) -> float:
    """Device ms a step in ``phases`` (window 3); None without them."""
    got = result(ctx)
    if got is None:
        return None
    hit = [got["phase_ms"][p] for p in phases if p in got["phase_ms"]]
    return sum(hit) if hit else None


def _cell() -> dict:
    """The run's cell (:func:`bench.harness.cell`), as the harness's
    :func:`~bench.harness.main` holds it while it reads the metrics: the
    harness hands a reader no cell name."""
    frame = sys._getframe(1)
    while frame is not None:
        if frame.f_code is harness.main.__code__:
            return frame.f_locals["wl"]
        frame = frame.f_back
    raise SystemExit("bench: windows 3 and 4 run inside bench.harness.main")


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(ctx):
    """Windows 3 and 4 over the cell's traffic rebuilt with tracing on."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    w, dev = ctx.window, ctx.device
    if not w["steps"]:
        return None
    lo, hi = harness.TRACE_STEPS
    steps = int(min(max(harness.TRACE_SECONDS * w["steps"] / w["seconds"],
                        lo), hi))
    system = copy.copy(ctx.system)
    system.timings = dict(system.timings)
    system.release()
    tracing.enable()
    traffic = None
    try:
        wl = _cell()
        traffic = harness.generator(wl["generator"]).Traffic(
            system, SEED, wl["params"])
        tracing.clear()
        before = tracing.counters()
        _sync(dev)
        t0 = time.perf_counter()
        k = loop.run_steps(traffic.call, steps, harness.DEPTH, dev)
        seconds = time.perf_counter() - t0
        three = tracing.read()
        moved = tracing.since(before).get("exchange.rows")
        events, four = _window4(traffic.call, steps, dev, k, tracing)
    finally:
        tracing.disable()
        tracing.clear()
        if traffic is not None:
            traffic.release()
        system.release()
        del traffic, system
        gc.collect()
        if dev.type == "cuda":
            import torch
            torch.cuda.empty_cache()
    return reduce(three, four, events, steps, seconds,
                  w["seconds"] / w["steps"], moved, dev.type == "cuda")


def _window4(call, steps: int, device, start: int, tracing) -> tuple:
    """Window 4: (the active step's profiler events, what tracing
    recorded in it)."""
    from torch.profiler import (
        ProfilerActivity, profile, record_function, schedule)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    got = []
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: got.append(p.events())) as prof:
        k = loop.run_steps(call, 2, harness.DEPTH, device, start)
        tracing.clear()
        _sync(device)
        prof.step()
        with record_function(WINDOW):
            loop.run_steps(call, steps, harness.DEPTH, device, k)
        prof.step()
    return (got[0] if got else []), tracing.read()


# ---------------------------------------------------------------- reading
def intervals(marks) -> list:
    """(phase, start ns, end ns) from each mark to the next."""
    return [(p, t, marks[i + 1][1]) for i, (p, t) in enumerate(marks[:-1])]


def split(marks, steps: int) -> dict:
    """From one device's marks in order: each phase's ms a step (the idle
    phase left out), the idle share of the calls' span (first call-begin
    mark to last call-end mark) between a call's end and the next call's
    begin, and how much of each call's and each graph's span its phases
    cover."""
    spans = intervals(marks)
    total = {}
    for p, s, t in spans:
        total[p] = total.get(p, 0) + (t - s)
    phase = {p: ns / steps * 1e-6 for p, ns in total.items() if p != IDLE}
    begins = [t for p, t in marks if p == "write"]
    ends = [t for p, t in marks if p == IDLE]
    gap = sum(t - s for p, s, t in spans if p == IDLE and s >= begins[0]
              and t <= ends[-1]) if begins and ends else 0
    span = ends[-1] - begins[0] if begins and ends else 0
    return {"phase_ms": phase,
            "gap_share": 100.0 * gap / span if span > 0 else None,
            "coverage": _coverage(spans)}


def _coverage(spans) -> dict:
    """Over every call (write to idle) and every graph (step to exit, or
    to clone where the call ran eagerly), the time in its phases over its
    marks' span."""
    out = {}
    for name, first, last in (("call", "write", (IDLE,)),
                              ("graph", "step", ("exit", "clone"))):
        inside = span = 0
        start = None
        for p, s, t in spans:
            if p == first:
                start, part = s, 0
            if start is None:
                continue
            if p in last:
                inside, span = inside + part, span + (s - start)
                start = None
            else:
                part += t - s
        out[name] = inside / span if span > 0 else None
    return out


def launch_ms(spans, steps: int) -> float:
    """Host ms a call inside ``step.replay``."""
    ns = sum(s["end"] - s["start"] for s in spans
             if s["name"] == "step.replay")
    return ns / steps * 1e-6


def clock(marks, starts_us) -> dict:
    """The offset that maps ring times (ns) onto the trace's mark kernel
    starts (µs), paired in order: the median difference, and the largest
    residual left after it, each pair's times taken from the first pair's
    so that no float loses the nanoseconds of an epoch."""
    ring0, trace0 = marks[0][1], starts_us[0]
    diffs = [a - trace0 - (t - ring0) * 1e-3
             for a, (_, t) in zip(starts_us, marks)]
    mid = sorted(diffs)[len(diffs) // 2]
    return {"pairs": len(marks), "offset_us": trace0 - ring0 * 1e-3 + mid,
            "residual_us": max(abs(d - mid) for d in diffs)}


def in_trace(marks, device_ops, starts_us, steps: int) -> dict:
    """Window 4 in the trace's clock: each phase's span ms a step (its
    mark kernel to the next), the ms a step of the kernels that start in
    it (its own mark kernel included), and its kernels a step (mark
    kernels not counted), with the marks paired as :func:`clock` pairs
    them."""
    n = len(marks)
    names = [p for p, _ in marks]
    edges = starts_us
    out = {}
    for i in range(n - 1):
        row = out.setdefault(names[i], [0.0, 0.0, 0])
        row[0] += edges[i + 1] - edges[i]
    for s, t, name in device_ops:
        i = bisect.bisect_right(edges, s) - 1
        if 0 <= i < n - 1:
            row = out[names[i]]
            row[1] += t - s
            row[2] += MARK not in name
    return {p: {"span_ms": r[0] / steps * 1e-3,
                "kernel_ms": r[1] / steps * 1e-3, "kernels": r[2] / steps}
            for p, r in out.items() if p != IDLE}


def cross_check(ring_ms: dict, traced: dict) -> dict:
    """Each phase's ring ms a step against the time of its kernels in the
    trace: within :data:`REL`, or within :data:`ABS_S` for a phase under
    :data:`SHORT_S`."""
    out = {}
    for p, ms in ring_ms.items():
        if p not in traced:
            continue
        want = traced[p]["kernel_ms"]
        gap = abs(ms - want) * 1e-3
        out[p] = (gap <= ABS_S if want * 1e-3 < SHORT_S
                  else gap <= REL * want * 1e-3)
    return out


def on_ring(events, marks, starts_us, head: int = 100) -> list:
    """``events`` with the card's operations moved onto the ring's clock,
    the host's spans left as they are.  An operation between two mark
    kernels keeps its share of their interval in the trace, and the
    ring's times go onto the trace's clock by the median offset of the
    first ``head`` pairs.  The profiler's device times agree with the
    ring there, but after some 20,000 device records they run at another
    rate than the host's clock, while ``%globaltimer`` keeps to it; left
    as they are, a long window's late gaps would be named by host spans
    milliseconds away."""
    import numpy as np
    from torch.autograd import DeviceType
    trace_us = np.asarray(starts_us, dtype=np.float64)
    ring_us = (np.array([t for _, t in marks], dtype=np.int64)
               - marks[0][1]) * 1e-3
    shift = float(np.median((trace_us - trace_us[0] - ring_us)[:head]))
    mapped = trace_us[0] + shift + ring_us

    def move(t):
        if t < trace_us[0]:
            return t + mapped[0] - trace_us[0]
        if t > trace_us[-1]:
            return t + mapped[-1] - trace_us[-1]
        return float(np.interp(t, trace_us, mapped))

    out = []
    for e in events:
        if e.device_type == DeviceType.CPU:
            out.append(e)
            continue
        out.append(SimpleNamespace(
            name=e.name, device_type=e.device_type, is_async=False,
            is_user_annotation=getattr(e, "is_user_annotation", False),
            time_range=SimpleNamespace(start=move(e.time_range.start),
                                       end=move(e.time_range.end))))
    return out


def named_gaps(events, span_names) -> list:
    """The card's ten longest idle gaps in the window, longest first, each
    named by the innermost program span at its middle, or as outside the
    program (:func:`bench.trace.gaps` over the window's span, the card's
    operations and the program's spans alone)."""
    from torch.autograd import DeviceType
    keep = [e for e in events if e.device_type != DeviceType.CPU
            or e.name in span_names or e.name == WINDOW]
    return [[label.replace(f"{WINDOW} > ", "").replace(
        WINDOW, "outside the program"), seconds]
        for label, seconds in trace.gaps(keep)]


def reduce(three, four, events, steps: int, seconds: float,
           measured_s: float, moved, cuda: bool) -> dict:
    """``program_trace`` from windows 3 and 4 (one device's ring)."""
    marks3 = next(iter(three["marks"].values()), [])
    marks4 = next(iter(four["marks"].values()), [])
    got = split(marks3, steps)
    dev_ops = sorted(trace._device(events)) if cuda else []
    starts = [s for s, _, name in dev_ops if MARK in name]
    # Marks pair with the trace's mark kernels only where the trace holds
    # them all: one it lost would shift every pair after it.
    paired = cuda and len(starts) == len(marks4) > 1
    traced = in_trace(marks4, dev_ops, starts, steps) if paired else {}
    span_names = {s["name"] for s in four["spans"]}
    step_s = seconds / steps
    return {
        "steps": steps,
        "phase_ms": got["phase_ms"],
        "kernels": {p: r["kernels"] for p, r in traced.items()},
        "trace_ms": {p: [r["span_ms"], r["kernel_ms"]]
                     for p, r in traced.items()},
        "cross_check": cross_check(got["phase_ms"], traced),
        "gap_share": got["gap_share"],
        "coverage": got["coverage"],
        "launch_ms": launch_ms(three["spans"], steps),
        "gaps": named_gaps(on_ring(events, marks4, starts) if paired
                           else events, span_names),
        "clock": clock(marks4, starts) if paired else {"pairs": 0},
        "drops": [sum(three["drops"].values()),
                  sum(four["drops"].values())],
        "on_cost": {"marked_ms": step_s * 1e3,
                    "measured_ms": measured_s * 1e3,
                    "share": step_s / measured_s - 1.0},
        "exchange_rows": ({k: v / steps for k, v in moved.items()}
                          if moved else None),
    }
