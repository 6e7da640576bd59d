"""The traced windows and what the benchmark reads from them.

The profiler loses the first events of a window it starts right before
the calls, so the calls run as the active step of a schedule after one
traced warm-up step, which is discarded (the method of ``device_ms`` in
the repository's ``chip_smoke.py``).  Two windows run, each in the
measured window's own loop.  The first records the card's activity
alone, with no host span, so the host's pace is the untraced loop's but
for the tracer's own cost in the launches: every metric and ``busy_s``
and ``window_s`` come from it, its length on the host clock with the card
synchronized at both ends.  The second records the host too, under a
span a call, only to name what the host was doing in the card's longest
idle gaps."""
from __future__ import annotations

import re
import time

from bench import loop

COPY = ("Memcpy", "Memset")


def short(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise and
    argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:120]


def _window(call, steps: int, depth: int, device, start: int, acts,
            spans: bool) -> tuple:
    """``steps`` calls of ``call(k)`` as the active step of a profiler
    schedule, under ``bench.window`` and a ``bench.call`` span each where
    ``spans``: (the active step's events, its seconds on the host clock,
    the next k)."""
    from torch.profiler import profile, record_function, schedule

    def labelled(k):
        with record_function("bench.call"):
            call(k)

    body = labelled if spans else call
    got = []
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: got.append(p.events())) as prof:
        k = loop.run_steps(body, 2, depth, device, start)
        prof.step()
        t0 = time.perf_counter()
        if spans:
            with record_function("bench.window"):
                k = loop.run_steps(body, steps, depth, device, k)
        else:
            k = loop.run_steps(body, steps, depth, device, k)
        seconds = time.perf_counter() - t0
        prof.step()
    return (got[0] if got else []), seconds, k


def traced(call, steps: int, depth: int, device, start: int = 0) -> dict:
    """The two traced windows of ``steps`` calls each: the first's
    :func:`reduce`, with the second's idle gaps (:func:`gaps`)."""
    from torch.profiler import ProfilerActivity
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    events, seconds, k = _window(call, steps, depth, device, start, acts,
                                 spans=False)
    summary = reduce(events, steps, seconds)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    events, _, _ = _window(call, steps, depth, device, k, acts, spans=True)
    summary["gaps"] = gaps(events)
    return summary


def _merge(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _device(events) -> list:
    """(start, end, name) of every operation on the card, in µs."""
    from torch.autograd import DeviceType
    return [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("ProfilerStep")]


def reduce(events, steps: int, seconds: float) -> dict:
    """From a window traced on the card alone: its ``seconds``, the
    seconds in which anything ran on the card (kernels, copies and
    fills), and each device operation's count and seconds."""
    dev = _device(events)
    ops = {}
    for s, t, name in dev:
        c, sec = ops.get(name, (0, 0.0))
        ops[name] = (c + 1, sec + (t - s) * 1e-6)
    busy = _merge([(s, t) for s, t, _ in dev])
    return {"steps": steps, "window_s": seconds,
            "busy_s": sum(t - s for s, t in busy) * 1e-6, "ops": ops}


def gaps(events) -> list:
    """The card's ten longest idle gaps in a window traced with the host,
    longest first, each with what the host was doing at its middle: the
    innermost host span there, under the benchmark's own span."""
    from torch.autograd import DeviceType
    window = [e for e in events if e.name == "bench.window"
              and e.device_type == DeviceType.CPU]
    if not window:
        return []
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    dev = [(max(s, w0), min(t, w1)) for s, t, _ in _device(events)
           if t > w0 and s < w1]
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU and not e.is_async
            and not e.name.startswith("ProfilerStep")]
    busy = _merge(dev)
    edges = [w0] + [x for span in busy for x in span] + [w1]
    longest = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                      for i in range(0, len(edges), 2)
                      if edges[i + 1] > edges[i]), reverse=True)[:10]
    named = []
    for length, s, t in longest:
        mid = (s + t) / 2
        around = sorted((b - a, name) for a, b, name in host
                        if a <= mid <= b)
        inner = around[0][1] if around else "host outside any span"
        outer = next((name for _, name in around
                      if name.startswith("bench.")), None)
        label = inner if outer in (None, inner) else f"{outer} > {inner}"
        named.append([label, length * 1e-6])
    return named


def kernels(ops: dict) -> dict:
    """The device operations that are kernels (not copies or fills)."""
    return {k: v for k, v in ops.items() if not k.startswith(COPY)}


def breakdown(summary: dict) -> dict:
    """The ten device operations with the most seconds a step, and the ten
    longest idle gaps with what the host was doing."""
    steps = max(summary["steps"], 1)
    top = sorted(summary["ops"].items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[short(k), sec / steps] for k, (_, sec) in top],
            "idle_gaps": summary["gaps"]}
