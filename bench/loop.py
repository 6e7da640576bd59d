"""The measured window: a closed loop of calls, dispatched ahead.

The host issues call after call without waiting for the card, but keeps
at most ``depth`` calls in flight: before issuing call k it waits for the
card to finish call k - depth (a CUDA event).  So a call never blocks on
a full launch queue, and the host time spent inside the calls is the
time they take to return.  The window's time runs from the first call to
the end of the last one on the card; its steps are every call it issued."""
from __future__ import annotations

import collections
import time


def run(call, seconds: float, depth: int, device, start: int = 0) -> dict:
    """Calls ``call(k)`` for k = start, start + 1, ... until ``seconds``
    have passed on the host clock, then waits for the card: the steps,
    the window's seconds and the host seconds spent inside the calls."""
    import torch
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    pending = collections.deque()
    inside = 0.0
    k = start
    t0 = time.perf_counter()
    while True:
        if len(pending) >= depth:
            pending.popleft().synchronize()
        t = time.perf_counter()
        if t - t0 >= seconds:
            break
        call(k)
        inside += time.perf_counter() - t
        k += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
    if cuda:
        torch.cuda.synchronize(device)
    return {"steps": k - start, "seconds": time.perf_counter() - t0,
            "inside_s": inside, "next": k}


def run_steps(call, steps: int, depth: int, device, start: int = 0) -> int:
    """``steps`` calls in the same loop, with no clock; returns the next k."""
    import torch
    cuda = device.type == "cuda"
    pending = collections.deque()
    for k in range(start, start + steps):
        if len(pending) >= depth:
            pending.popleft().synchronize()
        call(k)
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
    if cuda:
        torch.cuda.synchronize(device)
    return start + steps
