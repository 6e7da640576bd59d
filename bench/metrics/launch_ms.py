"""Entry: host ms a call inside the program's ``step.replay`` span (the
graph's launch and the counters' replay deltas), from window 3's spans
(``bench/marks.py``)."""
from bench import marks


def read(ctx, name):
    got = marks.result(ctx)
    return None if got is None else got["launch_ms"]
