"""Device: the share of window 3's device span (first call-begin mark to
last call-end mark) between one call's end mark and the next call's
begin mark, in %: the card idle between calls with no profiler attached
(``bench/marks.py``)."""
from bench import marks


def read(ctx, name):
    got = marks.result(ctx)
    return None if got is None else got["gap_share"]
