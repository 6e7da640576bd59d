"""Exchange: device ms a step in the program's ``exchange`` phases (the
ppermute rounds or the allgather, with the halo writes), from the ring
of marks of window 3 (``bench/marks.py``)."""
from bench import marks


def read(ctx, name):
    return marks.phase_ms(ctx, ("exchange",))
