"""Dense: device ms a step in the program's ``dense`` phases
(normalisation, matmul, activation), from the ring of marks of window 3
(``bench/marks.py``)."""
from bench import marks


def read(ctx, name):
    return marks.phase_ms(ctx, ("dense",))
