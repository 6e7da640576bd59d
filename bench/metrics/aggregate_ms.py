"""Aggregation: device ms a step in the program's ``aggregate`` phases
(the table build and the neighbour sum, K1 for GCN), or GAT's
``attention`` and ``messages``, from the ring of marks of window 3
(``bench/marks.py``)."""
from bench import marks


def read(ctx, name):
    return marks.phase_ms(ctx, marks.AGGREGATE)
