"""Backward: device ms a train step in the program's ``loss`` and
``backward`` phases (the loss, then ``torch.autograd.grad``: K1's
backward, the segment sums', the exchange's adjoint), from the ring of
marks of window 3 (``bench/marks.py``)."""
from bench import marks


def read(ctx, name):
    return marks.phase_ms(ctx, ("loss", "backward"))
