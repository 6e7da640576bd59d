"""Device: kernels launched a step in the traced window (device trace;
copies and fills not counted)."""
from bench.trace import kernels


def read(ctx, name):
    s = ctx.summary
    if not s:
        return None
    count = sum(c for c, _ in kernels(s["ops"]).values())
    return count / s["steps"] if count else None
