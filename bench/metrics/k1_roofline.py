"""Aggregation: K1's least time a step over its device time a step, both
directions, in % (device trace).  The least time counts what the real
graph needs (``bench.yardstick.work.spmm``) for each neighbour sum the
model needs (the reference module's ``aggregations``), at the card's
published peaks."""
from bench.yardstick import peaks, work

KERNEL = "spmm_csr"


def read(ctx, name):
    s = ctx.summary
    if not s:
        return None
    sec = sum(t for k, (_, t) in s["ops"].items() if KERNEL in k)
    sums = ctx.model.aggregations(ctx.dims, ctx.train)
    if sec <= 0 or not sums:
        return None
    c = ctx.system.counts
    held = c["n"] + c["halo_rows"]
    least = 0.0
    for direction, width in sums:
        rows = (held, c["n"]) if direction == "fwd" else (c["n"], held)
        least += peaks.least_seconds(*work.spmm(c["arcs"], *rows, width))
    return 100.0 * least / (sec / s["steps"])
