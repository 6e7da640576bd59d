"""Plan: real vertices over the rows of the blocks the forward takes and
returns (P x cap), in %."""


def read(ctx, name):
    c = ctx.system.counts
    return 100.0 * c["n"] / c["rows"]
