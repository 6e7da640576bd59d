"""Plan: host seconds to compile the plan, build its BSR where the
forward aggregates with K1, and build the forward's plan tensors (host
clock)."""


def read(ctx, name):
    return ctx.timings["plan_s"]
