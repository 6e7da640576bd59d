"""Layout: host seconds of the program's GLAD-S in set-up (host clock)."""


def read(ctx, name):
    return ctx.timings["glad_s_s"]
