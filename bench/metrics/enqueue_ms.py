"""Entry: host milliseconds a call takes to return in the window's
dispatched-ahead loop (host clock over the whole window)."""


def read(ctx, name):
    w = ctx.window
    return w["inside_s"] / max(w["steps"], 1) * 1e3
