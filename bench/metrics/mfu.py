"""Whole step: the system's floating-point operations a step
(``System.flops``: for the GNN layout the reference module's ``flops`` on
the real graph) over the window's time a step and the card's peak in the
precision the system computes in (``System.peak_ops_per_s``), in % (host
clock).  Only on the card."""


def read(ctx, name):
    w = ctx.window
    if ctx.device.type != "cuda" or not w["steps"]:
        return None
    step_s = w["seconds"] / w["steps"]
    flops = ctx.system.flops(ctx.train)
    return 100.0 * flops / step_s / ctx.system.peak_ops_per_s
