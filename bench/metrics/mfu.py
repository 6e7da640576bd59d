"""Whole step: the model's floating-point operations a step on the real
graph (the reference module's ``flops``) over the window's time a step
and the card's float32 peak, in % (host clock).  Only on the card."""
from bench.yardstick import peaks


def read(ctx, name):
    w = ctx.window
    if ctx.device.type != "cuda" or not w["steps"]:
        return None
    step_s = w["seconds"] / w["steps"]
    flops = ctx.model.flops(ctx.system.counts, ctx.dims, ctx.kind == "train")
    return 100.0 * flops / step_s / peaks.FP32_OPS_PER_S
