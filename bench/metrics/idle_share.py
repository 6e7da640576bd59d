"""Device: share of the traced window in which nothing ran on the card,
in % (device trace: the window traced on the card alone, with no host
span)."""


def read(ctx, name):
    s = ctx.summary
    if not s or s["busy_s"] <= 0 or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
