"""Plan: real arcs (directed links, and self loops where the model has
them) over the messages the segment path sums (P x e_cap), in %.  Only
where the forward aggregates on the segment path."""


def read(ctx, name):
    if ctx.mode != "segment":
        return None
    c = ctx.system.counts
    arcs = c["arcs"] + (c["n"] if getattr(ctx.model, "SELF_LOOPS", False)
                        else 0)
    return 100.0 * arcs / c["messages"]
