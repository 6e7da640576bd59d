"""Exchange: live halo rows received over the rows the exchange copied,
in %, from the program's ``exchange.rows`` counter (counted where the
exchange runs, and per replay by its captured step) over the run."""


def read(ctx, name):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    rows = tracing.counters().get("exchange.rows")
    if not rows or not rows["copied"]:
        return None
    return 100.0 * rows["live"] / rows["copied"]
