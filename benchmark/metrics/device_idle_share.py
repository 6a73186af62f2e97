"""Share of the traced span in which no device operation ran."""


def read(ctx):
    span = ctx.span
    if span is None or span.window_s <= 0:
        return None
    return 100.0 * (1.0 - span.busy_s / span.window_s)
