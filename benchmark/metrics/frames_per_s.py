"""Frames rendered in the window over its wall seconds."""


def read(ctx):
    if not ctx.calls:
        return None
    return sum(c["units"] for c in ctx.calls) / ctx.window_s
