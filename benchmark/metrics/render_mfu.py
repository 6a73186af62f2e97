"""A frame's float32 operations (the frozen work model's forward pass of
the populations the traced span rendered) over the traced span's wall
seconds per frame, as a share of the published float32 peak."""

from lib import spanstats, workmodel


def read(ctx):
    return spanstats.mfu(
        ctx, lambda w, px, n: workmodel.operations("fwd", w, px))
