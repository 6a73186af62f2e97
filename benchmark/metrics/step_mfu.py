"""The step's float32 operations (the frozen work model's fused L2 pass of
the populations the traced span started from, plus moments_to_grads and
Adam per splat) over the traced span's wall seconds per image-iteration,
as a share of the published float32 peak."""

from lib import spanstats, workmodel


def read(ctx):
    return spanstats.mfu(ctx, workmodel.step_operations)
