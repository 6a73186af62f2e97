"""Device operations (kernels, copies, memsets) in the traced span, over its
image-iterations."""

from lib import spanstats


def read(ctx):
    return spanstats.ops_per_unit(ctx)
