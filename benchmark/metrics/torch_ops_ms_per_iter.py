"""Device milliseconds of every operation that is not one of the program's
own CUDA kernels (PyTorch's kernels, copies and memsets), per
image-iteration of the traced span."""

from lib import spanstats


def read(ctx):
    return spanstats.torch_ms_per_unit(ctx)
