"""Device milliseconds of every operation that is not one of the program's
own CUDA kernels (the binning's PyTorch kernels, copies and memsets), per
frame of the traced span."""

from lib import spanstats


def read(ctx):
    return spanstats.torch_ms_per_unit(ctx)
