"""Kernel 10 (csrc/render_flat.cu, the flat forward) against its bound, the
frozen work model's least time for a forward pass of the populations the
traced span started from."""

from lib import roofline

KERNELS = ("fwd_flat_kernel",)


def read(ctx):
    return roofline.share(ctx, "fwd", KERNELS)
