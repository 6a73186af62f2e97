"""Kernel 1 (csrc/render_resident.cu: the fused L2 patch kernel and its
patch sum) against its bound: the frozen work model's least time for the
fused L2 pass of the populations the traced span started from, over the
kernel's device time per image-iteration."""

from lib import roofline

KERNELS = ("l2_resident_kernel", "patch_sum_kernel")


def read(ctx):
    return roofline.share(ctx, "l2", KERNELS)
