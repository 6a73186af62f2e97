"""Readings of the traced span shared by the per-layer metrics, each per
unit of the traced call (an image-iteration of a fit, a frame of a
render)."""

from lib import workmodel


def ops_per_unit(ctx):
    """Device operations (kernels, copies, memsets) per unit."""
    span = ctx.span
    if span is None or not span.units or not span.device_ops:
        return None
    return len(span.device_ops) / span.units


def torch_ms_per_unit(ctx):
    """Device milliseconds of every operation that is not one of the
    program's own CUDA kernels (PyTorch's kernels, copies and memsets), per
    unit."""
    span = ctx.span
    if span is None or not span.units:
        return None
    own = ctx.is_port_kernel
    ms = sum(e - s for name, s, e in span.device_ops if not own(name)) / 1e6
    return ms / span.units


def mfu(ctx, operations):
    """100 x the float32 operations of a unit, ``operations(work, pixels,
    splats)`` averaged over the populations the span started from, over the
    span's wall seconds per unit, over the published float32 peak."""
    span = ctx.span
    if span is None or not span.units or span.wall_s <= 0:
        return None
    works = ctx.work()
    ops = sum(operations(w, px, n) for w, px, n in works) / len(works)
    return 100.0 * ops / (span.wall_s / span.units) / workmodel.F32_PEAK
