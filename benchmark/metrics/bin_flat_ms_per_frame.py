"""Device milliseconds of the operations that the flat binning
(``gs2d.bin_flat``: expansion, sort, run layout, pregather) enqueued, per
frame of the traced span."""

from lib import spans


def read(ctx):
    ms = spans.device_ms(ctx.span, spans.BIN_FLAT)
    return None if ms is None else ms / ctx.span.units
