"""Share of the traced span in which the device was idle while the flat
binning (``gs2d.bin_flat``) was open on the host: the launch-bound part of
the binning."""

from lib import spans


def read(ctx):
    span = ctx.span
    if spans.attribution(span) is None or span.window_s <= 0:
        return None
    return 100.0 * spans.idle_overlap_s(span, spans.BIN_FLAT) / span.window_s
