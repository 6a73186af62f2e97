"""Host milliseconds the render path takes to enqueue a frame: the summed
``gs2d.render`` ranges of the traced span over its frames. Beside the busy
milliseconds a frame it says whether the host or the device sets the
pace."""

from lib import spans


def read(ctx):
    if spans.attribution(ctx.span) is None:
        return None
    ns = sum(e - s for _, s, e in spans.ranges(ctx.span, spans.RENDER))
    return ns / 1e6 / ctx.span.units
