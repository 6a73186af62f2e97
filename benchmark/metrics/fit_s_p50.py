"""The median of the window's call latencies (a job: from handing over its
population to its fitted parameters on the host), over every call of the
window."""

import statistics


def read(ctx):
    lat = [c["latency_s"] for c in ctx.calls]
    if not lat:
        return None
    return statistics.median(lat)
