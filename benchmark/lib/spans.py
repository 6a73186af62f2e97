"""The program's own host ranges in the traced span, and the device
operations enqueued inside each.

The program opens a named range at each layer boundary of its render path
(``gs2d_tpu_torch/utils/profiling.py::span``: ``gs2d.render``, its children
``gs2d.bin_flat`` with the binning's stages ``gs2d.bin_flat.<stage>``, and
``gs2d.fwd_flat``). They are host events of the profiler's own trace. A
span of a checkout whose program has no ranges yields nothing here, and the
metrics that read it report nothing.

Attribution: the host runtime calls that put work on the device (kernel
launches, asynchronous copies and memsets) made inside the ``gs2d.render``
ranges, in order of their start, are matched one for one to the span's
device operations in order of their start: the render path enqueues on one
stream, which runs in order. Each operation goes to the innermost program
range open when its call started. The match is by order, not by time: in
some sessions the profiler's device timestamps sit up to a fraction of a
millisecond off its host timestamps. Where the two counts differ (a call
the trace did not see, or device work enqueued outside a render), there is
no attribution: nothing is guessed.
"""

from __future__ import annotations

import bisect

PREFIX = "gs2d."
RENDER = "gs2d.render"
BIN_FLAT = "gs2d.bin_flat"
# The runtime calls that enqueue the render path's device work, as the
# card's trace names them (PyTorch's kernels and the program's own are
# launched alike).
ENQUEUE = frozenset({"cudaLaunchKernel", "cudaMemcpyAsync",
                     "cudaMemsetAsync"})


def ranges(span, name=None) -> list:
    """[(name, start_ns, end_ns)] of the program's ranges in ``span``,
    sorted by start; only those called ``name`` where it is given."""
    return sorted(((n, s, e) for n, s, e in span.host_ops
                   if n.startswith(PREFIX) and (name is None or n == name)),
                  key=lambda r: r[1])


def _within(t: int, rs: list, starts: list) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < rs[i][2]


def innermost(t: int, rs: list) -> str | None:
    """The name of the latest-started range of ``rs`` (sorted by start)
    that is open at ``t``: ranges of one thread nest, so it is the
    innermost."""
    for n, s, e in reversed(rs):
        if s <= t < e:
            return n
    return None


def attribution(span) -> list | None:
    """[(range name, (op name, start_ns, end_ns))] for every device
    operation of ``span``, or None where the program has no render range in
    it or the enqueueing calls inside them and the device operations differ
    in number."""
    if span is None or not span.units:
        return None
    renders = ranges(span, RENDER)
    if not renders:
        return None
    starts = [s for _, s, _ in renders]
    calls = sorted((c for c in span.host_ops
                    if c[0] in ENQUEUE and _within(c[1], renders, starts)),
                   key=lambda c: c[1])
    ops = sorted(span.device_ops, key=lambda o: o[1])
    if not ops or len(calls) != len(ops):
        return None
    rs = ranges(span)
    return [(innermost(c[1], rs), op) for c, op in zip(calls, ops)]


def device_ms(span, prefix: str) -> float | None:
    """Device milliseconds of the operations enqueued inside the ranges
    whose names start with ``prefix`` (their children's included), or
    None where there is no attribution."""
    got = attribution(span)
    if got is None:
        return None
    return sum(e - s for name, (_, s, e) in got
               if name == prefix or name.startswith(prefix + ".")) / 1e6


def idle_overlap_s(span, name: str) -> float:
    """Seconds of the span in which the device was idle while a range
    called ``name`` was open on the host (host ranges against device
    gaps: as exact as the trace's two clocks agree)."""
    gaps, t = [], span.lo
    for s, e in span.busy_intervals() + [[span.hi, span.hi]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    total = 0
    for _, s, e in ranges(span, name):
        for a, b in gaps:
            total += max(0, min(b, e) - max(a, s))
    return total * 1e-9
