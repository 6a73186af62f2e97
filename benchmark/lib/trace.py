"""The device trace of a bounded span of the window, from torch.profiler.

The span's calls run between two marker kernels (``torch.cuda._sleep``);
the device operations that start after the first marker ends and end
before the second starts are the span's (the way
``gs2d_tpu_torch/utils/profiling.py::_traced_kernels`` reads a trace,
copied here). A trace that misses a marker is dropped and the caller traces
the next call. Busy time is the union of the span's device operations;
idle gaps are the rest of the span, each labelled by the host operation
that was running at its middle ("python" where none was).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

MARKER = "spin_kernel"
MARKER_CYCLES = 100000
NAME_CHARS = 160


def _events(prof):
    """[(name, is_device, start_ns, end_ns)] of every traced event, read
    from the profiler's raw results (building its FunctionEvent tree would
    take longer than the span)."""
    from torch.autograd import DeviceType

    return [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
             e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


class Span:
    """The device operations of a traced span and what the host did."""

    def __init__(self, device_ops, host_ops, lo: int, hi: int):
        self.device_ops = device_ops      # [(name, start_ns, end_ns)]
        self.host_ops = host_ops          # [(name, start_ns, end_ns)]
        self.lo, self.hi = lo, hi
        self.units = 0                    # image-iterations or frames
        self.wall_s = 0.0
        self.start_params = []            # populations the span started from

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-9

    def busy_intervals(self) -> list:
        merged = []
        for _, s, e in sorted(self.device_ops, key=lambda o: o[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def op_seconds(self) -> dict:
        """Device seconds by operation name."""
        out = defaultdict(float)
        for name, s, e in self.device_ops:
            out[name] += (e - s) * 1e-9
        return out

    def idle_by_host(self) -> dict:
        """Idle device seconds by the host operation running meanwhile."""
        host = sorted(self.host_ops, key=lambda o: o[1])
        starts = [o[1] for o in host]
        out = defaultdict(float)
        t = self.lo
        for s, e in self.busy_intervals() + [[self.hi, self.hi]]:
            if s > t:
                mid = (s + t) // 2
                label = "python"
                i = bisect.bisect_right(starts, mid) - 1
                for j in range(i, max(i - 64, -1), -1):
                    if host[j][2] >= mid:
                        label = host[j][0]
                        break
                out[label] += (s - t) * 1e-9
            t = max(t, e)
        return out

    def breakdown(self) -> dict:
        top = lambda d: [[k[:NAME_CHARS], v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.op_seconds()),
                "idle_gaps": top(self.idle_by_host())}


def traced(run):
    """Run ``run()`` under the profiler between two markers. Returns
    (run's result, Span or None where a marker was missed)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(MARKER_CYCLES)
        out = run()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
    events = _events(prof)
    marks = sorted((s, e) for name, dev, s, e in events
                   if dev and MARKER in name)
    if len(marks) != 2:
        return out, None
    lo, hi = marks[0][1], marks[1][0]
    dev_ops = [(n, s, e) for n, dev, s, e in events
               if dev and lo <= s and e <= hi]
    host_ops = [(n, s, e) for n, dev, s, e in events
                if not dev and s < hi and e > lo]
    return out, Span(dev_ops, host_ops, lo, hi)
