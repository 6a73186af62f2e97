"""Tracing / profiling / observability (the counterpart of
``gs2d_tpu/utils/profiling.py``):

- ``span``: a named host range of the program in torch.profiler's trace
  (free while no profiler records)
- ``timed_call``, ``cuda_ms``: time of a call from CUDA events (device
  time only while the launches queue faster than the device runs them)
- ``device_time``: device time of a call from a CUDA-graph replay, beside
  the CUDA-event reading and torch.profiler's kernel durations
- ``ThroughputCounter``: iterations/s, pixels/s, Gaussians/s and
  (splat, pixel)-pairs/s from workload constants
- ``JsonlLogger``: append-only metrics log, one JSON object per line
- ``device_trace``: context manager around ``torch.profiler`` that leaves a
  Chrome trace of the enclosed block
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler


# One null context for every span while no profiler records.
_OFF = contextlib.nullcontext()


def span(name: str):
    """A named host range of the program in torch.profiler's own trace, for
    ``with span("gs2d.<layer>.<stage>"):`` around a stage of work. The range
    is recorded with the trace's clock, so the device operations enqueued
    while it is open can be laid beside it; its parent is the range that
    encloses it on the same thread. Names start with ``gs2d.``, and a
    child's name starts with its parent's.

    While no profiler records it costs one check and returns a shared null
    context: no device work, no synchronisation, no host read. Recording, it
    is a FUNCTION-scope ``RecordFunction`` (``_RecordFunctionFast``): a host
    event and nothing on the device. ``torch.profiler.record_function``
    (and an NVTX range) is not used: it opens a user annotation, which the
    profiler also projects onto the device timeline as a CUDA event
    (``gpu_user_annotation``), and a reader that counts the trace's device
    operations, or their busy time, would count the range as one."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(name)


def timed_call(fn, reps: int = 1):
    """(the last result of ``fn``, mean ms of ``reps`` back-to-back calls
    on the current CUDA device between two CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` back-to-back calls between two CUDA
    events (``timed_call``), after one warm-up call. Where a call's host
    work (checks, allocation, launches) outlasts its kernels, this is host
    time: ``device_time`` reads the device's own."""
    fn()
    return timed_call(fn, reps)[1]


# The marker kernel that brackets a traced window (torch.cuda._sleep's), and
# how long it spins (GPU clock cycles).
_MARKER = "spin_kernel"
_MARKER_CYCLES = 100000


def _traced_kernels(fn, reps: int, attempts: int = 3):
    """{name: (ms a call, launches a call)} of the device operations of
    ``reps`` calls of ``fn``, from torch.profiler: the calls run between two
    marker kernels, after a first round that the tracer may see only in
    part, and the operations that ran on the device between the markers are
    summed. None when no attempt saw both markers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda._sleep(_MARKER_CYCLES)
            for _ in range(reps):
                fn()
            torch.cuda._sleep(_MARKER_CYCLES)
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        marks = sorted(e.time_range.start for e in ops if _MARKER in e.name)
        if len(marks) != 2:
            continue
        first = next(e for e in ops if e.time_range.start == marks[0])
        lo, hi = first.time_range.end, marks[1]
        seen = {}
        for e in ops:
            if lo <= e.time_range.start and e.time_range.end <= hi:
                us, n = seen.get(e.name, (0.0, 0))
                seen[e.name] = (us + e.time_range.end - e.time_range.start,
                                n + 1)
        return {name: (us / 1e3 / reps, n / reps)
                for name, (us, n) in seen.items()}
    return None


def device_time(fn, reps: int = 10) -> dict:
    """The time of a call of ``fn`` on the current CUDA device, read three
    ways after one warm-up call, in ms a call:

    - "device": the device's own time for the call's work. min(reps, 10)
      calls captured in one CUDA graph (after one call on a side stream),
      the graph's replays timed with CUDA events over about ``reps`` calls:
      the call's kernels back to back, with the graph's gaps of a
      microsecond or so between them, and none of the host's time;
    - "events": ``reps`` calls between two CUDA events, which measure the
      host where its launches queue slower than the device runs them;
    - "profiler": the sum of torch.profiler's durations of the call's
      device operations over ``reps`` calls (_traced_kernels), with
      "kernels" {name: (ms a call, launches a call)} and "ops" the
      operations a call; None, with "kernels" empty, where the tracer
      missed a marker in every attempt.

    ``fn`` must not read device data on the host (a graph captures no
    synchronisation)."""
    fn()
    _, events = timed_call(fn, reps)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    per_graph = min(reps, 10)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    _, replay_ms = timed_call(graph.replay, max(1, reps // per_graph))
    del graph
    kernels = _traced_kernels(fn, reps)
    return {"device": replay_ms / per_graph, "events": events,
            "profiler": (None if kernels is None
                         else sum(ms for ms, _ in kernels.values())),
            "ops": (None if kernels is None
                    else sum(n for _, n in kernels.values())),
            "kernels": kernels or {}}


class ThroughputCounter:
    """Derives the throughput metrics from workload constants."""

    def __init__(self, height: int, width: int, n_splats: int):
        self.pixels = height * width
        self.n_splats = n_splats

    def rates(self, seconds_per_iter: float, sweeps: int = 2) -> dict:
        """sweeps=2 counts forward+backward, matching the reference's two
        full rasterization passes per iteration."""
        return {
            "iters_per_s": 1.0 / seconds_per_iter,
            "pixels_per_s": sweeps * self.pixels / seconds_per_iter,
            "gaussians_per_s": sweeps * self.n_splats / seconds_per_iter,
            "splat_pixel_pairs_per_s":
                sweeps * self.pixels * self.n_splats / seconds_per_iter,
        }


class JsonlLogger:
    """Append-only JSONL metrics log (``path=None`` logs nowhere)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)

    def log(self, **record):
        record.setdefault("t", time.time())
        if self._f:
            self._f.write(json.dumps(record) + "\n")

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the enclosed block with ``torch.profiler`` (CPU activity, and
    CUDA activity where a GPU is visible) and write a Chrome trace,
    ``trace.json``, into ``log_dir`` (open in chrome://tracing or Perfetto).
    Yields the profiler, whose ``key_averages()`` sums time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
