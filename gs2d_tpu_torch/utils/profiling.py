"""Tracing / profiling / observability (the counterpart of
``gs2d_tpu/utils/profiling.py``):

- ``sync``: wait for the device a tensor lies on (nothing on the CPU)
- ``PhaseTimer``: wall-clock phase timing with device sync, so numbers mean
  what they say under asynchronous launches
- ``timed_call``, ``cuda_ms``: device time of a call from CUDA events
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
from collections import defaultdict
from typing import Optional

import torch


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = tree.values()
    elif hasattr(tree, "__dict__") and not isinstance(tree, type):
        tree = vars(tree).values()
    if isinstance(tree, (str, bytes)) or not hasattr(tree, "__iter__"):
        return None
    for item in tree:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


def sync(tree=None):
    """Wait until the device of the first tensor in ``tree`` (a tensor, or a
    nesting of tuples, lists, dicts and dataclasses of them) has finished
    its queued work: ``torch.cuda.synchronize`` for a CUDA tensor, nothing
    for a CPU tensor or no tensor."""
    x = _first_tensor(tree)
    if x is not None and x.is_cuda:
        torch.cuda.synchronize(x.device)


class PhaseTimer:
    """Accumulating wall-clock timer keyed by phase name."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        sync(result)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def time(self, name: str, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def summary(self) -> dict:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def report(self, log=print):
        for name, s in sorted(self.summary().items()):
            log(f"{name:24s} {s['mean_ms']:9.3f} ms/call  x{s['count']}")


def timed_call(fn, reps: int = 1):
    """(the last result of ``fn``, mean device time in ms of ``reps``
    back-to-back calls on the current CUDA device), from CUDA events."""
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
    """Mean device time (ms) of ``fn`` over ``reps`` back-to-back calls
    (``timed_call``), after one warm-up call."""
    fn()
    return timed_call(fn, reps)[1]


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
