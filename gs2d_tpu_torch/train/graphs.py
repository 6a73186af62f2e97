"""Blocks of train steps without the host: the port's counterpart of the
``lax.scan`` in gs2d_tpu's ``make_fit_scan_fused`` / ``make_fit_scan``.

PyTorch has no scan, so on the card one train step is captured once as a
CUDA graph over static buffers and replayed ``n`` times with no host work
between replays (``StepGraph``); on the CPU, where the tests run, the same
step body runs in a Python loop (``loop.make_fit_scan_fused``).

- The state (the 21 leaves of a TrainState), the padded target and the
  lazy-rebinning cache live in static buffers. The captured step reads
  them, and ends by copying the new state into them.
- Each replay writes its StepAux into (n_max,) buffers at a device-side
  index that the graph advances, so one graph serves every block length up
  to ``n_max`` and the host reads the block's aux once. A summed field
  (the (N,) densify signal) is not kept a step: the replays add it into
  one static accumulator, which each block starts from zero (a fill on the
  device) or from a sum it continues.
- The rebin choice stays on the device, as ``lax.cond`` keeps it in
  gs2d_tpu. PyTorch's own conditional capture of ``torch.cond``
  (``torch._higher_order_ops.cudagraph_conditional_nodes``) is missing
  from PyTorch releases the port runs on (2.11 among them), so the binning
  is captured as a graph of its own (which writes the cache buffers) and
  ``csrc/graph_cond.cu`` puts a copy of it under a CUDA "if" node in the
  step's graph: a step whose cache holds launches none of the binning's
  kernels.
- Warm-up runs one step on a side stream before the capture, as PyTorch's
  CUDA-graph rules ask, and the statics are reset after it. Warm-up and
  capture add nothing to the kernels' launch counts; each replay adds the
  launches one captured step makes.

There is no fallback: a capture or replay that fails raises.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, List, NamedTuple, Optional

import torch

from gs2d_tpu_torch.ops import _build


def launch_counters() -> list:
    """The ``launches`` dicts of every kernel module."""
    from gs2d_tpu_torch.ops import probes, render_dense, render_flat
    from gs2d_tpu_torch.ops import render_mxu, render_resident, render_window

    return [m.launches for m in (render_resident, render_flat, render_dense,
                                 render_window, render_mxu, probes)]


def _read_counts() -> List[dict]:
    return [dict(c) for c in launch_counters()]


def _set_counts(counts: List[dict]) -> None:
    for live, saved in zip(launch_counters(), counts):
        live.update(saved)


def graph_if(flag: torch.Tensor, body: torch.cuda.CUDAGraph) -> None:
    """While the current stream is captured: run a copy of ``body`` (a
    captured, not instantiated graph) only on replays where the 0-d int32
    ``flag`` is not 0 (csrc/graph_cond.cu)."""
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("graph_if outside a CUDA graph capture")
    err = _build.library().gs2d_graph_if(
        flag.data_ptr(), body.raw_cuda_graph(),
        torch.cuda.current_stream(flag.device).cuda_stream)
    _build.check(err, "conditional node")


class Capture(NamedTuple):
    """What capturing one step cost, in seconds of host time."""

    warmup_s: float
    capture_s: float


class StepGraph:
    """One train step captured over static buffers (see the module
    docstring).

    ``step(leaves, ref, cache, rebin) -> (leaves, aux)`` is the step body
    on lists of tensors: ``leaves`` the state's, ``cache`` the lazy cache's
    (empty without one), ``aux`` a NamedTuple of 0-d tensors or Python
    numbers (constants of the step). It calls ``rebin(pred, params)`` at
    most once, with the 0-d bool rebin predicate and the params of
    ``leaves``; afterwards ``cache`` holds ``make_cache(leaves)`` where the
    predicate held and its old values elsewhere. ``make_cache(leaves)``
    returns the cache's tensors from the state's leaves (the fresh binning
    of the params). ``aux_fields`` names the aux fields to keep a step,
    ``summed`` (or None) the tensor field to sum over the replays into
    ``total``."""

    def __init__(self, step: Callable, make_cache: Optional[Callable],
                 leaves, ref: torch.Tensor, n_max: int, aux_fields,
                 summed: Optional[str] = None):
        if not leaves[0].is_cuda:
            raise ValueError("StepGraph captures CUDA tensors only")
        self.n_max = n_max
        dev = leaves[0].device
        self.leaves = [t.detach().clone() for t in leaves]
        self.ref = ref.detach().clone()
        self.make_cache = make_cache
        self.cache = [] if make_cache is None else [
            t.clone() for t in make_cache(self.leaves)]
        self.flag = torch.zeros((), dtype=torch.int32, device=dev)
        self.index = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.aux_fields = aux_fields
        self.aux = None
        self.summed = summed
        self.total = None
        self.body_graph = None
        before = _read_counts()
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step(step, self._rebin_eager)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        warmup_s = time.perf_counter() - t0
        self.load(leaves, ref)
        t0 = time.perf_counter()
        # No garbage collection while capturing: freeing an unreachable
        # graph destroys it, which CUDA refuses during a capture.
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            if make_cache is not None:
                self.body_graph = torch.cuda.CUDAGraph(keep_graph=True)
                with torch.cuda.graph(self.body_graph):
                    self._refresh_cache()
            mid = _read_counts()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._step(step, self._rebin_graph)
            after = _read_counts()
        finally:
            if gc_was_on:
                gc.enable()
        torch.cuda.synchronize(dev)
        self.capture = Capture(warmup_s, time.perf_counter() - t0)
        # Launches of one replay: those made while the step was captured.
        self.per_replay = [{k: a[k] - m[k] for k in a}
                           for a, m in zip(after, mid)]
        _set_counts(before)

    def _refresh_cache(self) -> None:
        for dst, src in zip(self.cache, self.make_cache(self.leaves)):
            dst.copy_(src)

    def _rebin_eager(self, pred: torch.Tensor, params=None) -> None:
        if bool(pred):
            self._refresh_cache()

    def _rebin_graph(self, pred: torch.Tensor, params=None) -> None:
        # ``params`` are the static leaves' own, which the body graph reads.
        self.flag.copy_(pred)
        graph_if(self.flag, self.body_graph)

    def _step(self, step, rebin) -> None:
        new, aux = step(self.leaves, self.ref, self.cache, rebin)
        for dst, src in zip(self.leaves, new):
            dst.copy_(src)
        if self.aux is None:
            self.aux = {f: torch.zeros(
                (self.n_max,), device=self.index.device,
                dtype=(getattr(aux, f).dtype
                       if torch.is_tensor(getattr(aux, f)) else torch.int32))
                for f in self.aux_fields}
        for f in self.aux_fields:
            v = getattr(aux, f)
            if torch.is_tensor(v):
                self.aux[f].index_copy_(0, self.index, v.reshape(1))
            elif not torch.cuda.is_current_stream_capturing():
                self.aux[f].fill_(v)  # a constant, written at warm-up
        if self.summed is not None:
            v = getattr(aux, self.summed)
            if self.total is None:
                self.total = torch.zeros_like(v)  # allocated at warm-up
            self.total.add_(v)
        self.index.add_(1)

    def load(self, leaves, ref: torch.Tensor,
             total: Optional[torch.Tensor] = None) -> None:
        """Copy a state and target into the statics, bin the params afresh
        into the cache (each block starts from a fresh binning, as each
        gs2d_tpu scan does), rewind the aux index and start the summed
        field from zero (a fill on the device, no copy from the host) or
        from ``total``."""
        for dst, src in zip(self.leaves, leaves):
            dst.copy_(src)
        self.ref.copy_(ref)
        if self.make_cache is not None:
            self._refresh_cache()
        self.index.zero_()
        if self.total is not None:
            if total is None:
                self.total.zero_()
            else:
                self.total.copy_(total)

    def run(self, leaves, ref: torch.Tensor, n: int,
            total: Optional[torch.Tensor] = None):
        """``n`` replays from ``leaves`` (the summed field from ``total``,
        or zero): (new leaves, {field: (n,) aux}, the sum or None), copies
        that later runs do not overwrite."""
        if not 0 < n <= self.n_max:
            raise ValueError(f"{n} steps: the graph's aux buffers hold "
                             f"1 to {self.n_max}")
        self.load(leaves, ref, total)
        for _ in range(n):
            self.graph.replay()
        for live, per in zip(launch_counters(), self.per_replay):
            for k, v in per.items():
                live[k] += n * v
        return ([t.clone() for t in self.leaves],
                {f: b[:n].clone() for f, b in self.aux.items()},
                None if self.total is None else self.total.clone())
