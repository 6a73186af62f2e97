"""Blocks of train steps without the host: the port's counterpart of the
``lax.scan`` in gs2d_tpu's ``make_fit_scan_fused`` / ``make_fit_scan`` and
of the ``shard_map(lax.scan(step))`` of its ``make_fit_scan_sharded``.

PyTorch has no scan, so on the card one train step is captured once as a
CUDA graph over static buffers and replayed ``n`` times with no host work
between replays (``StepGraph``); on the CPU, where the tests run, the same
step body runs in a Python loop (``BlockRunner`` does either).

- The state (the leaves of one or more TrainStates), the padded target and
  the lazy-rebinning caches live in static buffers. The captured step
  reads them, and ends by copying the new state into them.
- Each replay writes its aux into (n_max, ...) buffers at a device-side
  index that the graph advances, so one graph serves every block length up
  to ``n_max`` and the host reads the block's aux once. A summed field
  (the densify signal) is not kept a step: the replays add it into one
  static accumulator, which each block starts from zero (a fill on the
  device) or from a sum it continues.
- The rebin choice stays on the device, as ``lax.cond`` keeps it in
  gs2d_tpu. PyTorch's own conditional capture of ``torch.cond``
  (``torch._higher_order_ops.cudagraph_conditional_nodes``) is missing
  from PyTorch releases the port runs on (2.11 among them), so each cache's
  binning is captured as a graph of its own (which writes that cache's
  buffers) and ``csrc/graph_cond.cu`` puts a copy of it under a CUDA "if"
  node in the step's graph: a step whose cache holds launches none of the
  binning's kernels. A mesh step keeps one cache, graph and node for each
  (coordinate, image) of the process.
- Warm-up runs one step on a side stream before the capture, as PyTorch's
  CUDA-graph rules ask, and the statics are reset after it. Warm-up and
  capture add nothing to the kernels' launch counts; each replay adds the
  launches one captured step makes.

NCCL collectives in the step (``parallel/sharded.py``'s ``DistComm`` on a
process mesh of several cards) are captured like kernels: NCCL 2.9.6 and
later record a collective issued on a capturing stream as graph nodes, and
a replay runs it again on every rank. What the port relies on:

- Every rank captures the same collectives in the same order, each with
  the same shapes: the step's control flow depends on the mesh's shape and
  the coordinate's index only around arithmetic, never around a
  collective, and every rank runs a block of the same length, so every
  rank captures at the same call. No collective sits under a conditional
  node (a band's binning is local to its rank).
- The warm-up step runs each collective once, eagerly, so each axis
  group's communicator, which PyTorch creates at its first collective,
  exists before the capture (creating one cannot be captured).
- ``ProcessGroupNCCL`` keeps work issued on a capturing stream away from
  its watchdog thread (PyTorch's CUDA-graph notes for NCCL), so the
  watchdog, and with it ``TORCH_NCCL_ASYNC_ERROR_HANDLING`` and the
  collective timeout, never queries a captured collective's events, which
  would be illegal during a capture in the default global mode. A failure
  inside a replayed collective therefore surfaces as a CUDA or NCCL error
  of a later call, not as the watchdog's abort.
- ``Work.wait()`` of a collective issued during the capture makes the
  capturing stream wait on the collective's end (an event edge in the
  graph); it blocks no host thread.

PyTorch 2.11's ``ProcessGroupNCCL`` reads the capture status of every
collective it issues (its ``errorIfCapturingNonCapturableNCCL`` refuses
NCCL before 2.9.6); ``parallel/sharded.py`` refuses such an NCCL before it
captures. On PyTorch 2.11 with NCCL 2.28.9, two- and four-rank clusters on
H100s replay such a step (all-gathers, all-reduces, and the scan combine's
``batch_isend_irecv`` exchanges) equal to their eager steps bit for bit
(``chip_smoke.py --mesh-cluster``).

There is no fallback: a capture or replay that fails raises.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

from gs2d_tpu_torch.ops import _build


def launch_counters() -> list:
    """The ``launches`` dicts of every kernel module."""
    from gs2d_tpu_torch.ops import probes, render_dense, render_flat
    from gs2d_tpu_torch.ops import render_mxu, render_resident, render_window
    from gs2d_tpu_torch.ops import tiles_flat

    return [m.launches for m in (render_resident, render_flat, render_dense,
                                 render_window, render_mxu, probes,
                                 tiles_flat)]


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

    ``step(leaves, ref, caches, rebin) -> (leaves, aux)`` is the step body
    on lists of tensors: ``leaves`` the state's, ``caches`` a list of lazy
    caches (each a list of tensors; empty without one), ``aux`` a
    NamedTuple of tensors or Python numbers (constants of the step). It
    calls ``rebin(i, pred)`` at most once for each cache ``i``, with a 0-d
    bool rebin predicate; afterwards ``caches[i]`` holds
    ``make_caches[i](leaves)`` where the predicate held and its old values
    elsewhere. ``make_caches[i](leaves)`` returns cache ``i``'s tensors from
    the state's leaves (a fresh binning of the params it serves); each cache
    gets its own binning graph and its own conditional node. ``aux_fields``
    names the aux fields to keep a step (each (n_max, ...) of the field's
    shape), ``summed`` (or None) the tensor field to sum over the replays
    into ``total``."""

    def __init__(self, step: Callable, make_caches: Sequence[Callable],
                 leaves, ref: torch.Tensor, n_max: int, aux_fields,
                 summed: Optional[str] = None):
        if not leaves[0].is_cuda:
            raise ValueError("StepGraph captures CUDA tensors only")
        self.n_max = n_max
        dev = leaves[0].device
        self.leaves = [t.detach().clone() for t in leaves]
        self.ref = ref.detach().clone()
        self.make_caches = list(make_caches)
        self.caches = [[t.clone() for t in make(self.leaves)]
                       for make in self.make_caches]
        self.flags = [torch.zeros((), dtype=torch.int32, device=dev)
                      for _ in self.make_caches]
        self.index = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.aux_fields = aux_fields
        self.aux = None
        self.summed = summed
        self.total = None
        self.body_graphs = []
        before = _read_counts()
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # Runs every collective of the step once, so that each process
            # group's communicator exists before the capture.
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
            for i in range(len(self.caches)):
                body = torch.cuda.CUDAGraph(keep_graph=True)
                with torch.cuda.graph(body):
                    self._refresh_cache(i)
                self.body_graphs.append(body)
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

    def _refresh_cache(self, i: int) -> None:
        for dst, src in zip(self.caches[i], self.make_caches[i](self.leaves)):
            dst.copy_(src)

    def _rebin_eager(self, i: int, pred: torch.Tensor) -> None:
        if bool(pred):
            self._refresh_cache(i)

    def _rebin_graph(self, i: int, pred: torch.Tensor) -> None:
        # The body graph reads the static leaves, which hold the step's
        # incoming state until the step's end.
        self.flags[i].copy_(pred)
        graph_if(self.flags[i], self.body_graphs[i])

    def _step(self, step, rebin) -> None:
        new, aux = step(self.leaves, self.ref, self.caches, rebin)
        for dst, src in zip(self.leaves, new):
            dst.copy_(src)
        if self.aux is None:
            self.aux = {}
            for f in self.aux_fields:
                v = getattr(aux, f)
                self.aux[f] = (
                    torch.zeros((self.n_max, *v.shape), dtype=v.dtype,
                                device=self.index.device)
                    if torch.is_tensor(v) else
                    torch.zeros((self.n_max,), dtype=torch.int32,
                                device=self.index.device))
        for f in self.aux_fields:
            v = getattr(aux, f)
            if torch.is_tensor(v):
                self.aux[f].index_copy_(0, self.index, v.unsqueeze(0))
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
        into every cache (each block starts from a fresh binning, as each
        gs2d_tpu scan does), rewind the aux index and start the summed
        field from zero (a fill on the device, no copy from the host) or
        from ``total``."""
        for dst, src in zip(self.leaves, leaves):
            dst.copy_(src)
        self.ref.copy_(ref)
        for i in range(len(self.caches)):
            self._refresh_cache(i)
        self.index.zero_()
        if self.total is not None:
            if total is None:
                self.total.zero_()
            else:
                self.total.copy_(total)

    def run(self, leaves, ref: torch.Tensor, n: int,
            total: Optional[torch.Tensor] = None):
        """``n`` replays from ``leaves`` (the summed field from ``total``,
        or zero): (new leaves, {field: (n, ...) aux}, the sum or None),
        copies that later runs do not overwrite. No host work runs between
        the replays."""
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


class BlockRunner:
    """Blocks of ``n`` steps of a step body (``StepGraph``'s ``step``, with
    its ``make_caches``, ``aux_fields`` and ``summed``): ``runner(leaves,
    ref, n, total=None) -> (leaves, {field: (n, ...) aux}, the sum or
    None)``, every cache binned afresh from ``leaves`` at the start.

    On CUDA tensors one captured ``StepGraph`` is replayed ``n`` times
    (captured at the first call and again when ``n`` exceeds its aux
    buffers; ``graph`` is the latest, ``captures`` counts them); a capture
    that fails raises. On the CPU the same body runs in a Python loop. The
    runner keeps ``step`` and ``make_caches`` to capture again, so neither
    may name the object that holds the runner: that would be a reference
    cycle, which the garbage collector may free, graph and all, in the
    middle of a later capture, where CUDA forbids destroying a graph."""

    def __init__(self, step: Callable, make_caches: Sequence[Callable] = (),
                 aux_fields=(), summed: Optional[str] = None):
        self.step, self.make_caches = step, list(make_caches)
        self.aux_fields, self.summed = tuple(aux_fields), summed
        self.graph = None
        self.captures = 0

    def __call__(self, leaves, ref: torch.Tensor, n: int,
                 total: Optional[torch.Tensor] = None):
        if leaves[0].is_cuda:
            if self.graph is None or n > self.graph.n_max:
                self.graph = StepGraph(self.step, self.make_caches, leaves,
                                       ref, n, self.aux_fields, self.summed)
                self.captures += 1
            return self.graph.run(leaves, ref, n, total)
        makes = self.make_caches
        caches = [make(leaves) for make in makes]
        auxes, acc = [], None
        for _ in range(n):
            def rebin(i, pred, at=leaves):
                if bool(pred):
                    caches[i][:] = makes[i](at)

            leaves, aux = self.step(leaves, ref, caches, rebin)
            auxes.append(aux)
            if self.summed is not None:
                v = getattr(aux, self.summed)
                if acc is None:
                    acc = torch.zeros_like(v) if total is None \
                        else total.clone()
                acc.add_(v)
        return leaves, {f: torch.stack([
            v if torch.is_tensor(v) else torch.tensor(v, dtype=torch.int32)
            for v in (getattr(a, f) for a in auxes)])
            for f in self.aux_fields}, acc
