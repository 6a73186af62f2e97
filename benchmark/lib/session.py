"""The one generator of calls. A traffic mix (``benchmark/traffic/*.json``)
is a set of parameters of it. ``kind`` says what a call does:

- ``"jobs"``: each call is one fit of a fresh population drawn from the
  seed, as the CLI fits one image: the binning statics tuned for the
  population, ``train.loop.fit`` with ``iters_per_call``, ``scan_chunk``,
  ``rebin_margin`` and ``log_every``, the fitted parameters brought to the
  host;
- ``"render"``: each call renders ``frames_per_call`` frames, frame f the
  population f mod ``pool`` of a pool drawn from the seed in set-up
  (``color`` "uniform": each splat's colour drawn, as a fitted population
  has them), through the layout's forward render as the CLI renders its
  final image, the statics tuned once in set-up; the call ends with a
  device synchronisation. A reservoir drawn from the seed keeps
  ``check_frames`` of the window's frames, a uniform sample, for the check.

``kind`` also names what decides ``correct`` (``benchmark/lib/check.py``).
Calls are made one after another by one client (a closed loop); a call's
latency runs from handing over its inputs to its result on the host, and
its ``units`` are the image-iterations of a fit or the frames of a render.
"""

from __future__ import annotations

import random
import time

import torch

from lib import inputs
from lib import program as program_lib

FIELDS = inputs.FIELDS


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Session:
    """One cell's inputs and the program's state, driven call by call."""

    def __init__(self, prog, config: dict, traffic: dict, seed: int,
                 device):
        self.prog, self.config, self.traffic = prog, config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.kind = traffic["kind"]
        self.cfg = None
        self.target = None
        self.pool = []
        self.kept, self.dropped = [], []
        self.frames_seen = 0
        self.rng = random.Random(inputs.derive(seed, 4))
        self.phases = {}

    # -- inputs ---------------------------------------------------------
    def population(self, index: int) -> dict:
        return inputs.population(self.config, self.seed, index, self.device,
                                 self.traffic.get("color", "init"))

    def params(self, pop: dict):
        return self.prog.GaussianParams(**{f: pop[f] for f in FIELDS})

    def fresh_state(self, pop: dict):
        p = self.prog.GaussianParams(**{f: pop[f].clone() for f in FIELDS})
        return self.prog.loop.TrainState(params=p,
                                         opt=self.prog.init_adam_state(p))

    def tune(self, params):
        return program_lib.tune(self.prog, self.config, self.traffic, params)

    def fit(self, state, cfg, iters: int, log_every: int, logs: list):
        return self.prog.loop.fit(
            self.target, cfg, iters, self.device, state=state,
            scan_chunk=self.traffic.get("scan_chunk", 0),
            log_every=log_every, log_fn=logs.append)

    def start_params(self, k: int) -> list:
        """The populations call ``k`` starts from (for the work model)."""
        if self.kind == "render":
            n, fpc = len(self.pool), self.traffic["frames_per_call"]
            seen = sorted({(k * fpc + j) % n for j in range(fpc)})
            return [self.pool[i] for i in seen]
        return [self.population(k + 1)]

    # -- calls ----------------------------------------------------------
    def call(self, k: int) -> dict:
        """Call ``k`` of the window (-1: the warm-up)."""
        return self._render(k) if self.kind == "render" else self._job(k)

    def _job(self, k: int) -> dict:
        t = self.traffic
        iters = t["iters_per_call"]
        state = self.fresh_state(self.population(k + 1))
        logs = []
        t0 = time.perf_counter()
        cfg = self.tune(state.params)
        state, history = self.fit(state, cfg, iters,
                                  t.get("log_every", iters), logs)
        for f in FIELDS:
            getattr(state.params, f).cpu()
        t1 = time.perf_counter()
        return {"k": k, "t0": t0, "t1": t1, "latency_s": t1 - t0,
                "units": iters, "history": history, "logs": logs,
                "cfg": cfg}

    def _render(self, k: int) -> dict:
        fpc = self.traffic["frames_per_call"]
        t0 = time.perf_counter()
        for j in range(fpc):
            f = max(k, 0) * fpc + j
            i = f % len(self.pool)
            img, n_dropped = self.prog.render_frame(self.params(
                self.pool[i]), self.cfg)
            if k >= 0:
                self._keep(f, i, img, n_dropped)
        _sync(self.device)
        t1 = time.perf_counter()
        return {"k": k, "t0": t0, "t1": t1, "latency_s": t1 - t0,
                "units": fpc, "history": [], "logs": [], "cfg": self.cfg}

    def _keep(self, frame: int, index: int, img, n_dropped) -> None:
        """Every frame's drop count, and a reservoir sample of the frames
        (references only: nothing is copied inside the window)."""
        self.dropped.append(n_dropped)
        self.frames_seen += 1
        m = self.traffic["check_frames"]
        if len(self.kept) < m:
            self.kept.append((frame, index, img))
        else:
            r = self.rng.randrange(self.frames_seen)
            if r < m:
                self.kept[r] = (frame, index, img)

    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        """Make the inputs on the device, tune a render's statics once (a
        job tunes its own), then warm up with one whole call; ``phases``
        keeps the seconds of each."""
        t0 = time.perf_counter()
        if self.kind == "render":
            self.pool = [self.population(i)
                         for i in range(self.traffic["pool"])]
        else:
            self.target = inputs.target(self.config, self.seed, self.device)
        _sync(self.device)
        t1 = time.perf_counter()
        if self.kind == "render":
            self.cfg = self.tune(self.params(self.pool[0]))
        t2 = time.perf_counter()
        self.call(-1)
        t3 = time.perf_counter()
        self.phases = {"inputs": t1 - t0, "tune": t2 - t1,
                       "warm_up": t3 - t2}
