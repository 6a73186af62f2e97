"""The reference put in the program's place: a stand-in for the program's
``train.loop.fit`` that runs ``reference.splats`` steps, and for its
forward render that runs the reference's composite, each in ``dtype``, so
that the whole harness, check included, can be driven with it. With
bfloat16 it is the lower-precision control, which the check has to find
incorrect; ``fault`` plants one of the faults that the check has to catch
in a fit:

- ``unchanged``: every step returns its state unchanged (the MSEs are
  those of the unchanged state);
- ``altered``: the parameters each step produces have their colours moved
  by 0.1 (clamped to [0, 1]).
"""

from __future__ import annotations

import types

import torch

from reference import splats as ref_lib

FIELDS = ref_lib.FIELDS
FAULTS = ("none", "unchanged", "altered")


def _to_ref(state) -> dict:
    o = state.opt
    return {"params": {f: getattr(state.params, f) for f in FIELDS},
            "m": {f: getattr(o.m, f) for f in FIELDS},
            "v": {f: getattr(o.v, f) for f in FIELDS},
            "b1t": float(o.beta1t), "b2t": float(o.beta2t)}


def _from_ref(prog, st: dict, step):
    loop = prog.loop
    f32 = lambda x: torch.tensor(x, dtype=torch.float32,
                                 device=st["params"]["pos"].device)
    p = prog.GaussianParams(**st["params"])
    return loop.TrainState(params=p, opt=loop.AdamState(
        m=prog.GaussianParams(**st["m"]), v=prog.GaussianParams(**st["v"]),
        beta1t=f32(st["b1t"]), beta2t=f32(st["b2t"]), step=step))


def _settings(cfg, dtype) -> ref_lib.Settings:
    return ref_lib.Settings(width=cfg.width, height=cfg.height,
                            tile_h=cfg.tile_h, dtype=dtype,
                            optimize_opacity=cfg.optimize_opacity)


def _steps(st: dict, target, s, iters: int, fault: str):
    mses = []
    for _ in range(iters):
        if fault == "unchanged":
            mses.append(ref_lib.render_mse(st["params"], target, s))
            continue
        st, mse, _ = ref_lib.step(st, target, s)
        mses.append(mse)
        if fault == "altered":
            st = dict(st, params=dict(st["params"], color=(
                st["params"]["color"] + 0.1).clamp(0, 1)))
    return st, mses


def _history(mses, iters: int, log_every: int) -> list:
    return [{"iter": i, "mse": mses[i], "n_dropped": 0} for i in range(iters)
            if log_every and (i % log_every == 0 or i == iters - 1)]


def stand_in(prog, dtype=torch.float32, fault: str = "none"):
    """A copy of the ``prog`` namespace whose fits and forward render run
    the reference."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    loop = prog.loop

    def fit(ref, cfg, iterations, device, state=None, log_every=0,
            log_fn=None, scan_chunk=0, **_):
        st, mses = _steps(_to_ref(state), ref, _settings(cfg, dtype),
                          iterations, fault)
        return (_from_ref(prog, st, state.opt.step + iterations),
                _history(mses, iterations, log_every))

    def render_frame(params, cfg):
        with torch.no_grad():
            color, _, _ = ref_lib.composite(
                {f: getattr(params, f) for f in FIELDS},
                _settings(cfg, dtype))
        return color, torch.zeros((), dtype=torch.int32,
                                  device=color.device)

    fake_loop = types.SimpleNamespace(**{
        k: getattr(loop, k) for k in dir(loop) if not k.startswith("__")})
    fake_loop.fit = fit
    return types.SimpleNamespace(**dict(vars(prog), loop=fake_loop,
                                        render_frame=render_frame))
