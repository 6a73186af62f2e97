"""What decides ``correct``: numbers that compare what the timed path
produced with the plain reference (``benchmark/reference/splats.py``), each
against a limit of its own (``benchmark/limits/<workload>.json``). The
traffic's ``kind`` names the comparison:

``frames`` (renders): the frames the session's reservoir kept, a uniform
sample of the window's frames drawn from the seed. Each is compared with
the reference's composite of the population it rendered: ``mean_gap``, the
worst frame's mean absolute difference over its pixels and channels, and
``pixel_gap``, the largest absolute difference of any pixel. ``dropped``
counts the splat-tile pairs that any frame of the window lost to the
binning's capacity, which the reference never drops (exact limit 0).

``jobs`` (fits handed out one by one): a sample of the window's jobs drawn
from the seed. Each sampled job's population is fitted again, after the
window, through the same ``train.loop.fit`` entry with the job's own tuned
statics: one step, then two more from the state it returned. The
reference fits the same population for three steps. Compared, each the
worst over the sampled jobs: ``loss_gap``, the relative gap of each step's
MSE; ``grad_gap``, the first gradient as Adam got it (its first moment
after one step over 1 - beta1); ``change_gap``, the parameters' change over
the three steps; both by the worst leaf, the gap between the program's and
the reference's norms over the reference leaf's norm or the median leaf's,
whichever is larger (opacity, which the configuration does not optimise,
is left out of the gradient). Later steps are not compared: Adam's first
steps move each parameter by about the learning rate whatever its
gradient's size, so two sound float32 fits drift apart by rounding from
the fourth step on. ``dropped`` counts the pairs the window's jobs
reported dropped (their logged steps and their overflow warnings).
"""

from __future__ import annotations

import json
import os
import re
import statistics

import numpy as np
import torch

from lib import inputs
from reference import splats as ref_lib

FIELDS = inputs.FIELDS
_OVERFLOW = re.compile(r"binning capacity overflow at iteration \d+: (\d+) "
                       r"splat-tile pairs dropped")


def settings(config: dict, tile_h: int,
             dtype=torch.float32) -> ref_lib.Settings:
    return ref_lib.Settings(
        width=config["width"], height=config["height"], tile_h=tile_h,
        dtype=dtype, optimize_opacity=config.get("optimize_opacity", False))


def rel_gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / abs(ref)


def norm_gap(prog: dict, ref: dict, leaves) -> float:
    """The worst leaf's |norm(prog) - norm(ref)| over the larger of the
    reference leaf's norm and the median leaf's."""
    pn, rn = ref_lib.leaf_norms(prog), ref_lib.leaf_norms(ref)
    med = statistics.median(rn[f] for f in leaves)
    return max(abs(pn[f] - rn[f]) / max(rn[f], med, 1e-30) for f in leaves)


def reference_steps(p0: dict, target, s: ref_lib.Settings, n: int):
    """n reference steps from p0: (MSEs, first gradients, final params)."""
    state = ref_lib.init_state(p0)
    mses, g1 = [], None
    for i in range(n):
        state, mse, grads = ref_lib.step(state, target, s)
        mses.append(mse)
        if i == 0:
            g1 = grads
    return mses, g1, state["params"]


def saturated(p: dict, s: ref_lib.Settings) -> int:
    """Splats whose alpha is exactly 1 at the pixel centre nearest them (a
    diagnostic: there the suffix colour over 1 - alpha is 0 / 0)."""
    a, b, d, _, _ = ref_lib.geometry(p["sx"], p["sy"], p["rot"], s.bounds)
    v = torch.floor(p["pos"]) + 0.5 - p["pos"]
    vx, vy = v[:, 0], v[:, 1]
    d2 = a * vx * vx + 2.0 * b * vx * vy + d * vy * vy
    y = 1.0 + (-0.5 * d2) * 0.125
    y = y * y
    y = y * y
    return int((y * y * p["opacity"] >= 1.0).sum())


def describe(name: str, prog: dict, ref: dict, log) -> None:
    """One line a leaf: both norms and the element that differs most."""
    for f in prog:
        p, r = prog[f].double(), ref[f].double()
        d = (p - r).abs().reshape(-1)
        i = int(d.argmax())
        log(f"{name} {f}: norm {float(p.norm()):.7g} / ref "
            f"{float(r.norm()):.7g}; worst element {i}: "
            f"{float(p.reshape(-1)[i]):.7g} / ref {float(r.reshape(-1)[i]):.7g}")


def first_steps(sess, index: int, cfg) -> dict:
    """Population ``index`` fitted for three steps through the session's
    own fit call: one step, then two from the state it returned."""
    state = sess.fresh_state(sess.population(index))
    p0 = {f: getattr(state.params, f).detach().clone() for f in FIELDS}
    state, h1 = sess.fit(state, cfg, 1, 1, [])
    m1 = {f: getattr(state.opt.m, f).detach().clone() for f in FIELDS}
    state, h2 = sess.fit(state, cfg, 2, 1, [])
    p3 = {f: getattr(state.params, f).detach().clone() for f in FIELDS}
    return {"p0": p0, "m1": m1, "p3": p3,
            "mses": [r["mse"] for r in h1 + h2]}


def compare_steps(steps: dict, target, s: ref_lib.Settings,
                  log=None) -> dict:
    """The three numbers of one fit's first three steps."""
    mses_r, g_r, p3_r = reference_steps(steps["p0"], target, s, 3)
    one_b1 = float(np.float32(1.0) - np.float32(s.beta1))
    g_p = {f: steps["m1"][f] / one_b1 for f in FIELDS}
    moved = [f for f in FIELDS if f != "opacity" or s.optimize_opacity]
    d_p = {f: steps["p3"][f] - steps["p0"][f] for f in FIELDS}
    d_r = {f: p3_r[f] - steps["p0"][f] for f in FIELDS}
    if log:
        describe("gradient", g_p, g_r, log)
        describe("change", d_p, d_r, log)
    return {"loss_gap": max(rel_gap(float(p), r)
                            for p, r in zip(steps["mses"], mses_r)),
            "grad_gap": norm_gap(g_p, g_r, moved),
            "change_gap": norm_gap(d_p, d_r, FIELDS)}


def sample(n_total: int, seed: int, n: int) -> list:
    rng = np.random.default_rng(inputs.derive(seed, 3))
    n = min(n, n_total)
    return sorted(rng.choice(n_total, size=n, replace=False).tolist())


def jobs(sess, calls: list, seed: int, log=None) -> dict:
    """The ``jobs`` numbers of a sample of the window's jobs."""
    log = log or (lambda m: None)
    worst = {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
    for c in sample(len(calls), seed, sess.traffic["check_jobs"]):
        call = calls[c]
        s = settings(sess.config, call["cfg"].tile_h)
        steps = first_steps(sess, call["k"] + 1, call["cfg"])
        nums = compare_steps(steps, sess.target, s)
        log(f"job {call['k']}: saturated splats "
            f"{saturated(steps['p0'], s)}, " + ", ".join(
                f"{k} {v:.4g}" for k, v in nums.items()))
        worst = {k: max(worst[k], nums[k]) for k in worst}
    records = [r for x in calls for r in x["history"]]
    warned = [int(m.group(1)) for x in calls for line in x["logs"]
              for m in [_OVERFLOW.search(line)] if m]
    worst["dropped"] = float(sum(int(r.get("n_dropped", 0))
                                 for r in records) + sum(warned))
    return worst


def frames(sess, calls: list, seed: int, log=None) -> dict:
    """The ``frames`` numbers of the frames the session kept."""
    log = log or (lambda m: None)
    s = settings(sess.config, sess.cfg.tile_h)
    refs = {}
    mean_gap = pixel_gap = 0.0
    for frame, index, img in sorted(sess.kept, key=lambda x: x[0]):
        if index not in refs:
            with torch.no_grad():
                refs[index] = ref_lib.composite(sess.pool[index], s)[0]
        d = (img.float() - refs[index]).abs()
        mean_gap = max(mean_gap, float(d.double().mean()))
        pixel_gap = max(pixel_gap, float(d.max()))
        log(f"frame {frame} (population {index}): mean gap "
            f"{float(d.double().mean()):.4g}, pixel gap {float(d.max()):.4g}")
    dropped = float(torch.stack(sess.dropped).sum()) if sess.dropped else 0.0
    if not sess.kept:
        mean_gap = pixel_gap = float("nan")
    return {"mean_gap": mean_gap, "pixel_gap": pixel_gap,
            "dropped": dropped}


CHECKS = {"jobs": jobs, "render": frames}


def limits(workload: str) -> dict:
    path = os.path.join("benchmark", "limits", f"{workload}.json")
    with open(path) as f:
        return json.load(f)


def judge(numbers: dict, lim: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number within its
    limit, and a limit for every number."""
    table, ok = {}, True
    for name, value in numbers.items():
        limit = lim.get(name)
        good = limit is not None and value == value and value <= limit
        ok &= good
        table[name] = {"value": value, "limit": limit}
    return ok, table
