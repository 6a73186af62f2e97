"""Smoke run of the PyTorch port on one NVIDIA GPU: build the CUDA kernels,
hold each against its plain PyTorch version, then drive the two fitting
paths through them with the CLI and check their MSE trajectories:

- the default fit, resident layout (squirrel_cls_mini 268x213, 1024 splats,
  L2, 200 iterations; kernels 1 and 2);
- the 10 240-splat fit, flat layout (squirrel_cls 535x426, 200 iterations;
  kernels 10 and 11).

    python3 chip_smoke.py

Prints one line per phase; the line before the last is the kernels' JSON
report and the last is {"ok": true, "device": {...}}. Any failure raises
and the script exits non-zero without printing a result; without a CUDA
GPU it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MINI = os.path.join(ROOT, "assets", "squirrel_cls_mini.npy")
FULL = os.path.join(ROOT, "assets", "squirrel_cls.npy")

# MSE-255 of the 50th and 200th step's render on the default workload, the
# JAX package's and the C++ reference's shared trajectory (BASELINE.md).
TRAJECTORY = {49: 431.6, 199: 109.18}
TRAJECTORY_RTOL = 1e-3
# MSE-255 of the 10 240-splat fit at iterations 0, 1 and 9 (rel tolerance
# beside each): the JAX package's scan renderer on the same pcg3d init and
# target, on a CPU, from
#   JAX_PLATFORMS=cpu python -m gs2d_tpu.fit assets/squirrel_cls.jpg \
#       --splats 10240 --iters 10 --renderer scan --log-every 1 \
#       --tile-h 32 --out <dir>
# Its iteration 0 agrees with runs/showcase_10k_r5/metrics.jsonl (6072.7031).
# Later steps get no gate: the trajectory is chaotic at the 0.1% level over
# hundreds of steps (PERF.md section 7).
TRAJECTORY_10K = {0: (6072.7041, 1e-4), 1: (4645.9102, 1e-4),
                  9: (775.3411, 1e-3)}
N_10K = 10240
COLOR_ATOL = 1e-6   # same per-pixel float32 program; sums in one order
GRAD_RTOL = 1e-4    # of max(1, |moment row| max): the moments' sum order


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_lines() -> tuple:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return name, smi


def population(seed: int, n: int, width: int, height: int,
               opacity=(0.3, 1.0)) -> dict:
    rng = np.random.default_rng(seed)
    d = {"pos": np.stack([rng.uniform(-3, width + 3, n),
                          rng.uniform(-3, height + 3, n)], -1),
         "sx": rng.uniform(1.5, 12.0, n), "sy": rng.uniform(1.5, 12.0, n),
         "rot": rng.uniform(0.0, np.pi, n),
         "color": rng.uniform(0.0, 1.0, (n, 3)),
         "opacity": rng.uniform(*opacity, n)}
    return {k: v.astype(np.float32) for k, v in d.items()}


def compare_case(name, params, ref, cfg, dev, timed: bool):
    """Kernels 1 and 2 vs their plain versions on one population. Returns
    ({kernel: max_abs_err}, {kernel: (ms, plain_ms)} or None)."""
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_resident as rr
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import FIELDS

    n, k = params.n, cfg.max_splats_per_tile
    b = tl.bin_splats(params, cfg, k, ids_only=True)
    if int(b.n_dropped):
        raise AssertionError(f"{name}: binning dropped {int(b.n_dropped)}")
    table = rr.resident_table(params, cfg)
    ids = rr._remap_ids(b, n)
    ref_chw = rd.pad_ref_chw(ref, cfg, dev)

    c_k, g_k = rr._l2_resident_cuda(table, ids, b.count, ref_chw, n, cfg)
    c_p, g_p = rr._l2_resident_plain(table, ids, b.count, ref_chw, n, cfg)
    f_k, t_k = rr._fwd_resident_cuda(table, ids, b.count, cfg)
    f_p, t_p = rr._fwd_resident_plain(table, ids, b.count, cfg)
    torch.cuda.synchronize()
    for what, x in (("color", c_k), ("moments", g_k), ("fwd color", f_k),
                    ("T", t_k)):
        if not torch.isfinite(x).all():
            raise AssertionError(f"{name}: non-finite kernel {what}")
    col_err = float((c_k - c_p).abs().max())
    mom_err = (g_k - g_p).abs().max(dim=1).values
    mom_tol = GRAD_RTOL * torch.clamp(g_p.abs().max(dim=1).values, min=1.0)
    fwd_err = max(float((f_k - f_p).abs().max()),
                  float((t_k - t_p).abs().max()))
    # Reported error: color and the parameter gradients moments_to_grads
    # makes of the moment rows (the raw moments reach ~1e4 in magnitude).
    fields = rr._table_fields(table, n)
    g_kernel = rd.moments_to_grads(rd.unpack_moments(g_k, n), fields)
    g_plain = rd.moments_to_grads(rd.unpack_moments(g_p, n), fields)
    grad_err = max(float((getattr(g_kernel, f) - getattr(g_plain, f))
                         .abs().max()) for f in FIELDS)
    grad_max = max(float(getattr(g_plain, f).abs().max()) for f in FIELDS)
    log(f"  {name}: N={n} K={k} tiles={cfg.n_tiles_y}x{cfg.n_tiles_x} "
        f"max_count={int(b.count.max())} | l2: color err {col_err:.3g} "
        f"(tol {COLOR_ATOL}), moment err/tol max "
        f"{float((mom_err / mom_tol).max()):.3g}, grad err {grad_err:.3g} "
        f"of |grad| max {grad_max:.3g} "
        f"| fwd err {fwd_err:.3g} (tol {COLOR_ATOL})")
    if col_err > COLOR_ATOL or bool((mom_err > mom_tol).any()) \
            or fwd_err > COLOR_ATOL:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    errs = {"l2_resident": max(col_err, grad_err), "fwd_resident": fwd_err}
    if not timed:
        return errs, None
    times = {
        "l2_resident": (
            cuda_ms(lambda: rr._l2_resident_cuda(table, ids, b.count,
                                                 ref_chw, n, cfg), 50),
            cuda_ms(lambda: rr._l2_resident_plain(table, ids, b.count,
                                                  ref_chw, n, cfg), 3)),
        "fwd_resident": (
            cuda_ms(lambda: rr._fwd_resident_cuda(table, ids, b.count,
                                                  cfg), 50),
            cuda_ms(lambda: rr._fwd_resident_plain(table, ids, b.count,
                                                   cfg), 3)),
    }
    return errs, times


def compare_flat_case(name, params, ref, cfg, dev, carry=None,
                      g_color=None, timed=False):
    """Kernels 10 and 11 vs their plain versions on one population, with the
    flat statics tuned from it. The backward replays from ``carry`` (C_in
    (3, Hp, Wp), T_in (Hp, Wp); identity when None) under ``g_color``
    (3, Hp, Wp; the L2 cotangent C - ref when None). Kernel 11 runs twice
    and must repeat bit for bit. Returns ({kernel: max_abs_err},
    {kernel: (ms, plain_ms)} or None)."""
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.ops import tiles_flat as tlf
    from gs2d_tpu_torch.params import FIELDS

    n = params.n
    cfg = rf.tune_flat_config(params, cfg)
    m_cap, kc, mc = cfg.flat_capacity, cfg.flat_chunk, cfg.flat_max_chunks
    b = tlf.bin_splats_flat(params, cfg, m_cap, kc=kc, max_chunks=mc)
    if int(b.n_dropped):
        raise AssertionError(f"{name}: binning dropped {int(b.n_dropped)}")
    fwd_in = (b.rows, b.start, b.count, cfg, kc, mc)
    c_k, t_k = rf._fwd_flat_cuda(*fwd_in)
    c_p, t_p = rf._fwd_flat_plain(*fwd_in)
    if g_color is None:
        g_color = c_p - rd.pad_ref_chw(ref, cfg, dev)[0]
    cin, tin = carry if carry is not None else rf._identity_carry(cfg, dev)
    bwd_in = (b.rows, b.ids, b.start, b.count, c_p, g_color.contiguous(),
              cin, tin, n, cfg, kc, mc)
    m_k, g_k = rf._bwd_flat_cuda(*bwd_in)
    m_k2, g_k2 = rf._bwd_flat_cuda(*bwd_in)
    m_p, g_p = rf._bwd_flat_plain(*bwd_in)
    torch.cuda.synchronize()
    for what, x in (("color", c_k), ("T", t_k), ("moments", m_k),
                    ("splat moments", g_k)):
        if not torch.isfinite(x).all():
            raise AssertionError(f"{name}: non-finite kernel {what}")
    if not (torch.equal(m_k, m_k2) and torch.equal(g_k, g_k2)):
        raise AssertionError(f"{name}: bwd_flat does not repeat bit for bit")
    fwd_err = max(float((c_k - c_p).abs().max()),
                  float((t_k - t_p).abs().max()))
    ratios = []
    for got, want in ((m_k, m_p), (g_k.T, g_p.T)):  # per moment field
        tol = GRAD_RTOL * torch.clamp(want.abs().max(dim=0).values, min=1.0)
        ratios.append(float(((got - want).abs().max(dim=0).values
                             / tol).max()))
    fields = tl.packed_fields(params, cfg.splat_bounds)
    g_kernel = rd.moments_to_grads(rd.unpack_moments(g_k, n), fields)
    g_plain = rd.moments_to_grads(rd.unpack_moments(g_p, n), fields)
    grad_err = max(float((getattr(g_kernel, f) - getattr(g_plain, f))
                         .abs().max()) for f in FIELDS)
    grad_max = max(float(getattr(g_plain, f).abs().max()) for f in FIELDS)
    log(f"  {name}: N={n} tile {cfg.tile_h}x{cfg.tile_w} "
        f"tiles={cfg.n_tiles_y}x{cfg.n_tiles_x} kc={kc} M={m_cap} "
        f"max_chunks={mc} max_count={int(b.count.max())} "
        f"sat_walk={rd._sat_walk(cfg)} max T={float(t_p.max()):.3g} | "
        f"fwd err {fwd_err:.3g} (tol {COLOR_ATOL}) | bwd: pair-moment "
        f"err/tol {ratios[0]:.3g}, splat-moment err/tol {ratios[1]:.3g}, "
        f"grad err {grad_err:.3g} of |grad| max {grad_max:.3g}, repeats "
        "bit for bit")
    if fwd_err > COLOR_ATOL or max(ratios) > 1.0:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    errs = {"fwd_flat": fwd_err, "bwd_flat": grad_err}
    if not timed:
        return errs, None
    times = {
        "fwd_flat": (cuda_ms(lambda: rf._fwd_flat_cuda(*fwd_in), 50),
                     cuda_ms(lambda: rf._fwd_flat_plain(*fwd_in), 2)),
        "bwd_flat": (cuda_ms(lambda: rf._bwd_flat_cuda(*bwd_in), 50),
                     cuda_ms(lambda: rf._bwd_flat_plain(*bwd_in), 2)),
    }
    return errs, times


def opaque_stack(seed: int, n: int, width: int, height: int) -> dict:
    """n large opaque splats over the whole image: every tile saturates
    early in its list (the case of tests/test_saturation.py)."""
    rng = np.random.default_rng(seed)
    d = {"pos": np.stack([rng.uniform(0.2 * width, 0.8 * width, n),
                          rng.uniform(0.2 * height, 0.8 * height, n)], -1),
         "sx": np.full(n, 0.5 * width), "sy": np.full(n, 0.5 * height),
         "rot": rng.uniform(0.0, np.pi, n),
         "color": rng.uniform(0.0, 1.0, (n, 3)), "opacity": np.ones(n)}
    return {k: v.astype(np.float32) for k, v in d.items()}


def compare_flat(dev, name: str, smi: str):
    """All flat compare cases; returns (max errors, the 10k case's times)."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.ops import tiles_flat as tlf
    from gs2d_tpu_torch.params import init_params, params_from_numpy

    log("[compare] flat kernels vs plain PyTorch on the card")
    errs = {"fwd_flat": 0.0, "bwd_flat": 0.0}

    def add(e):
        for kk in errs:
            errs[kk] = max(errs[kk], e[kk])

    mini = load_image(MINI)
    h, w = mini.shape[:2]
    cfg = SplatConfig(width=w, height=h, n_splats=600, tile_h=32,
                      flat_chunk=32, binning="flat")
    p_rand = params_from_numpy(population(10, 600, w, h), dev)
    add(compare_flat_case("random, kc=32", p_rand, mini, cfg, dev)[0])
    p1 = population(11, 300, w, h, opacity=(1.0, 1.0))
    p1["pos"][:64] = np.floor(p1["pos"][:64]) + 0.5
    add(compare_flat_case("opacity-1 centred", params_from_numpy(p1, dev),
                          mini, cfg.replace(n_splats=300), dev)[0])
    # A prefix from another population as the carry-in, and a random
    # upstream cotangent.
    cfg_c = cfg.replace(n_splats=400, flat_chunk=64)
    p_pre = params_from_numpy(population(12, 400, w, h), dev)
    pre = rf.tune_flat_config(p_pre, cfg_c)
    b_pre = tlf.bin_splats_flat(p_pre, pre, pre.flat_capacity,
                                kc=pre.flat_chunk,
                                max_chunks=pre.flat_max_chunks)
    carry = rf._fwd_flat_plain(b_pre.rows, b_pre.start, b_pre.count, pre,
                               pre.flat_chunk, pre.flat_max_chunks)
    g_rand = torch.randn((3, cfg_c.padded_height, cfg_c.padded_width),
                         generator=torch.Generator(dev).manual_seed(13),
                         device=dev)
    add(compare_flat_case(
        "carry-in + random cotangent", params_from_numpy(
            population(14, 400, w, h), dev), mini, cfg_c, dev,
        carry=carry, g_color=g_rand)[0])
    # 64-row tiles, every tile saturated early, the saturating walk forced.
    threshold = rd.SAT_WALK_THRESHOLD
    rd.SAT_WALK_THRESHOLD = 1
    try:
        cfg64 = SplatConfig(width=w, height=h, n_splats=256, tile_h=64,
                            binning="flat")
        add(compare_flat_case("saturated, 64-row tiles, walk forced",
                              params_from_numpy(opaque_stack(15, 256, w, h),
                                                dev), mini, cfg64, dev)[0])
    finally:
        rd.SAT_WALK_THRESHOLD = threshold
    full = load_image(FULL)
    h, w = full.shape[:2]
    cfg_main = SplatConfig(width=w, height=h, n_splats=N_10K)
    p_init = init_params(cfg_main, dev)
    cfg_main = tl.tune_tile_height(cfg_main, p_init)
    e, times = compare_flat_case("pcg3d init 10240 on 535x426 (main path)",
                                 p_init, full, cfg_main, dev, timed=True)
    add(e)
    for kk, (ms, pms) in times.items():
        log(f"  {kk} at the main path's shapes: kernel {ms:.4f} ms, plain "
            f"{pms:.2f} ms [{name}, {smi}]")
    return errs, times


def run_cli(argv) -> str:
    from gs2d_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli exited {rc}: {buf.getvalue()[-2000:]}")
    return buf.getvalue()


def check_mse(mse: dict, it: int, want: float, rtol: float) -> None:
    rel = abs(mse[it] - want) / want
    log(f"  MSE-255 @ {it + 1}: {mse[it]:.4f} (reference {want}, rel "
        f"{rel:.2e}, tol {rtol})")
    if rel > rtol:
        raise AssertionError(f"MSE @ {it + 1} off the reference")


def fit_phase(image: str, splats: int, name: str, smi: str):
    """The CLI's 200-iteration fit of ``image``: once logged at every step
    (launch counts and the MSE trajectory), then 5 timed runs without a
    per-step sync. Returns (launches, {iter: mse}, it/s of the timed
    runs)."""
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import render_resident as rr

    argv = [image, "--splats", str(splats), "--iters", "200", "--device",
            "cuda"]
    log(f"[fit] python -m gs2d_tpu_torch.fit {os.path.basename(image)} "
        f"{' '.join(argv[1:])}")
    with tempfile.TemporaryDirectory() as out:
        rr.reset_launch_counts()
        rf.reset_launch_counts()
        run_cli(argv + ["--log-every", "1", "--out", out])
        launches = {**rr.launches, **rf.launches}
        recs = [json.loads(x) for x in
                open(os.path.join(out, "metrics.jsonl")).read().splitlines()]
        mse = {r["iter"]: r["mse"] for r in recs if "iter" in r}
        done = [r for r in recs if r.get("event") == "done"][0]
        png = os.path.getsize(os.path.join(out, "render_final.png"))
    log(f"  launches: {launches}; render_final.png {png} bytes")
    if len(mse) != 200 or not all(np.isfinite(list(mse.values()))):
        raise AssertionError("trajectory incomplete or non-finite")
    log(f"  logged run (sync every step): {done['iters_per_s']:.1f} it/s")
    rates = []
    for _ in range(5):
        with tempfile.TemporaryDirectory() as out:
            run_cli(argv + ["--log-every", "0", "--out", out])
            rates.append([json.loads(x) for x in open(os.path.join(
                out, "metrics.jsonl")).read().splitlines()][-1]
                ["iters_per_s"])
    q1, med, q3 = np.percentile(rates, [25, 50, 75])
    log(f"  timed runs (5 x 200 iters, no per-step sync): it/s "
        f"{', '.join(f'{r:.2f}' for r in rates)}; median {med:.2f} "
        f"(quartiles {q1:.2f}-{q3:.2f}) = {1e3 / med:.3f} ms/step "
        f"[{name}, {smi}]")
    return launches, mse, rates


def step_profile(cfg, image: str, dev, step_ms: float,
                 steps: int = 20) -> str:
    """Device time per step by kernel over a steady window of the train
    step on ``image``, from torch.profiler; the idle share is taken against
    ``step_ms``, the step time of an unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.train.loop import (init_train_state,
                                           make_train_step_fused)

    state = init_train_state(cfg, dev)
    step = make_train_step_fused(cfg)
    ref_chw = rd.pad_ref_chw(load_image(image), cfg, dev)
    for _ in range(5):
        state, _ = step(state, ref_chw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step(state, ref_chw)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    rows = []
    total = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed themselves
        dt = ev.self_device_time_total / steps / 1e3
        rows.append((dt, ev.count // steps, ev.key))
        total += dt
    rows.sort(reverse=True)
    lines = [f"  device busy {total:.4f} ms/step over {steps} steps; "
             f"unprofiled step {step_ms:.4f} ms, idle share "
             f"{max(0.0, 1 - total / step_ms):.3f} (profiled step wall "
             f"{wall_ms:.3f} ms)"]
    lines += [f"    {ms:.4f} ms/step x{cnt}: {key[:70]}"
              for ms, cnt, key in rows[:8]]
    if not rows:
        lines.append("    profiler saw no device time")
    return "\n".join(lines)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        return 1
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import _build
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import init_params, params_from_numpy

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, smi = device_lines()
    log(f"[device] {name} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | count {torch.cuda.device_count()}")
    log(smi)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.2f}s")
    ptxas = lib_path.with_suffix(".log").read_text() \
        if lib_path.with_suffix(".log").exists() else ""
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- kernels vs plain versions ------------------------------------------
    ref = load_image(MINI)
    h, w = ref.shape[:2]
    cfg = SplatConfig(width=w, height=h, n_splats=1024, tile_h=32,
                      max_splats_per_tile=512)
    log("[compare] kernels vs plain PyTorch on the card")
    errs = {"l2_resident": 0.0, "fwd_resident": 0.0}
    p_rand = params_from_numpy(population(0, 1024, w, h), dev)
    e, times = compare_case("random 268x213", p_rand, ref, cfg, dev,
                            timed=True)
    errs = {kk: max(errs[kk], e[kk]) for kk in errs}
    cfg130 = cfg.replace(n_splats=130, max_splats_per_tile=128)
    e, _ = compare_case("random N=130", params_from_numpy(
        population(1, 130, w, h), dev), ref, cfg130, dev, timed=False)
    errs = {kk: max(errs[kk], e[kk]) for kk in errs}
    # alpha == 1 at a pixel centre: opacity 1, centred on (x + .5, y + .5).
    p1 = population(2, 64, w, h, opacity=(1.0, 1.0))
    p1["pos"][:16] = np.floor(p1["pos"][:16]) + 0.5
    cfg64 = cfg.replace(n_splats=64, max_splats_per_tile=64)
    e, _ = compare_case("opacity-1 centred", params_from_numpy(p1, dev), ref,
                        cfg64, dev, timed=False)
    errs = {kk: max(errs[kk], e[kk]) for kk in errs}
    p_init = init_params(cfg.replace(max_splats_per_tile=None), dev)
    cfg_main = tl.tune_tile_capacity(p_init, cfg.replace(
        max_splats_per_tile=None))
    e, main_times = compare_case("pcg3d init (main path)", p_init, ref,
                                 cfg_main, dev, timed=True)
    errs = {kk: max(errs[kk], e[kk]) for kk in errs}
    for kk, (ms, pms) in main_times.items():
        log(f"  {kk} at the main path's shapes "
            f"(K={cfg_main.max_splats_per_tile}): kernel {ms:.4f} ms, "
            f"plain {pms:.2f} ms [{name}, {smi}]")
    for kk, (ms, pms) in times.items():
        log(f"  {kk} on the random 1024 population: kernel {ms:.4f} ms, "
            f"plain {pms:.2f} ms")

    flat_errs, flat_times = compare_flat(dev, name, smi)

    # ---- main paths: the CLI's fits -----------------------------------------
    launches, mse, rates = fit_phase(MINI, 1024, name, smi)
    if launches["l2_resident"] != 200 or launches["fwd_resident"] < 1 \
            or launches["fwd_flat"] or launches["bwd_flat"]:
        raise AssertionError(f"resident path bypassed a kernel: {launches}")
    for it, want in TRAJECTORY.items():
        check_mse(mse, it, want, TRAJECTORY_RTOL)
    log("[profile] resident train step, 20 steps")
    log(step_profile(cfg_main, MINI, dev,
                     1e3 / float(np.median(rates))))
    resident_launches = launches

    flat_launches, mse, rates = fit_phase(FULL, N_10K, name, smi)
    if flat_launches["fwd_flat"] != 201 or flat_launches["bwd_flat"] != 200 \
            or flat_launches["l2_resident"] \
            or flat_launches["fwd_resident"]:
        raise AssertionError(f"flat path bypassed a kernel: {flat_launches}")
    for it, (want, rtol) in TRAJECTORY_10K.items():
        check_mse(mse, it, want, rtol)
    log(f"  MSE-255 @ 200: {mse[199]:.4f} (no gate)")
    full = load_image(FULL)
    cfg_10k = SplatConfig(width=full.shape[1], height=full.shape[0],
                          n_splats=N_10K)
    p0 = init_params(cfg_10k, dev)
    cfg_10k = rf.tune_flat_config(p0, tl.tune_tile_height(cfg_10k, p0))
    log("[profile] flat train step, 20 steps")
    log(step_profile(cfg_10k, FULL, dev, 1e3 / float(np.median(rates))))

    report = {"kernels": [
        {"name": "l2_resident", "route": "cuda",
         "source": "gs2d_tpu_torch/csrc/render_resident.cu",
         "replaces": "gs2d_tpu/ops/render_pallas_resident.py:88",
         "launches": resident_launches["l2_resident"],
         "max_abs_err": errs["l2_resident"],
         "ms": main_times["l2_resident"][0],
         "plain_ms": main_times["l2_resident"][1]},
        {"name": "fwd_resident", "route": "cuda",
         "source": "gs2d_tpu_torch/csrc/render_resident.cu",
         "replaces": "gs2d_tpu/ops/render_pallas_resident.py:267",
         "launches": resident_launches["fwd_resident"],
         "max_abs_err": errs["fwd_resident"],
         "ms": main_times["fwd_resident"][0],
         "plain_ms": main_times["fwd_resident"][1]},
        {"name": "fwd_flat", "route": "cuda",
         "source": "gs2d_tpu_torch/csrc/render_flat.cu",
         "replaces": "gs2d_tpu/ops/render_pallas_flat.py:227",
         "launches": flat_launches["fwd_flat"],
         "max_abs_err": flat_errs["fwd_flat"],
         "ms": flat_times["fwd_flat"][0],
         "plain_ms": flat_times["fwd_flat"][1]},
        {"name": "bwd_flat", "route": "cuda",
         "source": "gs2d_tpu_torch/csrc/render_flat.cu",
         "replaces": "gs2d_tpu/ops/render_pallas_flat.py:265",
         "launches": flat_launches["bwd_flat"],
         "max_abs_err": flat_errs["bwd_flat"],
         "ms": flat_times["bwd_flat"][0],
         "plain_ms": flat_times["bwd_flat"][1]},
    ]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
