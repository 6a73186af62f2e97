"""Smoke run of the PyTorch port on one NVIDIA GPU: build the CUDA kernels,
hold each against its plain PyTorch version, then drive the fitting paths
through them with the CLI and check their MSE trajectories:

- the default fit, resident layout (squirrel_cls_mini 268x213, 1024 splats,
  L2, 200 iterations; kernels 1 and 2);
- the 10 240-splat fit, flat layout (squirrel_cls 535x426, 200 iterations;
  kernels 10 and 11);
- the default fit with ``--ssim 0.2``, resident layout (kernels 2 and 3),
  run twice: the second run must repeat the first bit for bit;
- the default fit with ``--binning dense`` (kernels 4/5, 6/7);
- the default fit with ``--binning dense --ssim 0.2`` (kernels 6/7, 8/9);
- the 10 240-splat fit with ``--ssim 0.2``, flat layout (kernels 10, 11).

    python3 chip_smoke.py

Prints one line per phase; the line before the last is the kernels' JSON
report and the last is {"ok": true, "device": {...}}. A kernel's
``launches`` there is its launch count summed over the paths' logged fits,
each path counted from zero; ``bound_ms`` is the least time the card could
take for the work of its timed call (see ``bound``). Any failure raises
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
# The same for the SSIM objective at lambda 0.2: the default fit, from
#   JAX_PLATFORMS=cpu python -m gs2d_tpu.fit assets/squirrel_cls_mini.jpg \
#       --splats 1024 --iters 200 --log-every 1 --renderer scan \
#       --ssim 0.2 --tile-h 32 --out <dir>
# (iterations 49 and 199 are reported, not gated), and the 10 240-splat fit
# from the same command on squirrel_cls.jpg with --splats 10240 --iters 3.
TRAJECTORY_SSIM = {0: (5934.9033, 1e-4), 1: (4691.2476, 1e-4),
                   9: (1115.1853, 1e-3)}
REPORT_SSIM = {49: 402.6315, 199: 105.2173}
TRAJECTORY_SSIM_10K = {0: (6072.7041, 1e-4), 1: (4687.6025, 1e-4),
                       2: (3544.8555, 1e-3)}
SSIM = "0.2"
N_10K = 10240
COLOR_ATOL = 1e-6   # same per-pixel float32 program; sums in one order
GRAD_RTOL = 1e-4    # of max(1, |moment row| max): the moments' sum order

# The least time the card could take for a kernel's work: the larger of its
# float32 operations over the H100's 67 TFLOP/s (outside the tensor cores)
# and its bytes (each input read once, each output written once) over
# 3.35 TB/s (NVIDIA's data sheet, SXM, 700 W). Operations are counted from
# csrc/splat_terms.cuh with each float add, subtract, multiply, divide,
# sqrt, compare, min/max, select and float-to-int conversion as one, and
# each term where it first varies:
# - ROW_OPS per (row, pair) with a live pixel: splat_terms' vy and the ellipse quadratic's
#   row interval (qb 2, qc 3 with d*vy*vy, disc 4, the root 5, kq 4, r0/r1
#   2, the bounds 6); integer bound tests not counted;
# - PIXEL_OPS per live (pixel, pair), live being covered with T above the
#   threshold (the others need no work): splat_terms' vx 1, the rest of d2
#   6, the fast exp 8, alpha 1, the T test 1;
# - FWD_OPS and BWD_OPS per live (pixel, pair) on top: fwd_one's weight,
#   colour sums and T update; bwd_one's gcdot, ga, the 1/(1 - alpha) guard,
#   dL/dalpha, the six moment sums and T update (the selects that only
#   mask dead pixels are not counted). The fused L2 kernels count
#   splat_terms once for both passes;
# - COLUMN_OPS per (column, pair) with a live pixel: Moments::finish's 3
#   products and 9 adds of the sum over the tile's columns;
# - per image pixel, the cotangent terms: 10 in the backward (gf, ga's
#   start) and 8 in the L2 kernels (gC = C - ref, gf).
# The live counts come from the plain composite of this run's inputs.
F32_PEAK = 67e12
HBM_RATE = 3.35e12
ROW_OPS = 27
PIXEL_OPS = 17
FWD_OPS = 9
BWD_OPS = 30
COLUMN_OPS = 12


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def live_work(rows, count, cfg) -> dict:
    """What a front-to-back composite from T = 1 must evaluate: the live
    (pixel, pair) evaluations ("pixels"), and the (row, pair) and (column,
    pair) counts with at least one live pixel ("rows", "columns"), summed
    over the tiles. ``rows`` (n_tiles, K, 16) holds each tile's listed
    packed rows (pad rows past its count)."""
    from gs2d_tpu_torch.ops import render as rd

    yy, xx, fy, fx, inside = rd.tile_coords(cfg, rows.device)
    T = inside.to(torch.float32)
    n = torch.zeros(3, dtype=torch.int64, device=rows.device)
    for k in range(int(count.max())):
        live, alpha, *_ = rd._splat_terms(rows[:, k], fx, fy, xx, yy, inside,
                                          T, cfg)
        live &= (k < count)[:, None, None]
        n += torch.stack([live.sum(), live.any(2).sum(), live.any(1).sum()])
        T = torch.where(live, T * (1.0 - alpha), T)
    return dict(zip(("pixels", "rows", "columns"), n.tolist()))


def bound(kind: str, work: dict, cfg, n_bytes: int):
    """(bound_ms, bound_by) of a forward ("fwd"), backward ("bwd") or fused
    L2 ("l2") kernel that does ``work`` (live_work's counts) and moves
    ``n_bytes``."""
    img = cfg.height * cfg.width
    rows = work["rows"] * ROW_OPS
    px = work["pixels"]
    cols = work["columns"] * COLUMN_OPS
    ops = {"fwd": rows + px * (PIXEL_OPS + FWD_OPS),
           "bwd": rows + px * (PIXEL_OPS + BWD_OPS) + cols + 10 * img,
           "l2": rows + px * (PIXEL_OPS + FWD_OPS + BWD_OPS) + cols
           + 8 * img}[kind]
    t_ops, t_bytes = ops / F32_PEAK, n_bytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def timed_entry(kernel, plain, kind, work, cfg, n_bytes, plain_reps=3):
    """{ms, plain_ms, bound_ms, bound_by} of one kernel at one input."""
    bound_ms, bound_by = bound(kind, work, cfg, n_bytes)
    return {"ms": cuda_ms(kernel, 50), "plain_ms": cuda_ms(plain, plain_reps),
            "bound_ms": bound_ms, "bound_by": bound_by, "work": work}


def log_times(times: dict, where: str, smi: str) -> None:
    for kk, t in times.items():
        w = t["work"]
        log(f"  {kk} {where}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.2f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}; live (pixel, pair) {w['pixels']}, (row, "
            f"pair) {w['rows']}, (column, pair) {w['columns']}), "
            f"{t['bound_ms'] / t['ms']:.5f} of the bound [{smi}]")


def moment_ratio(got, want) -> float:
    """Max over moment fields of |got - want| / (GRAD_RTOL * max(1, |field|
    max)); fields are the last axis of (rows, 9) or the first of (9+, n)."""
    if got.shape[-1] != 9:
        got, want = got[:9].T, want[:9].T
    got, want = got.reshape(-1, 9), want.reshape(-1, 9)
    tol = GRAD_RTOL * torch.clamp(want.abs().max(dim=0).values, min=1.0)
    return float(((got - want).abs().max(dim=0).values / tol).max())


def grad_error(m_k, m_p, n, fields):
    """(max |grad err|, max |grad|) of the parameter gradients that
    moments_to_grads makes of two moment arrays ((16, n_pad) or (9, n))."""
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.params import FIELDS

    g_k = rd.moments_to_grads(rd.unpack_moments(m_k, n), fields)
    g_p = rd.moments_to_grads(rd.unpack_moments(m_p, n), fields)
    return (max(float((getattr(g_k, f) - getattr(g_p, f)).abs().max())
                for f in FIELDS),
            max(float(getattr(g_p, f).abs().max()) for f in FIELDS))


def require_finite(name, **tensors):
    for what, x in tensors.items():
        if not torch.isfinite(x).all():
            raise AssertionError(f"{name}: non-finite kernel {what}")


def ssim_cotangent(color_chw, ref, cfg):
    """The SSIM objective's cotangent dL/dC at a padded (3, Hp, Wp) render:
    what autograd hands the backward kernels on the SSIM path."""
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.train.ssim import conv_flags, mixed_loss

    c = color_chw[:, : cfg.height, : cfg.width].permute(1, 2, 0)
    c = c.detach().requires_grad_()
    ref_t = torch.as_tensor(ref, dtype=torch.float32, device=c.device)
    with conv_flags():
        (g,) = torch.autograd.grad(mixed_loss(c, ref_t, float(SSIM)), c)
    return rd.pad_ref_chw(g, cfg)[0]


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
    work = live_work(table.reshape(-1, tl.N_FIELDS)[ids.long()], b.count,
                       cfg)
    base = nbytes(table, ids, b.count)
    times = {
        "l2_resident": timed_entry(
            lambda: rr._l2_resident_cuda(table, ids, b.count, ref_chw, n,
                                         cfg),
            lambda: rr._l2_resident_plain(table, ids, b.count, ref_chw, n,
                                          cfg),
            "l2", work, cfg, base + nbytes(ref_chw, c_k, g_k)),
        "fwd_resident": timed_entry(
            lambda: rr._fwd_resident_cuda(table, ids, b.count, cfg),
            lambda: rr._fwd_resident_plain(table, ids, b.count, cfg),
            "fwd", work, cfg, base + nbytes(f_k, t_k)),
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
    cin, tin = carry if carry is not None else rd.identity_carry(cfg, dev)
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
    k = torch.arange(int(b.count.max()), device=dev)
    idx = torch.where(k[None] < b.count[:, None], b.start[:, None] + k[None],
                      b.rows.shape[0])
    rows_ext = torch.cat([b.rows, tl.pad_row(dev)[None]])
    work = live_work(rows_ext[idx.long()], b.count, cfg)
    base = nbytes(b.rows, b.start, b.count)
    times = {
        "fwd_flat": timed_entry(
            lambda: rf._fwd_flat_cuda(*fwd_in),
            lambda: rf._fwd_flat_plain(*fwd_in), "fwd", work, cfg,
            base + nbytes(c_k, t_k), plain_reps=2),
        "bwd_flat": timed_entry(
            lambda: rf._bwd_flat_cuda(*bwd_in),
            lambda: rf._bwd_flat_plain(*bwd_in), "bwd", work, cfg,
            base + nbytes(b.ids, c_p, g_color, cin, tin, g_k),
            plain_reps=2),
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


def compare_flat(dev, smi: str):
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
    log_times(times, "at the 10k init", smi)
    return errs, times


def compare_bwd_resident_case(name, params, ref, cfg, dev, carry=None,
                              g_color=None, timed=False):
    """Kernel 3 vs its plain version on one population under ``g_color``
    (3, Hp, Wp; the SSIM cotangent of the render when None) from ``carry``
    (C_in (3, Hp, Wp), T_in (Hp, Wp); identity when None). It runs twice
    and must repeat bit for bit. Returns (max_abs_err, times or None)."""
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_resident as rr
    from gs2d_tpu_torch.ops import tiles as tl

    n, k = params.n, cfg.max_splats_per_tile
    b = tl.bin_splats(params, cfg, k, ids_only=True)
    if int(b.n_dropped):
        raise AssertionError(f"{name}: binning dropped {int(b.n_dropped)}")
    table = rr.resident_table(params, cfg)
    ids = rr._remap_ids(b, n)
    fin = rr._fwd_resident_plain(table, ids, b.count, cfg)[0][0].contiguous()
    if g_color is None:
        g_color = ssim_cotangent(fin, ref, cfg)
    cin, tin = carry if carry is not None else rd.identity_carry(cfg, dev)
    args = (table, ids, b.count, fin, g_color.contiguous(), cin, tin, n, cfg)
    m_k = rr._bwd_resident_cuda(*args)
    m_k2 = rr._bwd_resident_cuda(*args)
    m_p = rr._bwd_resident_plain(*args)
    torch.cuda.synchronize()
    require_finite(name, moments=m_k)
    if not torch.equal(m_k, m_k2):
        raise AssertionError(f"{name}: bwd_resident does not repeat bit for "
                             "bit")
    ratio = moment_ratio(m_k, m_p)
    err, scale = grad_error(m_k, m_p, n, rr._table_fields(table, n))
    log(f"  {name}: N={n} K={k} max_count={int(b.count.max())} | "
        f"bwd_resident: moment err/tol {ratio:.3g}, grad err {err:.3g} of "
        f"|grad| max {scale:.3g}, repeats bit for bit")
    if ratio > 1.0:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    if not timed:
        return err, None
    work = live_work(table.reshape(-1, tl.N_FIELDS)[ids.long()], b.count,
                       cfg)
    return err, {"bwd_resident": timed_entry(
        lambda: rr._bwd_resident_cuda(*args),
        lambda: rr._bwd_resident_plain(*args), "bwd", work, cfg,
        nbytes(table, ids, b.count, fin, g_color, cin, tin, m_k))}


def compare_dense_case(name, params, ref, cfg, dev, carry=None,
                       g_color=None, timed=()):
    """The three dense kernels vs their plain versions on one population at
    cfg's K: the forward, the backward under ``g_color`` (3, Hp, Wp; the
    SSIM cotangent of the render when None) from ``carry`` (identity when
    None), run twice and bit for bit, and the fused L2 step. Returns
    ({kernel: max_abs_err}, {kernel: times} for the kernels in
    ``timed``)."""
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_dense as rdn
    from gs2d_tpu_torch.ops import tiles as tl

    n, k = params.n, cfg.max_splats_per_tile
    b = tl.bin_splats(params, cfg, k)
    if int(b.n_dropped):
        raise AssertionError(f"{name}: binning dropped {int(b.n_dropped)}")
    tp, ids, count = b.tile_params, b.ids, b.count
    ref_chw = rd.pad_ref_chw(ref, cfg, dev)
    c_k, t_k = rdn._fwd_dense_cuda(tp, count, cfg)
    c_p, t_p = rdn._fwd_dense_plain(tp, count, cfg)
    if g_color is None:
        g_color = ssim_cotangent(c_p, ref, cfg)
    cin, tin = carry if carry is not None else rd.identity_carry(cfg, dev)
    bwd_in = (tp, ids, count, c_p, g_color.contiguous(), cin, tin, n, cfg)
    m_k, g_k = rdn._bwd_dense_cuda(*bwd_in)
    m_k2, g_k2 = rdn._bwd_dense_cuda(*bwd_in)
    m_p, g_p = rdn._bwd_dense_plain(*bwd_in)
    l2_in = (tp, ids, count, ref_chw, n, cfg)
    l2_k = rdn._l2_dense_cuda(*l2_in)
    l2_p = rdn._l2_dense_plain(*l2_in)
    torch.cuda.synchronize()
    require_finite(name, color=c_k, T=t_k, moments=m_k, l2_color=l2_k[0],
                   l2_moments=l2_k[2])
    if not (torch.equal(m_k, m_k2) and torch.equal(g_k, g_k2)):
        raise AssertionError(f"{name}: bwd_dense does not repeat bit for "
                             "bit")
    fwd_err = max(float((c_k - c_p).abs().max()),
                  float((t_k - t_p).abs().max()))
    l2_col = float((l2_k[0] - l2_p[0]).abs().max())
    ratios = {"bwd": max(moment_ratio(m_k, m_p), moment_ratio(g_k, g_p)),
              "l2": max(moment_ratio(l2_k[1], l2_p[1]),
                        moment_ratio(l2_k[2], l2_p[2]))}
    fields = tl.packed_fields(params, cfg.splat_bounds)
    bwd_err, bwd_scale = grad_error(g_k, g_p, n, fields)
    l2_err, l2_scale = grad_error(l2_k[2], l2_p[2], n, fields)
    log(f"  {name}: N={n} K={k} tile {cfg.tile_h}x{cfg.tile_w} "
        f"max_count={int(count.max())} sat_walk={rd._sat_walk(cfg)} | fwd "
        f"err {fwd_err:.3g} | bwd: moment err/tol {ratios['bwd']:.3g}, grad "
        f"err {bwd_err:.3g} of {bwd_scale:.3g}, repeats bit for bit | l2: "
        f"color err {l2_col:.3g}, moment err/tol {ratios['l2']:.3g}, grad "
        f"err {l2_err:.3g} of {l2_scale:.3g}")
    if max(fwd_err, l2_col) > COLOR_ATOL or max(ratios.values()) > 1.0:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    errs = {"fwd_dense": fwd_err, "bwd_dense": bwd_err,
            "l2_dense": max(l2_col, l2_err)}
    if not timed:
        return errs, {}
    work = live_work(tp, count, cfg)
    base = nbytes(tp, ids, count)
    entries = {
        "fwd_dense": lambda: timed_entry(
            lambda: rdn._fwd_dense_cuda(tp, count, cfg),
            lambda: rdn._fwd_dense_plain(tp, count, cfg), "fwd", work, cfg,
            nbytes(tp, count, c_k, t_k)),
        "bwd_dense": lambda: timed_entry(
            lambda: rdn._bwd_dense_cuda(*bwd_in),
            lambda: rdn._bwd_dense_plain(*bwd_in), "bwd", work, cfg,
            base + nbytes(c_p, g_color, cin, tin, g_k)),
        "l2_dense": lambda: timed_entry(
            lambda: rdn._l2_dense_cuda(*l2_in),
            lambda: rdn._l2_dense_plain(*l2_in), "l2", work, cfg,
            base + nbytes(ref_chw, l2_k[0], l2_k[2])),
    }
    return errs, {kk: entries[kk]() for kk in timed}


def compare_new(dev, smi: str):
    """The compare cases of kernel 3 and the dense kernels: a random
    population under a random cotangent from a non-identity carry-in (K =
    256 and K = 512, so both members of each dense pair run), the opacity-1
    population centred on pixel centres, saturated 64-row tiles with the
    walk forced (dense), and the pcg3d init of the default fit (timed: kernel
    3 and the dense forward and backward at the SSIM path's K = 256, the
    dense L2 step at the L2 fit's tuned K = 512). Returns (max errors,
    times)."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_resident as rr
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import init_params, params_from_numpy

    log("[compare] bwd_resident and the dense kernels vs plain PyTorch")
    errs = {"bwd_resident": 0.0, "fwd_dense": 0.0, "bwd_dense": 0.0,
            "l2_dense": 0.0}
    times = {}

    def add(e):
        for kk, v in e.items():
            errs[kk] = max(errs[kk], v)

    ref = load_image(MINI)
    h, w = ref.shape[:2]
    base = SplatConfig(width=w, height=h, n_splats=600, tile_h=32,
                       max_splats_per_tile=256)
    # A prefix from another population as the carry-in, and a random
    # upstream cotangent.
    p_pre = params_from_numpy(population(21, 300, w, h), dev)
    pre = base.replace(n_splats=300)
    b_pre = tl.bin_splats(p_pre, pre, 256, ids_only=True)
    c_pre, t_pre = rr._fwd_resident_plain(rr.resident_table(p_pre, pre),
                                          rr._remap_ids(b_pre, 300),
                                          b_pre.count, pre)
    carry = (c_pre[0].contiguous(), t_pre[0].contiguous())
    g_rand = torch.randn((3, base.padded_height, base.padded_width),
                         generator=torch.Generator(dev).manual_seed(22),
                         device=dev)
    p_rand = params_from_numpy(population(20, 600, w, h), dev)
    add({"bwd_resident": compare_bwd_resident_case(
        "random + carry-in + random cotangent", p_rand, ref, base, dev,
        carry=carry, g_color=g_rand)[0]})
    add(compare_dense_case("random + carry-in + random cotangent, K=256",
                           p_rand, ref, base.replace(binning="dense"), dev,
                           carry=carry, g_color=g_rand)[0])
    cfg512 = base.replace(n_splats=1500, max_splats_per_tile=512,
                          binning="dense")
    add(compare_dense_case("random + carry-in + random cotangent, K=512",
                           params_from_numpy(population(20, 1500, w, h),
                                             dev), ref, cfg512, dev,
                           carry=carry, g_color=g_rand)[0])
    p1 = population(23, 300, w, h, opacity=(1.0, 1.0))
    p1["pos"][:64] = np.floor(p1["pos"][:64]) + 0.5
    p1 = params_from_numpy(p1, dev)
    cfg1 = base.replace(n_splats=300)
    add({"bwd_resident": compare_bwd_resident_case(
        "opacity-1 centred", p1, ref, cfg1, dev)[0]})
    add(compare_dense_case("opacity-1 centred", p1, ref,
                           cfg1.replace(binning="dense"), dev)[0])
    threshold = rd.SAT_WALK_THRESHOLD
    rd.SAT_WALK_THRESHOLD = 1
    try:
        cfg64 = SplatConfig(width=w, height=h, n_splats=256, tile_h=64,
                            max_splats_per_tile=512, binning="dense")
        add(compare_dense_case("saturated, 64-row tiles, walk forced",
                               params_from_numpy(opaque_stack(24, 256, w, h),
                                                 dev), ref, cfg64, dev)[0])
    finally:
        rd.SAT_WALK_THRESHOLD = threshold
    cfg_main = SplatConfig(width=w, height=h, n_splats=1024)
    p_init = init_params(cfg_main, dev)
    cfg_ssim = tl.tune_tile_height(cfg_main, p_init).replace(
        max_splats_per_tile=rd._max_per_tile(cfg_main))
    e, t = compare_bwd_resident_case("pcg3d init (SSIM path), K=256", p_init,
                                     ref, cfg_ssim, dev, timed=True)
    add({"bwd_resident": e})
    times.update(t)
    e, t = compare_dense_case("pcg3d init (SSIM path), K=256", p_init, ref,
                              cfg_ssim.replace(binning="dense"), dev,
                              timed=("fwd_dense", "bwd_dense"))
    add(e)
    times.update(t)
    cfg_l2 = tl.tune_tile_capacity(p_init, tl.tune_tile_height(
        cfg_main, p_init)).replace(binning="dense")
    e, t = compare_dense_case(
        f"pcg3d init (L2 path), K={cfg_l2.max_splats_per_tile}", p_init, ref,
        cfg_l2, dev, timed=("l2_dense",))
    add(e)
    times.update(t)
    log_times(times, "at the default fit's init", smi)
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


def reset_counts() -> None:
    from gs2d_tpu_torch.ops import render_dense as rdn
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import render_resident as rr

    for mod in (rr, rf, rdn):
        mod.reset_launch_counts()


def read_counts() -> dict:
    from gs2d_tpu_torch.ops import render_dense as rdn
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import render_resident as rr

    return {**rr.launches, **rf.launches, **rdn.launches}


def logged_fit(argv) -> tuple:
    """One CLI fit logged at every step, the launch counts set to 0 just
    before it and read just after. Returns (launches, {iter: mse})."""
    with tempfile.TemporaryDirectory() as out:
        reset_counts()
        printed = run_cli(argv + ["--log-every", "1", "--out", out])
        launches = read_counts()
        recs = [json.loads(x) for x in
                open(os.path.join(out, "metrics.jsonl")).read().splitlines()]
        mse = {r["iter"]: r["mse"] for r in recs if "iter" in r}
        done = [r for r in recs if r.get("event") == "done"][0]
        png = os.path.getsize(os.path.join(out, "render_final.png"))
    log(f"  launches: { {k: v for k, v in launches.items() if v} }; "
        f"render_final.png {png} bytes; logged run (sync every step): "
        f"{done['iters_per_s']:.1f} it/s")
    warnings = [x for x in printed.splitlines() if x.startswith("WARNING")]
    log(f"  overflow warnings: {warnings if warnings else 'none'}")
    if len(mse) != 200 or not all(np.isfinite(list(mse.values()))):
        raise AssertionError("trajectory incomplete or non-finite")
    return launches, mse


def fit_phase(image: str, splats: int, smi: str, extra=(),
              runs: int = 5):
    """The CLI's 200-iteration fit of ``image`` (with ``extra`` flags): once
    logged at every step (launch counts and the MSE trajectory), then
    ``runs`` timed runs without a per-step sync. Returns (launches,
    {iter: mse}, it/s of the timed runs)."""
    argv = [image, "--splats", str(splats), "--iters", "200", "--device",
            "cuda", *extra]
    log(f"[fit] python -m gs2d_tpu_torch.fit {os.path.basename(image)} "
        f"{' '.join(argv[1:])}")
    launches, mse = logged_fit(argv)
    rates = []
    for _ in range(runs):
        with tempfile.TemporaryDirectory() as out:
            run_cli(argv + ["--log-every", "0", "--out", out])
            rates.append([json.loads(x) for x in open(os.path.join(
                out, "metrics.jsonl")).read().splitlines()][-1]
                ["iters_per_s"])
    q1, med, q3 = np.percentile(rates, [25, 50, 75])
    log(f"  timed runs ({runs} x 200 iters, no per-step sync): it/s "
        f"{', '.join(f'{r:.2f}' for r in rates)}; median {med:.2f} "
        f"(quartiles {q1:.2f}-{q3:.2f}) = {1e3 / med:.3f} ms/step "
        f"[{smi}]")
    return launches, mse, rates


def expect_launches(path: str, launches: dict, want: dict) -> None:
    """Every kernel of ``want`` launched exactly that often, every other
    kernel never."""
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        raise AssertionError(f"{path}: launches {got}, expected {want}")


def check_trajectory(mse: dict, gates: dict) -> None:
    for it, (want, rtol) in gates.items():
        check_mse(mse, it, want, rtol)


def same_trajectory(a: dict, b: dict) -> bool:
    return all(a[i] == b[i] for i in range(200))


def step_profile(step, state, ref_in, step_ms: float, steps: int = 20) -> str:
    """Device time per step by kernel over a steady window of ``step`` from
    ``state``, from torch.profiler; the idle share is taken against
    ``step_ms``, the step time of an unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        state, _ = step(state, ref_in)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step(state, ref_in)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    rows = []
    total = 0.0
    launches = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed themselves
        dt = ev.self_device_time_total / steps / 1e3
        rows.append((dt, ev.count // steps, ev.key))
        total += dt
        launches += ev.count
    rows.sort(reverse=True)
    lines = [f"  device busy {total:.4f} ms/step over {steps} steps, "
             f"{launches / steps:.0f} device kernels and copies a step; "
             f"unprofiled step {step_ms:.4f} ms, idle share "
             f"{max(0.0, 1 - total / step_ms):.3f} (profiled step wall "
             f"{wall_ms:.3f} ms)"]
    lines += [f"    {ms:.4f} ms/step x{cnt}: {key[:70]}"
              for ms, cnt, key in rows[:8]]
    if not rows:
        lines.append("    profiler saw no device time")
    return "\n".join(lines)


def profile_fused(cfg, image: str, dev, step_ms: float) -> str:
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.train.loop import (init_train_state,
                                           make_train_step_fused)

    return step_profile(make_train_step_fused(cfg),
                        init_train_state(cfg, dev),
                        rd.pad_ref_chw(load_image(image), cfg, dev), step_ms)


def median_ms(rates) -> float:
    return 1e3 / float(np.median(rates))


KERNELS = (
    ("l2_resident", "gs2d_tpu_torch/csrc/render_resident.cu",
     "gs2d_tpu/ops/render_pallas_resident.py:88"),
    ("fwd_resident", "gs2d_tpu_torch/csrc/render_resident.cu",
     "gs2d_tpu/ops/render_pallas_resident.py:267"),
    ("bwd_resident", "gs2d_tpu_torch/csrc/render_resident.cu",
     "gs2d_tpu/ops/render_pallas_resident.py:294"),
    ("l2_dense", "gs2d_tpu_torch/csrc/render_dense.cu",
     "gs2d_tpu/ops/render_pallas.py:792, gs2d_tpu/ops/render_pallas.py:1003"),
    ("fwd_dense", "gs2d_tpu_torch/csrc/render_dense.cu",
     "gs2d_tpu/ops/render_pallas.py:231, gs2d_tpu/ops/render_pallas.py:458"),
    ("bwd_dense", "gs2d_tpu_torch/csrc/render_dense.cu",
     "gs2d_tpu/ops/render_pallas.py:253, gs2d_tpu/ops/render_pallas.py:496"),
    ("fwd_flat", "gs2d_tpu_torch/csrc/render_flat.cu",
     "gs2d_tpu/ops/render_pallas_flat.py:227"),
    ("bwd_flat", "gs2d_tpu_torch/csrc/render_flat.cu",
     "gs2d_tpu/ops/render_pallas_flat.py:265"),
)


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
    from gs2d_tpu_torch.train.loop import init_train_state, make_train_step

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
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- kernels vs plain versions ------------------------------------------
    ref = load_image(MINI)
    h, w = ref.shape[:2]
    cfg = SplatConfig(width=w, height=h, n_splats=1024, tile_h=32,
                      max_splats_per_tile=512)
    log("[compare] kernels vs plain PyTorch on the card")
    errs = {"l2_resident": 0.0, "fwd_resident": 0.0}
    p_rand = params_from_numpy(population(0, 1024, w, h), dev)
    e, _ = compare_case("random 268x213", p_rand, ref, cfg, dev, timed=False)
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
    e, times = compare_case("pcg3d init (main path)", p_init, ref, cfg_main,
                            dev, timed=True)
    errs = {kk: max(errs[kk], e[kk]) for kk in errs}
    log_times(times, f"at the default fit's init (K="
              f"{cfg_main.max_splats_per_tile})", smi)

    new_errs, new_times = compare_new(dev, smi)
    flat_errs, flat_times = compare_flat(dev, smi)
    errs.update(new_errs)
    errs.update(flat_errs)
    times.update(new_times)
    times.update(flat_times)

    # ---- main paths: the CLI's fits -----------------------------------------
    total = {}

    def count(launches):
        for kk, v in launches.items():
            total[kk] = total.get(kk, 0) + v

    launches, mse_l2, rates = fit_phase(MINI, 1024, smi)
    expect_launches("resident L2 fit", launches,
                    {"l2_resident": 200, "fwd_resident": 1})
    count(launches)
    check_trajectory(mse_l2, {it: (want, TRAJECTORY_RTOL)
                              for it, want in TRAJECTORY.items()})
    log("[profile] resident L2 train step, 20 steps")
    log(profile_fused(cfg_main, MINI, dev, median_ms(rates)))

    launches, mse, rates = fit_phase(FULL, N_10K, smi)
    expect_launches("flat L2 fit", launches,
                    {"fwd_flat": 201, "bwd_flat": 200})
    count(launches)
    check_trajectory(mse, TRAJECTORY_10K)
    log(f"  MSE-255 @ 200: {mse[199]:.4f} (no gate)")
    full = load_image(FULL)
    cfg_10k = SplatConfig(width=full.shape[1], height=full.shape[0],
                          n_splats=N_10K)
    p0 = init_params(cfg_10k, dev)
    cfg_10k = rf.tune_flat_config(p0, tl.tune_tile_height(cfg_10k, p0))
    log("[profile] flat L2 train step, 20 steps")
    log(profile_fused(cfg_10k, FULL, dev, median_ms(rates)))

    ssim = ["--ssim", SSIM]
    launches, mse_ssim, rates = fit_phase(MINI, 1024, smi, ssim, runs=3)
    expect_launches("resident SSIM fit", launches,
                    {"fwd_resident": 201, "bwd_resident": 200})
    count(launches)
    check_trajectory(mse_ssim, TRAJECTORY_SSIM)
    for it, want in REPORT_SSIM.items():
        log(f"  MSE-255 @ {it + 1}: {mse_ssim[it]:.4f} (JAX scan path "
            f"{want}, rel {abs(mse_ssim[it] - want) / want:.2e}; no gate)")
    log("[fit] the resident SSIM fit again, logged")
    _, again = logged_fit([MINI, "--splats", "1024", "--iters", "200",
                           "--device", "cuda", *ssim])
    if not same_trajectory(mse_ssim, again):
        raise AssertionError("the resident SSIM fit does not repeat bit for "
                             "bit")
    log("  repeats bit for bit (200 of 200 MSEs equal)")
    cfg_ssim = tl.tune_tile_height(SplatConfig(width=w, height=h,
                                               n_splats=1024), p_init)
    log("[profile] modular SSIM train step (resident), 20 steps")
    log(step_profile(make_train_step(cfg_ssim, float(SSIM)),
                     init_train_state(cfg_ssim, dev),
                     torch.as_tensor(ref, dtype=torch.float32, device=dev),
                     median_ms(rates)))

    dense = ["--binning", "dense"]
    launches, mse, _ = fit_phase(MINI, 1024, smi, dense, runs=3)
    expect_launches("dense L2 fit", launches,
                    {"l2_dense": 200, "fwd_dense": 1})
    count(launches)
    check_trajectory(mse, {it: (want, TRAJECTORY_RTOL)
                           for it, want in TRAJECTORY.items()})
    log(f"  equals the resident L2 trajectory bit for bit: "
        f"{same_trajectory(mse, mse_l2)}")

    launches, mse, _ = fit_phase(MINI, 1024, smi, dense + ssim,
                                 runs=3)
    expect_launches("dense SSIM fit", launches,
                    {"fwd_dense": 201, "bwd_dense": 200})
    count(launches)
    check_trajectory(mse, TRAJECTORY_SSIM)
    log(f"  equals the resident SSIM trajectory bit for bit: "
        f"{same_trajectory(mse, mse_ssim)}")

    launches, mse, _ = fit_phase(FULL, N_10K, smi, ssim, runs=3)
    expect_launches("flat SSIM fit", launches,
                    {"fwd_flat": 201, "bwd_flat": 200})
    count(launches)
    check_trajectory(mse, TRAJECTORY_SSIM_10K)
    log(f"  MSE-255 @ 200: {mse[199]:.4f} (no gate)")

    for kk, _, _ in KERNELS:
        if not total.get(kk):
            raise AssertionError(f"{kk}: no launch on any path")
    report = {"kernels": [
        {"name": kk, "route": "cuda", "source": src, "replaces": rep,
         "launches": total[kk], "max_abs_err": errs[kk],
         "ms": times[kk]["ms"], "plain_ms": times[kk]["plain_ms"],
         "bound_ms": times[kk]["bound_ms"],
         "bound_by": times[kk]["bound_by"], "library_ms": None}
        for kk, src, rep in KERNELS]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
