"""Smoke run of the PyTorch port on one NVIDIA GPU: build the CUDA kernels,
hold each against its plain PyTorch version and every warp-patch kernel
against the one-block-per-tile chunk walk over the same pairs, bit for bit
(the references gs2d_fwd_chunk, gs2d_bwd_chunk and gs2d_l2_mxu_chunk: the
designs the dense forward 6/7, the dense backward 8/9 and the MXU-form step
13 had before their warp patches, which no path reaches; the CUDA-core
probe 15a is held bit for bit to its lane tree, gs2d_moments_cuda_cores_tree,
and the tensor-core probes 15b and 15c within their tolerance to the designs
they had before wgmma, gs2d_moments_tensor_cores_staged and
gs2d_moments_scratch_contraction_sync, the same way; the L2 kernels 1,
4/5 and 12 against the forward reference, then gC = C - ref, then the
backward reference, kernels 2 and 6/7 against the forward reference, the
replays 3 and 8/9 against the backward reference under the same planes,
kernels 10 and 11 against both, kernel 13 against its own, each with its
survivors against the plain cull mask), time them by their device time
(torch.profiler's durations, the CUDA-event reading beside it), then drive
the fitting paths through them with the CLI and check their MSE
trajectories:

- the default fit, resident layout (squirrel_cls_mini 268x213, 1024 splats,
  L2, 200 iterations; kernels 1 and 2);
- the 10 240-splat fit, flat layout (squirrel_cls 535x426, 200 iterations;
  kernels 10 and 11), and with ``--binning dense`` (kernels 4/5), which must
  equal it 200 of 200;
- the default fit with ``--ssim 0.2``, resident layout (kernels 2 and 3),
  run twice: the second run must repeat the first bit for bit;
- the default fit with ``--binning dense`` (kernels 4/5, 6/7);
- the default fit with ``--binning dense --ssim 0.2`` (kernels 6/7, 8/9),
  which must equal the resident SSIM fit 200 of 200;
- the 10 240-splat fit with ``--ssim 0.2``, flat layout (kernels 10, 11);
- the window layout through ``train.loop.fit`` (squirrel_cls 535x426, 8192
  Morton-reordered splats, L2, 200 iterations; kernel 12) beside the
  resident fit of the same population (kernel 1);
- the default fit with ``--tile-h 64`` (kernels 1 and 2 on 64-row tiles);
- the MXU-form entry point ``l2_render_and_grads_mxu`` at the default
  fit's init (kernel 13, warp patches);
- the measurement entry points, ``scripts.probe_mxu_moments.main`` (kernels
  15a-c: the moment reduction on the CUDA cores and on the tensor cores)
  and ``scripts.roofline.main`` (kernel 14, the float32 FMA ceiling, the
  HBM ceiling, and five workloads' shares of the published and the
  measured ceilings);
- the 1080p fit, flat layout (a synthetic 1920x1080 target, 102 400 splats,
  200 iterations; kernels 10 and 11 at ``BASELINE.json`` configs[2]);
- the default fit checkpointed, and resumed half way: the resumed fit's
  MSEs must equal the uninterrupted fit's bit for bit;
- ``train.loop.fit_with_recovery`` with an injected fault (exactly one
  recovery, the learning rate halved; kernels 2 and 3 under the modular L2
  step), then the CLI's ``--recover`` without a fault;
- the scanned fits (``--scan-chunk 50``: one train step captured as a CUDA
  graph and replayed, ``train/graphs.py``): the default, dense, resident
  SSIM and window fits, the default and 10k fits with ``--rebin-margin 2``
  (lazy rebinning, the rebin choice under a CUDA conditional node) and the
  1080p fit with it, each beside its eager twin (bit for bit over 200
  steps but at 1080p, where no pair may drop), ``--rebin-margin -1``,
  ``--opacity-cull``, and the scanned default fit resumed at 100; one
  table puts each scanned fit's it/s, ms a step, device-busy ms,
  operations and idle share beside its eager twin's;
- adaptive density control (``train/densify.py``): the default fit with
  ``--optimize-opacity --densify-every 100 --opacity-reset-every 200``,
  400 iterations, eager and scanned (bit for bit), the 10k fit with
  ``--densify-every 100``, 300 iterations, and the modular route
  (``--ssim 0.2 --densify-every 100``), each held to its fit without
  densify; densify on the card against the CPU bit for bit, and the
  scanned default step with and without the densify signal;
- several images on one command line (``batched_phase``): the default fit
  on squirrel_cls_mini and a synthetic target of its size, eager and
  ``--scan-chunk 50`` (image 0 equal to the one-image fit 200 of 200, the
  scanned batch equal to the eager one, one capture), and the 10k fit with
  ``--densify-every 100`` on two images, each equal to its one-image
  ``fit_adaptive``;
- the mesh, ``parallel/`` on ``torch.distributed`` (``mesh_phase``): the
  band offsets of kernels 1-11 (each band's forward equal to the unbanded
  rows bit for bit on 2 and 4 bands, the bands' gradients summed against
  the unbanded step, the last band's kernels against their plain
  versions), splat shards in one process (the forward per shard, the
  ordered fold, the carry-fed backward per shard) against the unsharded
  kernels, ``fit_sharded`` on a world of one NCCL rank equal to
  ``train.loop.fit`` bit for bit, the CLI's ``--mesh 1,1,1`` fits (default
  eager and scanned, 10k flat) beside their one-image twins, resume at
  100, captured virtual meshes (one captured step for every coordinate,
  blocks of 50) equal to their per-step fits bit for bit over 200 steps,
  and, with two or more cards, NCCL clusters eager and captured (each
  rank's step with its collectives in the graph);
- the large flat configurations (``large_phase``): the step above the
  split threshold against the fused one at 10k, then through
  ``train.loop.fit`` the 1080p fit with 1 Mi splats (``BASELINE.json``
  configs[3]) and the 4K fit with 4 Mi splats (above the threshold: eager
  steps, never captured), each with its peak memory and kernels 10 and 11
  against their plain versions on the splats of the top row of tiles, and
  ``train.densify.fit_adaptive_batched`` on two 4K targets with 2 Mi splats
  each (configs[4] assembled).

    python3 chip_smoke.py
    python3 chip_smoke.py --profiles   # only the fused L2 steps' profiles
    python3 chip_smoke.py --mesh       # only the mesh phase
    python3 chip_smoke.py --mesh-cluster   # only the NCCL clusters (2+ cards)
    python3 chip_smoke.py --backward-dump OUT.pt [OTHER.pt]
        # kernels 3 and 8/9 on kernel 3's compare populations, saved; held
        # bit for bit to OTHER.pt, the dump of another checkout's kernels

Prints one line per phase; the line before the last is the kernels' JSON
report and the last is {"ok": true, "device": {...}}. A kernel's
``launches`` there is its launch count summed over the paths' logged runs
(the fits, the MXU entry point's call, the two scripts, resume and
recovery), each path counted from zero; ``ms`` is its device time a call
at the main path's shapes; ``bound_ms`` is the least time the card could
take for the work of its timed call (see
``gs2d_tpu_torch/scripts/roofline.py::bound``; for the moment probes
``gs2d_tpu_torch/ops/probes.py::moments_bound``, 15b's and 15c's products
at the tensor cores' TF32 rate). The report's
"references" list the six references the same way, each with
``reference_of`` (the kernel held to it), no TPU kernel replaced and 0
launches on every path. Any failure raises
and the script exits non-zero without printing a result; without a CUDA
GPU it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from gs2d_tpu_torch.scripts.roofline import (F32_PEAK, HBM_RATE, bound,
                                             flat_listed_rows, live_work,
                                             nbytes)
from gs2d_tpu_torch.utils.profiling import (cuda_ms, device_time,
                                            device_trace, timed_call)

ROOT = os.path.dirname(os.path.abspath(__file__))
MINI = os.path.join(ROOT, "assets", "squirrel_cls_mini.npy")
FULL = os.path.join(ROOT, "assets", "squirrel_cls.npy")

# MSE-255 of the 50th and 200th step's render on the default workload, the
# JAX package's and the C++ reference's shared trajectory (BASELINE.md).
TRAJECTORY = {49: 431.6, 199: 109.18}
TRAJECTORY_RTOL = 1e-3
# MSE-255 of the default fit at iterations 0, 1 and 9 (rel tolerance
# beside each): the JAX package's scan renderer on the same pcg3d init and
# target, on a CPU, from
#   JAX_PLATFORMS=cpu python -m gs2d_tpu.fit assets/squirrel_cls_mini.jpg \
#       --splats 1024 --iters 10 --renderer scan --log-every 1 \
#       --tile-h 32 --out <dir>
# The 0.1% gates above sit inside the spread between correct
# implementations at step 200 (PERF.md section 7); these hold however the
# kernels order their sums.
TRAJECTORY_JAX = {0: (5934.9033, 1e-4), 1: (4659.3296, 1e-4),
                  9: (1267.7319, 1e-4)}
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
# The window fit's population: the pcg3d init of 8192 splats on the 535x426
# target, Morton-reordered. MSE-255 at iterations 0, 1 and 9 of gs2d_tpu's
# scan path on that population, on a CPU (JAX_PLATFORMS=cpu), from these
# calls of gs2d_tpu's modules:
#   cfg = config.SplatConfig(width=535, height=426, n_splats=8192, tile_h=32)
#   state = train.reorder.reorder_state(train.loop.init_train_state(cfg), cfg)
#   train.loop.fit(jnp.asarray(io.image.load_image("assets/squirrel_cls.jpg")),
#                  cfg, 10, render_fn=ops.render_jax.render, state=state,
#                  log_every=1)
TRAJECTORY_WINDOW = {0: (6074.0503, 1e-4), 1: (4605.4385, 1e-4),
                     9: (583.9524, 1e-3)}
N_WINDOW = 8192
# The --tile-h 64 default fit against the 32-row one at iterations 0 and 1:
# the same splats and pixels, the moments summed in another grouping.
TILE64_RTOL = 1e-5
SSIM = "0.2"
N_10K = 10240
COLOR_ATOL = 1e-6   # same per-pixel float32 program; sums in one order
GRAD_RTOL = 1e-4    # of max(1, |moment row| max): the moments' sum order
# Kernel 13 against its plain version: the colour is the same per-pixel
# float32 program (COLOR_ATOL); the gradient rows come from pixel sums taken
# in another order, whose rounding the combine's cancellation (s_xx = m_xx -
# 2 ex m_x + ex^2 m_1, |ex| up to the tile's half-width) lifts by up to
# (64 / |vx|)^2, so 1e-3 of max(1, |field| max). Against kernel 4, whose
# D2 is the direct form: gs2d_tpu's tolerances for the MXU form
# (tests/test_fused.py:222-226), colour 5e-5 and gradients
# 2e-3 * max(1, |g| max) per field.
MXU_PLAIN_RTOL = 1e-3
MXU_COLOR_ATOL = 5e-5
MXU_GRAD_RTOL = 2e-3

# The bounds (the least time the card could take for a kernel's work) come
# from gs2d_tpu_torch/scripts/roofline.py::bound over live_work's counts,
# against the H100's published 67 TFLOP/s and 3.35 TB/s; the operation
# model is spelled out there.

# Kernel 14 against its plain version: both round each step once, so they
# agree to the unit in the last place but for the plain version's rare
# double rounding (ops/probes.py); FMA_ULPS units of the result.
# Kernel 15a: the moments' sum-order class (GRAD_RTOL of the result); its
# reference, the lane tree, adds the same operands (PROBE_REF_RTOL).
# Kernels 15b and 15c: what 3xTF32 keeps. Each product loses about 2^-21
# of its size and the sums are taken in another order than the plain
# versions' float32 products, and the tensor cores' accumulators truncate.
# Every output is held to PROBE_TC_RTOL of the size of its own terms
# (ops/probes.py::moments_output_sizes; 15c's 128 outputs cycle through nine
# moments whose sizes differ by about 1e3, and three of them cancel);
# measured on the H100: 1.2e-7 (15b) and 2.5e-6 (15c) of that size at most
# for the designs before wgmma, 2.4e-7 and 1.2e-6 for the wgmma kernels
# (their per-step values 5.2e-7 and 2.3e-6). 15c adds each chunk's product
# into its batch's moments in float32: the tensor cores' own accumulation
# truncates, and over a whole batch (1536 products) it drifted past this.
PROBE_TC_RTOL = 1e-5
# Each moment probe against its reference, of the outputs' terms' size: 0
# is bit for bit (15a's butterfly adds the tree's operands in either order).
PROBE_REF_RTOL = {"vpu": 0.0, "mxu": PROBE_TC_RTOL, "mxu2": PROBE_TC_RTOL}
N_100K = 102400

# Where the references' times stand in the times dicts: each beside the
# kernel that replaced it, on the same inputs.
FWD_CHUNK_TIMES = "fwd_chunk (reference), same rows (plain ms: 6/7's)"
BWD_CHUNK_TIMES = "bwd_chunk (reference), same rows (plain ms: kernel 3's)"
MXU_CHUNK_TIMES = "l2_mxu_chunk (reference), same inputs (plain ms: 13's)"
PROBE_REF_TIMES = {
    "moments_cuda_cores_tree":
        "moments_cuda_cores_tree (reference), K = 512 (plain ms: 15a's)",
    "moments_tensor_cores_staged":
        "moments_tensor_cores_staged (reference), K = 512 (plain ms: 15b's)",
    "moments_scratch_contraction_sync":
        "moments_scratch_contraction_sync (reference), K = 512 "
        "(plain ms: 15c's)"}


T_START = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase heading ("[...") gets the seconds since the
    script started in front."""
    if msg.startswith("["):
        msg = f"{time.perf_counter() - T_START:6.1f}s {msg}"
    print(msg, flush=True)


def device_lines() -> tuple:
    from gs2d_tpu_torch.utils.hardware import card_line

    return torch.cuda.get_device_name(0), card_line("cuda:0")


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


# The profiler's kernel time of a call against its graph-replay time: the
# graph adds a microsecond or so between kernels, the clocks drift a little
# between the two readings; a host-bound reading would be far outside.
PROFILER_AGREES = (0.7, 1.1)


def read_device_time(what: str, fn, reps: int = 20) -> dict:
    """utils/profiling.py::device_time of ``fn``; fails where the
    profiler's kernel time of a call disagrees with the graph replay's
    (PROFILER_AGREES)."""
    t = device_time(fn, reps)
    if t["profiler"] is not None and not (
            PROFILER_AGREES[0] <= t["profiler"] / t["device"]
            <= PROFILER_AGREES[1]):
        raise AssertionError(f"{what}: profiler {t['profiler']} ms against "
                             f"the graph replay's {t['device']} ms")
    return t


def device_line(t: dict) -> str:
    """A device_time reading: graph replay, profiler, CUDA events."""
    prof = ("profiler window not read" if t["profiler"] is None else
            f"profiler {t['profiler']:.4f} ms, {t['ops']:.0f} device "
            f"operations a call")
    return (f"{t['device']:.4f} ms device (graph replay; {prof}; CUDA events "
            f"{t['events']:.4f} ms)")


def timed_entry(kernel, plain_ms, kind, work, cfg, n_bytes):
    """{ms, device, plain_ms, bound_ms, bound_by} of one kernel at one
    input: ``ms`` its device time a call (a CUDA-graph replay of its
    launches, utils/profiling.py::device_time via read_device_time, 20
    calls), ``device`` that reading whole (the profiler's kernel time and
    the CUDA-event reading beside it); ``plain_ms`` is the time of the
    compare's one call of the plain version (timed_call: the plain walks
    are host-bound and slow, so each runs once)."""
    bound_ms, bound_by = bound(kind, work, cfg, n_bytes)
    t = read_device_time(kind, kernel)
    return {"ms": t["device"], "device": t, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "work": work}


def log_times(times: dict, where: str, smi: str) -> None:
    for kk, t in times.items():
        w = t["work"]
        log(f"  {kk} {where}: kernel {device_line(t['device'])}, plain "
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


def same_bits(got, want) -> bool:
    """torch.equal on the finite entries and equal NaN masks."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)
                and torch.equal(got[~nan], want[~nan]))


# The references' largest |difference| from the kernels held to them in
# this run, by reference (finite entries; the chunk references' gates need
# 0 and equal NaN masks, the probes' PROBE_TC_RTOL), for the report line.
REF_ERRS = {}


def note_reference(name: str, got, want) -> None:
    """Adds the largest |got - want| over each pair's finite entries to
    REF_ERRS[name]."""
    for g, w in zip(got, want):
        fin = torch.isfinite(g) & torch.isfinite(w)
        err = float((g[fin] - w[fin]).abs().max()) if bool(fin.any()) else 0.0
        REF_ERRS[name] = max(REF_ERRS.get(name, 0.0), err)


def full_width_window(table, ids, count, ref_chw, n, cfg):
    """The arguments of kernel 12 at W = n_pad, where it computes kernel 1's
    function with kernel 1's sums, on kernel 1's inputs."""
    from gs2d_tpu_torch.ops import render_window as rw
    from gs2d_tpu_torch.ops import tiles as tl

    b = tl.TileBinning(ids=torch.where(ids < n, ids, -1), count=count,
                       n_dropped=torch.zeros((), dtype=torch.int32))
    bases, _ = rw.window_bases(b, n, rw._n_pad(n))
    return (table, ids, count, bases, ref_chw, n, cfg, rw._n_pad(n))


def gathered_rows(table, ids):
    """The dense (n_tiles, K, 16) rows of a resident binning: the table
    rows its ids name (the pad row past each tile's count)."""
    from gs2d_tpu_torch.ops import tiles as tl

    return table.reshape(-1, tl.N_FIELDS)[ids.long()].contiguous()


def chain(tp, ids, count, ref_chw, n, cfg):
    """The in-call reference of the warp-patch kernels: the chunk
    references gs2d_fwd_chunk and gs2d_bwd_chunk (the forward 6/7 and the
    backward 8/9 had before their warp patches, never on a fit path), which
    keep the one-block-per-tile chunk walk (tile_walk.cuh), over the rows
    tp (n_tiles, K, 16): the forward, gC = C - ref, the replay from the
    identity carry. Returns (colour (3, Hp, Wp), T (Hp, Wp), slot partials
    (n_tiles, K, 9), moments (9, n))."""
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_dense as rdn

    color, trans = rdn._fwd_chunk_cuda(tp, count, cfg)
    cin, tin = rd.identity_carry(cfg, tp.device)
    part, g9 = rdn._bwd_chunk_cuda(tp, ids, count, color,
                                   (color - ref_chw[0]).contiguous(), cin,
                                   tin, n, cfg)
    return color, trans, part, g9


def slot_sums(partial, count, cfg):
    """The per-(tile, slot) sums of a warp-patch L2 kernel's partials."""
    from gs2d_tpu_torch.ops import render_resident as rr

    return rr.patch_slot_sums(partial, count, rr.patch_passes(cfg))


def dense_vs_chain(tp, ids, count, ref_chw, n, cfg) -> bool:
    """Kernel 4/5 against the chunk walk on the same rows, bit for bit:
    colour, slot partials and moments (equal NaN masks)."""
    from gs2d_tpu_torch.ops import render_dense as rdn

    c_ch, _, part_ch, g_ch = chain(tp, ids, count, ref_chw, n, cfg)
    c_d, part_d, g_d = rdn._l2_dense_cuda(tp, ids, count, ref_chw, n, cfg)
    return (same_bits(c_d, c_ch) and same_bits(g_d, g_ch)
            and same_bits(slot_sums(part_d, count, cfg), part_ch))


def vs_chain(name, table, ids, count, ref_chw, n, cfg) -> None:
    """Kernels 1, 4/5 (on the table rows the ids name) and 12 at W = n_pad
    against the chunk walk (chain) bit for bit: colour and moments (equal
    NaN masks where a splat is not finite), 4/5's slot partials, kernel
    2's colour against kernel 1's and its T against the chain's, and
    kernels 6/7 (on the same rows) against the chain's forward, colour and
    T."""
    from gs2d_tpu_torch.ops import render_dense as rdn
    from gs2d_tpu_torch.ops import render_resident as rr
    from gs2d_tpu_torch.ops import render_window as rw

    tp = gathered_rows(table, ids)
    c_ch, t_ch, _, g_ch = chain(tp, ids, count, ref_chw, n, cfg)
    f_d, t_d = rdn._fwd_dense_cuda(tp, count, cfg)
    c_k, g_k = rr._l2_resident_cuda(table, ids, count, ref_chw, n, cfg)
    c_w, g_w = rw._l2_window_cuda(*full_width_window(table, ids, count,
                                                     ref_chw, n, cfg))
    f_k, t_k = rr._fwd_resident_cuda(table, ids, count, cfg)
    same = {"kernel 1": same_bits(c_k[0], c_ch) and same_bits(g_k[:9, :n],
                                                               g_ch),
            "kernel 12": same_bits(c_w[0], c_ch) and same_bits(g_w[:9, :n],
                                                               g_ch),
            "kernels 4/5": dense_vs_chain(tp, ids, count, ref_chw, n, cfg),
            "kernel 2": same_bits(f_k, c_k) and same_bits(t_k[0], t_ch),
            "kernels 6/7": same_bits(f_d, c_ch) and same_bits(t_d, t_ch)}
    if not all(same.values()):
        raise AssertionError(f"{name}: differs from the chunk walk: {same}")
    note_reference("fwd_chunk", (f_d, t_d), (c_ch, t_ch))
    log(f"  {name}: kernels 1, 4/5 and 12 (W = n_pad) equal the chunk walk "
        f"(the forward reference, gC, then the backward reference) bit for "
        f"bit (colour, moments, 4/5's slot partials; NaN in "
        f"{int(torch.isnan(g_ch).sum())} moments), kernel 2's colour equals "
        f"kernel 1's and its T the chain's, kernels 6/7 equal the forward "
        f"reference (colour, T; NaN in {int(torch.isnan(t_ch).sum())} T "
        f"values)")


def patch_survivors(launches, want, dev) -> dict:
    """Each launch's survivors per patch (written to its ``walked``)
    against ``want``, patch by patch; returns {name: survivors walked}."""
    walked = {}
    for kk, launch in launches.items():
        got = torch.full((want.numel(), 2), -1, dtype=torch.int32,
                         device=dev)
        launch(got)
        torch.cuda.synchronize()
        if not torch.equal(got[:, 0], want):
            raise AssertionError(f"{kk}: survivors differ from the plain "
                                 "cull mask")
        walked[kk] = int(got[:, 1].sum())
    if len(set(walked.values())) != 1:
        raise AssertionError(f"the kernels walk different survivors: "
                             f"{walked}")
    return walked


def survivor_counts(table, ids, count, ref_chw, n, cfg, dev) -> str:
    """Kernels 1, 2, 4/5 and 6/7 (on the gathered rows) and 12 (at W =
    n_pad): their survivors per patch against the plain cull mask
    (patch_cover_mask), patch by patch; returns the totals: (patch, slot)
    steps of the one-block-per-tile walk, survivors, and survivors walked
    before the saturation exit."""
    from gs2d_tpu_torch.ops import render_dense as rdn
    from gs2d_tpu_torch.ops import render_resident as rr
    from gs2d_tpu_torch.ops import render_window as rw

    mask = rr.patch_cover_mask(table, ids, count, cfg, rr.patch_rows())
    want = mask.sum(dim=-1).reshape(-1).to(torch.int32)
    tp = gathered_rows(table, ids)
    window = full_width_window(table, ids, count, ref_chw, n, cfg)
    walked = patch_survivors({
        "kernel 1": lambda w: rr._l2_resident_cuda(
            table, ids, count, ref_chw, n, cfg, walked=w),
        "kernel 2": lambda w: rr._fwd_resident_cuda(
            table, ids, count, cfg, walked=w),
        "kernels 4/5": lambda w: rdn._l2_dense_cuda(
            tp, ids, count, ref_chw, n, cfg, walked=w),
        "kernels 6/7": lambda w: rdn._fwd_dense_cuda(tp, count, cfg,
                                                     walked=w),
        "kernel 12": lambda w: rw._l2_window_cuda(*window, walked=w)},
        want, dev)
    steps = int(count.sum()) * mask.shape[1]
    return (f"(patch, slot) steps {steps}, survivors {int(want.sum())} "
            f"(plain mask {int(mask.sum())}, equal patch by patch in "
            f"{', '.join(walked)}), walked before the saturation exit "
            f"{walked['kernel 1']}")


def compare_case(name, params, ref, cfg, dev, timed: bool,
                 repeat_plain: bool = False):
    """Kernels 1 and 2 vs their plain versions on one population, and
    kernels 1, 2, 4/5 and 12 vs the chunk walk (vs_chain). ``repeat_plain``
    runs kernel 1's plain version twice: the two must be equal, so the
    error ratio repeats. Returns ({kernel: max_abs_err}, {kernel: times} or
    None; a timed case also times the chunk walk, under a key with a comma,
    which the kernels' line does not read)."""
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
    (c_p, g_p), l2_plain_ms = timed_call(lambda: rr._l2_resident_plain(
        table, ids, b.count, ref_chw, n, cfg))
    if repeat_plain:
        c_p2, g_p2 = rr._l2_resident_plain(table, ids, b.count, ref_chw, n,
                                           cfg)
        if not (torch.equal(c_p, c_p2) and torch.equal(g_p, g_p2)):
            raise AssertionError(f"{name}: kernel 1's plain version does not "
                                 "repeat bit for bit")
    f_k, t_k = rr._fwd_resident_cuda(table, ids, b.count, cfg)
    (f_p, t_p), fwd_plain_ms = timed_call(lambda: rr._fwd_resident_plain(
        table, ids, b.count, cfg))
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
        f"| fwd err {fwd_err:.3g} (tol {COLOR_ATOL})"
        + ("; plain version repeats bit for bit" if repeat_plain else ""))
    if col_err > COLOR_ATOL or bool((mom_err > mom_tol).any()) \
            or fwd_err > COLOR_ATOL:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    vs_chain(name, table, ids, b.count, ref_chw, n, cfg)
    errs = {"l2_resident": max(col_err, grad_err), "fwd_resident": fwd_err}
    if not timed:
        return errs, None
    log(f"  {name}: {survivor_counts(table, ids, b.count, ref_chw, n, cfg, dev)}")
    work = live_work(table.reshape(-1, tl.N_FIELDS)[ids.long()], b.count,
                       cfg)
    base = nbytes(table, ids, b.count)
    l2_bytes = base + nbytes(ref_chw, c_k, g_k)
    fwd_bytes = base + nbytes(f_k, t_k)
    tp = gathered_rows(table, ids)
    return errs, {
        "the chunk walk (forward reference, gC, backward reference)":
            timed_entry(lambda: chain(tp, ids, b.count, ref_chw, n, cfg),
                        l2_plain_ms, "l2", work, cfg, l2_bytes),
        "l2_resident": timed_entry(
            lambda: rr._l2_resident_cuda(table, ids, b.count, ref_chw, n,
                                         cfg),
            l2_plain_ms, "l2", work, cfg, l2_bytes),
        "fwd_resident": timed_entry(
            lambda: rr._fwd_resident_cuda(table, ids, b.count, cfg),
            fwd_plain_ms, "fwd", work, cfg, fwd_bytes),
    }


def compare_nan_case(dev) -> None:
    """A population with one non-finite splat (splat 40's position NaN in
    the table after binning): kernels 1, 2, 4/5, 6/7 and 12 against the
    chunk walk bit for bit, NaN masks included (vs_chain); then 6/7 on a
    population whose NaN reaches the forward (compare_nan_forward). The
    plain versions are not compared: their outputs are NaN where the
    kernels' are."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_resident as rr
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import params_from_numpy

    ref = load_image(MINI)
    h, w = ref.shape[:2]
    cfg = SplatConfig(width=w, height=h, n_splats=130, tile_h=32,
                      max_splats_per_tile=128)
    p = params_from_numpy(population(3, 130, w, h), dev)
    b = tl.bin_splats(p, cfg, 128, ids_only=True)
    table = rr.resident_table(p, cfg)
    table.reshape(-1, tl.N_FIELDS)[40, tl.FIELD_PX] = float("nan")
    vs_chain("random N=130, splat 40 at a NaN position", table,
                  rr._remap_ids(b, 130), b.count, rd.pad_ref_chw(ref, cfg, dev),
                  130, cfg)
    compare_nan_forward(dev)


def kernel_split(fn, parts, reps: int = 10) -> dict:
    """Device ms of one launch of each kernel whose name holds one of
    ``parts`` (the profiler's kernels of utils/profiling.py::device_time
    over ``reps`` calls of ``fn``: the sum over the launches the trace
    holds, over their count, which is logged as "seen"), and beside them
    "device", the device ms of a call, and "events", its CUDA-event ms
    over ``reps`` untraced calls."""
    t = read_device_time("split", fn, reps)
    total = dict.fromkeys(parts, 0.0)
    seen = dict.fromkeys(parts, 0.0)
    for key, (ms, n) in t["kernels"].items():
        part = next((x for x in parts if x in key), None)
        if part is not None:
            total[part] += ms
            seen[part] += n
    return {**{x: total[x] / max(1e-9, seen[x]) for x in parts},
            "device": t["device"], "events": t["events"],
            "seen": round(reps * min(seen.values()))}


# Kernel 11's three kernels (csrc/render_flat.cu), for its time split.
BWD_FLAT_PARTS = ("bwd_flat_kernel", "flat_patch_sum_kernel",
                  "segment_sum_flat_kernel")


def flat_vs_dense(name, b, rows, bd, tp, fwd_out, bwd_out, bwd_planes, n,
                  cfg) -> None:
    """Kernels 10 and 11 against the chunk references (the forward and the
    backward), which keep the one-block-per-tile chunk walk (tile_walk.cuh)
    over the same rows in the same order: colour, T, the per-pair moments
    matched by (tile, slot) and the (9, n) splat sums equal bit for bit
    (NaN masks included), and every row outside the runs is 0; kernels 6/7
    on the dense rows equal the forward reference (colour, T)."""
    from gs2d_tpu_torch.ops import render_dense as rdn

    c_d, t_d = rdn._fwd_chunk_cuda(tp, bd.count, cfg)
    f_d, t_dd = rdn._fwd_dense_cuda(tp, bd.count, cfg)
    part_d, g_d = rdn._bwd_chunk_cuda(tp, bd.ids, bd.count, *bwd_planes, n,
                                      cfg)
    (c_k, t_k), (m_k, g_k) = fwd_out, bwd_out
    k = torch.arange(tp.shape[1], device=tp.device)
    listed = k[None] < b.count[:, None]
    pair = (b.start[:, None] + k[None]).long()[listed]
    outside = torch.ones(m_k.shape[0], dtype=torch.bool, device=tp.device)
    outside[pair] = False
    same = {"colour": same_bits(c_k, c_d), "T": same_bits(t_k, t_d),
            "pair moments": same_bits(m_k[pair], part_d[listed]),
            "splat sums": same_bits(g_k, g_d),
            "rows outside the runs 0": bool((m_k[outside] == 0).all()),
            "kernels 6/7": same_bits(f_d, c_d) and same_bits(t_dd, t_d)}
    if not all(same.values()):
        raise AssertionError(f"{name}: kernels 10/11 or 6/7 differ from the "
                             f"chunk references: {same}")
    note_reference("fwd_chunk", (f_d, t_dd), (c_d, t_d))
    log(f"  {name}: kernels 10 and 11 equal the chunk references bit for "
        f"bit (colour, T, {int(pair.numel())} pair moments, splat sums; NaN "
        f"in {int(torch.isnan(g_k).sum())} splat moments), and kernels 6/7 "
        f"on the dense rows the forward reference (colour, T)")


def flat_survivors(b, rows, fwd_in, bwd_in, fields, cfg, dev) -> str:
    """Kernels 10 and 11's survivors per patch against the plain cull mask
    (listed_cover_mask of the flat runs), patch by patch; returns the
    totals: (patch, slot) steps of the one-block-per-tile walk, survivors,
    and survivors walked before each kernel's saturation exit. Kernel 10's
    come from its full cull (walked given), which production calls, taking
    the mask past the exit, do not run."""
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import render_resident as rr

    mask = rr.listed_cover_mask(flat_listed_rows(b._replace(rows=rows), dev),
                                b.count, cfg, rr.patch_rows())
    want = mask.sum(dim=-1).reshape(-1).to(torch.int32)
    walked = [torch.full((want.numel(), 2), -1, dtype=torch.int32,
                         device=dev) for _ in range(2)]
    rf._fwd_flat_cuda(*fwd_in, walked=walked[0])
    rf._bwd_flat_cuda(*bwd_in, fields=fields, walked=walked[1])
    torch.cuda.synchronize()
    for kk, got in zip(("fwd_flat", "bwd_flat"), walked):
        if not torch.equal(got[:, 0], want):
            raise AssertionError(f"{kk}: survivors differ from the plain "
                                 "cull mask")
    steps = int(b.count.sum()) * mask.shape[1]
    return (f"(patch, slot) steps {steps}, survivors {int(want.sum())} "
            f"(plain mask, equal patch by patch), walked before the "
            f"saturation exit: kernel 10 {int(walked[0][:, 1].sum())} (its "
            f"full cull, the path walked selects; production calls take "
            f"the mask), kernel 11 {int(walked[1][:, 1].sum())}")


def compare_flat_case(name, params, ref, cfg, dev, carry=None,
                      g_color=None, timed=False, nan_splat=None):
    """Kernels 10 and 11 vs their plain versions on one population, with the
    flat statics tuned from it, and vs the dense kernels (flat_vs_dense) on
    a dense binning of it (K the largest count, no drop). The backward
    replays from ``carry`` (C_in (3, Hp, Wp), T_in (Hp, Wp); identity when
    None) under ``g_color`` (3, Hp, Wp; the L2 cotangent C - ref when None).
    Kernel 11 runs twice and must repeat bit for bit. ``nan_splat``: that
    splat's position is NaN in both layouts' pregathered rows, and the plain
    versions are not compared (their walk stops only where every tile has
    saturated, so their NaNs fall elsewhere). Returns ({kernel:
    max_abs_err}, {kernel: times} or None)."""
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.ops import tiles_flat as tlf
    from gs2d_tpu_torch.params import FIELDS

    n = params.n
    cfg = rf.tune_flat_config(params, cfg)
    m_cap, kc, mc = cfg.flat_capacity, cfg.flat_chunk, cfg.flat_max_chunks
    b = tlf.bin_splats_flat(params, cfg, m_cap, kc=kc, max_chunks=mc)
    bd = tl.bin_splats(params, cfg.replace(binning="dense"),
                       max(1, int(b.count.max())))
    if int(b.n_dropped) or int(bd.n_dropped):
        raise AssertionError(f"{name}: binning dropped {int(b.n_dropped)} "
                             f"(flat), {int(bd.n_dropped)} (dense)")
    rows, tp = b.rows, bd.tile_params
    if nan_splat is not None:
        rows, tp = rows.clone(), tp.clone()
        rows[b.ids == nan_splat, tl.FIELD_PX] = float("nan")
        tp[bd.ids == nan_splat, tl.FIELD_PX] = float("nan")
    fields = tl.packed_fields(params, cfg.splat_bounds)
    fwd_in = (rows, b.start, b.count, cfg, kc, mc)
    c_k, t_k = rf._fwd_flat_cuda(*fwd_in)
    if nan_splat is None:
        (c_p, t_p), fwd_plain_ms = timed_call(
            lambda: rf._fwd_flat_plain(*fwd_in))
    else:
        c_p = c_k
    if g_color is None:
        g_color = c_p - rd.pad_ref_chw(ref, cfg, dev)[0]
    cin, tin = carry if carry is not None else rd.identity_carry(cfg, dev)
    bwd_planes = (c_p, g_color.contiguous(), cin, tin)
    bwd_in = (rows, b.ids, b.start, b.count, *bwd_planes, n, cfg, kc, mc)
    m_k, g_k = rf._bwd_flat_cuda(*bwd_in, fields=fields)
    m_k2, g_k2 = rf._bwd_flat_cuda(*bwd_in, fields=fields)
    torch.cuda.synchronize()
    if not (same_bits(m_k2, m_k) and same_bits(g_k2, g_k)):
        raise AssertionError(f"{name}: bwd_flat does not repeat bit for bit")
    flat_vs_dense(name, b, rows, bd, tp, (c_k, t_k), (m_k, g_k), bwd_planes,
                  n, cfg)
    survivors = flat_survivors(b, rows, fwd_in, bwd_in, fields, cfg, dev)
    log(f"  {name}: {survivors}")
    if nan_splat is not None:
        # The chunk walk stops where its 32-row pass saturates, the patch
        # walk gives the NaNs of the walk without exits (render_flat.cu):
        # they agree while no pass of the NaN splat's tiles saturates.
        tiles = torch.unique(torch.searchsorted(
            b.start, torch.nonzero(b.ids == nan_splat)[:, 0].to(torch.int32),
            right=True) - 1)
        passes = rd.to_tiles(torch.nan_to_num(t_k)[None], cfg)[0][tiles]
        open_ = (passes.reshape(len(tiles), -1, 32 * cfg.tile_w)
                 >= cfg.min_throughput).any(dim=-1)
        log(f"  {name}: splat {nan_splat} listed in tiles "
            f"{tiles.tolist()}, every 32-row pass of them unsaturated: "
            f"{bool(open_.all())}; NaN in {int(torch.isnan(c_k).sum())} "
            f"colour values, {int(torch.isnan(m_k).sum())} pair moments")
        if not bool(open_.all()) or not torch.isnan(g_k).any():
            raise AssertionError(f"{name}: not the case it should be")
        return {}, None
    (m_p, g_p), bwd_plain_ms = timed_call(
        lambda: rf._bwd_flat_plain(*bwd_in))
    for what, x in (("color", c_k), ("T", t_k), ("moments", m_k),
                    ("splat moments", g_k)):
        if not torch.isfinite(x).all():
            raise AssertionError(f"{name}: non-finite kernel {what}")
    fwd_err = max(float((c_k - c_p).abs().max()),
                  float((t_k - t_p).abs().max()))
    ratios = []
    for got, want in ((m_k, m_p), (g_k.T, g_p.T)):  # per moment field
        tol = GRAD_RTOL * torch.clamp(want.abs().max(dim=0).values, min=1.0)
        ratios.append(float(((got - want).abs().max(dim=0).values
                             / tol).max()))
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
    work = live_work(flat_listed_rows(b, dev), b.count, cfg)
    base = nbytes(b.rows, b.start, b.count)
    bwd = lambda: rf._bwd_flat_cuda(*bwd_in, fields=fields)
    times = {
        "fwd_flat": timed_entry(
            lambda: rf._fwd_flat_cuda(*fwd_in), fwd_plain_ms, "fwd", work,
            cfg, base + nbytes(c_k, t_k)),
        "bwd_flat": timed_entry(
            bwd, bwd_plain_ms, "bwd", work, cfg,
            base + nbytes(b.ids, c_p, g_color, cin, tin, g_k)),
    }
    split = kernel_split(bwd, BWD_FLAT_PARTS)
    scratch = rf.partial_shape(cfg, m_cap)
    log(f"  kernel 11 split (device ms a launch, torch.profiler, "
        f"{split['seen']} of 10 calls' launches seen): replay "
        f"{split[BWD_FLAT_PARTS[0]]:.4f}, patch sum "
        f"{split[BWD_FLAT_PARTS[1]]:.4f}, splat sum "
        f"{split[BWD_FLAT_PARTS[2]]:.4f}; device {split['device']:.4f}, "
        f"CUDA events {split['events']:.4f} ms a call; patch partials "
        f"{scratch} = "
        f"{4 * np.prod(scratch) / 1e6:.1f} MB")
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
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.ops import tiles_flat as tlf
    from gs2d_tpu_torch.params import init_params, params_from_numpy

    log("[compare] flat kernels vs plain PyTorch and the dense kernels on "
        "the card")
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
    compare_flat_case("random, kc=32, splat 40 at a NaN position", p_rand,
                      mini, cfg, dev, nan_splat=40)
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
    with walk_forced(True):
        cfg64 = SplatConfig(width=w, height=h, n_splats=256, tile_h=64,
                            binning="flat")
        add(compare_flat_case("saturated, 64-row tiles, walk forced",
                              params_from_numpy(opaque_stack(15, 256, w, h),
                                                dev), mini, cfg64, dev)[0])
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


# Kernels 3's and 8/9's two kernels (csrc/render_resident.cu,
# csrc/render_dense.cu), for their time split.
BWD_RESIDENT_PARTS = ("bwd_resident_kernel", "patch_sum_kernel")
BWD_DENSE_PARTS = ("bwd_dense_kernel", "patch_sum_kernel")


def hd_population(dev, seed: int, n: int = 1 << 20, size=(1080, 1920)):
    """A 1080p population as the hd-1m render cell draws it (positions over
    the image, sigma 6-10, rotation in [0, pi), colours in [0, 1], opacity
    1) and its statics as the CLI's auto path tunes them."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import GaussianParams

    h, w = size
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = torch.rand((5, n), generator=gen, device=dev)
    p = GaussianParams(
        pos=torch.stack([u[0] * (w - 1), u[1] * (h - 1)], -1),
        sx=6.0 + 4.0 * u[2], sy=6.0 + 4.0 * u[3], rot=np.pi * u[4],
        color=torch.rand((n, 3), generator=gen, device=dev),
        opacity=torch.ones((n,), device=dev))
    cfg = tl.tune_tile_height(SplatConfig(width=w, height=h, n_splats=n), p)
    return p, rf.tune_flat_config(p, cfg)


def expand_phase(dev, smi: str) -> dict:
    """The flat binning's expansion kernels (csrc/tiles_flat.cu) against
    their plain twin at 1080p/1M, three populations: tile_e, splat_e and
    dropped_exp integer-equal, the whole FlatBinning equal (rows bit for
    bit), render_flat's frame bit for bit; then the expansion's device time
    (utils/profiling.py::device_time), kernels against the plain stage, and
    its share of a bytes bound (the splats' positions, scales and
    rotations read once, 20 bytes a splat, and tile_e and splat_e written
    once, 8 bytes a row, over HBM_RATE). Returns expand_flat's KERNELS
    entry: {ms, device, plain_ms (the plain stage's device time on the
    card), bound_ms, bound_by}."""
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import tiles_flat as tlf

    t_phase = time.perf_counter()
    log("[expand] the flat binning's expansion kernels vs the plain twin, "
        "1080p/1M populations (hd-1m's draw)")
    for seed in (0, 1, 2):
        p, cfg = hd_population(dev, 2300 + seed)
        m_cap, kc, mc = rf._statics(cfg)
        got = tlf._expand_cuda(p, cfg, m_cap)
        want = tlf._expand_plain(p, cfg, m_cap)
        for g, w_, name in zip(got, want,
                               ("tile_e", "splat_e", "dropped_exp")):
            if not torch.equal(g, w_):
                raise AssertionError(f"expansion seed {seed}: {name} "
                                     "differs from the plain twin's")
        reset_counts()
        b_k = tlf.bin_splats_flat(p, cfg, m_cap, kc=kc, max_chunks=mc)
        frame_k, _ = rf.render_flat(p, cfg)
        expect_launches(f"expansion seed {seed}, the kernels' binning and "
                        "render", read_counts(),
                        {"expand_flat": 2, "fwd_flat": 1,
                         "fwd_flat_mask": 1})
        reset_counts()
        with plain_versions(("tiles_flat",)):
            b_p = tlf.bin_splats_flat(p, cfg, m_cap, kc=kc, max_chunks=mc)
            frame_p, _ = rf.render_flat(p, cfg)
        expect_launches(f"expansion seed {seed}, the plain expansion's "
                        "binning and render", read_counts(),
                        {"fwd_flat": 1, "fwd_flat_mask": 1})
        for f in tlf.FlatBinning._fields:
            if not same_bits(getattr(b_k, f), getattr(b_p, f)):
                raise AssertionError(f"expansion seed {seed}: binning {f} "
                                     "differs from the plain expansion's")
        if not same_bits(frame_k, frame_p) or int(b_k.n_dropped):
            raise AssertionError(f"expansion seed {seed}: the frame differs "
                                 "or pairs dropped")
        log(f"  seed {2300 + seed}: tile {cfg.tile_h}x{cfg.tile_w} "
            f"({cfg.n_tiles_y}x{cfg.n_tiles_x}), m_cap {m_cap}, "
            f"{int((got[1] >= 0).sum())} live pairs, dropped_exp "
            f"{int(got[2])}: tile_e, splat_e, dropped_exp, the binning "
            f"and the frame equal the plain expansion's bit for bit")
    t_k = device_time(lambda: tlf._expand_cuda(p, cfg, m_cap), reps=20)
    t_p = device_time(lambda: tlf._expand_plain(p, cfg, m_cap), reps=20)
    n_bytes = 20 * p.n + 8 * m_cap
    bound_ms = 1e3 * n_bytes / HBM_RATE
    log(f"  expansion, kernels: {device_line(t_k)}; by kernel "
        f"{ {k: round(v[0], 5) for k, v in t_k['kernels'].items()} } "
        f"[{smi}]")
    log(f"  expansion, plain twin on the card: {device_line(t_p)} [{smi}]")
    log(f"  bytes bound {bound_ms:.5f} ms ({n_bytes} B over "
        f"{HBM_RATE / 1e12:.2f} TB/s: 20 B a splat, 8 B a row of the "
        f"m_cap): kernels {bound_ms / t_k['device']:.4f} of it, plain "
        f"{bound_ms / t_p['device']:.5f}; kernels "
        f"{t_p['device'] / t_k['device']:.1f}x faster; the phase "
        f"{time.perf_counter() - t_phase:.1f}s")
    return probe_entry(t_k, t_p["device"], (bound_ms, "bytes"))


def skipped_share(exits, n, per_tile: int) -> float:
    """The share of the listed 32-slot chunks (over every patch) that kernel
    10's tail left unculled: a patch culls the chunks up to the one that
    holds its exit survivor, and reads the mask for the rest (on a finite
    population no word is set, so it culls none of them)."""
    n_p = n.repeat_interleave(per_tile).to(torch.int64)
    listed = (n_p + 31) // 32
    culled = (exits.to(torch.int64) + 31) // 32
    return float((listed - culled).sum()) / float(listed.sum())


def tail_plants(exits, n, start, cfg) -> list:
    """Where tail_phase plants non-finite rows in a 1080p/1M binning, from
    each patch's exit slot on the finite rows ((n_tiles, patches a tile))
    and the runs' lengths n: [(case, tile, slots, field, value)], a tile
    each. A colour plant lies past every exit of its tile but the
    below-image case's, whose patch saturates from slot 0; the rows there
    are walked by every patch of the tile (0 * NaN or inf where no pixel is
    live), so that channel of the tile reads NaN throughout. A position or
    opacity plant past the exits changes no pixel."""
    from gs2d_tpu_torch.ops import tiles as tl

    first, last = exits.min(dim=1).values, exits.max(dim=1).values
    bottom = (cfg.n_tiles_y - 1) * cfg.n_tiles_x
    room = torch.where(last + 128 < n, n - last, 0)
    room[bottom:] = 0
    order = [int(t) for t in torch.argsort(room, descending=True)[:5]]
    if int(room[order[-1]]) <= 0:
        raise AssertionError(f"tail plants: room {room[order].tolist()}")
    past = [(int(last[t]) + 64) // 32 * 32 for t in order]  # chunk starts
    s = int(start[order[2]])
    edge = past[2] + 31 - (s + past[2]) % 32  # flat rows 32 w + 31, 32 w + 32
    pad = bottom + int(torch.argmax(n[bottom:]))
    if int(first[pad]) != 0:
        raise AssertionError("tail plants: no patch below the image")
    nan, inf = float("nan"), float("inf")
    return [("mid-chunk", order[0], [past[0] + 11, past[0] + 17],
             tl.FIELD_CR, nan),
            ("alone in its word", order[1], [past[1] + 5], tl.FIELD_CG, inf),
            ("across a word boundary", order[2], [edge, edge + 1],
             tl.FIELD_CB, -inf),
            ("the last listed row", order[3], [int(n[order[3]]) - 1],
             tl.FIELD_CR, -inf),
            ("position and opacity", order[4], [past[4] + 3, past[4] + 40],
             None, nan),
            ("a patch below the image", pad, [int(n[pad]) // 2], tl.FIELD_CG,
             nan)]


def planted_tail(seed: int, b, cfg, exits, n, per_tile: int) -> str:
    """Kernel 10's tail on non-finite rows planted past the exits
    (tail_plants): the mask pass's words equal the plain twin's and have
    exactly the planted rows' bits; kernel 10 with the mask equals its full
    cull bit for bit, and the chunk reference gs2d_fwd_chunk outside the
    planted channels' tiles, where it reads NaN throughout (the chunk walk
    stops at its 32-row pass's exit, so it need not reach them); the exits are
    the finite rows'. A mask pass that flags nothing, or a tail that walks
    no flagged row, leaves those channels finite. Returns the log's
    summary."""
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_dense as rdn
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import tiles as tl

    dev = b.rows.device
    plants = tail_plants(exits.reshape(-1, per_tile), n, b.start, cfg)
    rows = b.rows.clone()
    at, poison = {}, torch.zeros((3, n.numel()), dtype=torch.bool,
                                 device=dev)
    for case, t, slots, field, value in plants:
        at[case] = [int(b.start[t]) + k for k in slots]
        for i, k in enumerate(slots):
            if not 0 <= k < int(n[t]):
                raise AssertionError(f"tail plant {case}: slot {k} of "
                                     f"{int(n[t])}")
            f = field if field is not None else (tl.FIELD_PX, tl.FIELD_OP)[i]
            rows[at[case][i], f] = value
        if field is not None:
            poison[field - tl.FIELD_CR, t] = True
    flat_rows = [r for rs in at.values() for r in rs]
    bits = torch.zeros((-(-rows.shape[0] // 32) * 32,), dtype=torch.bool,
                       device=dev)
    bits[flat_rows] = True
    words = rf._nonfinite_mask_cuda(rows)
    got_bits = ((words.to(torch.int64)[:, None] >> torch.arange(
        32, device=dev)) & 1).reshape(-1).bool()
    lone = int(bits.reshape(-1, 32)[at["alone in its word"][0] // 32].sum())
    fwd_in = (rows, b.start, b.count, cfg, cfg.flat_chunk,
              cfg.flat_max_chunks)
    exits_p = torch.full_like(exits, -1)
    walked = torch.full((exits.numel(), 2), -1, dtype=torch.int32,
                        device=dev)
    c_m, t_m = rf._fwd_flat_cuda(*fwd_in, exits=exits_p)
    c_f, t_f = rf._fwd_flat_cuda(*fwd_in, walked=walked)
    c_r, t_r = rdn._fwd_chunk_cuda(flat_listed_rows(b._replace(rows=rows),
                                                    dev), n, cfg)
    torch.cuda.synchronize()
    poisoned = rd.from_tiles(poison[:, :, None, None].expand(
        -1, -1, cfg.tile_h, cfg.tile_w), cfg)
    same = {"mask words, the plain twin": torch.equal(
                words, rf._nonfinite_mask_plain(rows)),
            "mask words, the planted rows": torch.equal(got_bits, bits),
            "one bit in the lone row's word": lone == 1,
            "full cull": same_bits(c_m, c_f) and same_bits(t_m, t_f),
            "NaN exactly in the planted channels' tiles": torch.equal(
                torch.isnan(c_m), poisoned),
            "chunk reference elsewhere": (
                torch.equal(c_m[~poisoned], c_r[~poisoned])
                and same_bits(t_m, t_r)),
            "exits": torch.equal(exits_p, exits)}
    if not all(same.values()):
        raise AssertionError(f"tail seed {seed}, planted rows: {same}")
    return (f"{len(flat_rows)} planted rows ({', '.join(p[0] for p in plants)}"
            f"): the mask has exactly their bits, and kernel 10 equals the "
            f"full cull, NaN in {int(poison.sum())} planted tile channels, "
            f"the chunk reference elsewhere")


def tail_phase(dev, smi: str) -> None:
    """Kernel 10's tail after the saturation exit at 1080p/1M, three
    populations (hd-1m's draw): the mask pass's words against the plain
    twin, kernel 10 with the mask (every production call) against its full
    cull (walked given, the walk before the mask) and the chunk reference
    gs2d_fwd_chunk over the same rows, bit for bit in colour and T; each
    patch's exit slot within its run; the same on non-finite rows planted
    past the exits (planted_tail); the share of listed chunks the tail
    left unculled; render_flat's launches; then the device time of the
    forward (kernel 10 and the mask pass apart) against the full cull's and
    the mask pass's bytes bound (64 B a row of the M rows over HBM_RATE)."""
    from gs2d_tpu_torch.ops import render_dense as rdn
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import render_resident as rr
    from gs2d_tpu_torch.ops import tiles_flat as tlf

    t_phase = time.perf_counter()
    log("[tail] kernel 10 past its saturation exit (the non-finite mask) vs "
        "its full cull and the chunk reference, 1080p/1M populations")
    for seed in (0, 1, 2):
        p, cfg = hd_population(dev, 2600 + seed)
        m_cap, kc, mc = cfg.flat_capacity, cfg.flat_chunk, cfg.flat_max_chunks
        b = tlf.bin_splats_flat(p, cfg, m_cap, kc=kc, max_chunks=mc)
        if int(b.n_dropped):
            raise AssertionError(f"tail seed {seed}: pairs dropped")
        n = b.count.clamp(max=mc * kc)
        per_tile = rr.patches_per_tile(cfg, rr.patch_rows())
        patches = n.numel() * per_tile
        fwd_in = (b.rows, b.start, b.count, cfg, kc, mc)
        exits = torch.full((patches,), -1, dtype=torch.int32, device=dev)
        walked = torch.full((patches, 2), -1, dtype=torch.int32, device=dev)
        reset_counts()
        c_m, t_m = rf._fwd_flat_cuda(*fwd_in, exits=exits)
        expect_launches(f"tail seed {seed}, kernel 10", read_counts(),
                        {"fwd_flat": 1, "fwd_flat_mask": 1})
        c_f, t_f = rf._fwd_flat_cuda(*fwd_in, walked=walked)
        c_r, t_r = rdn._fwd_chunk_cuda(flat_listed_rows(b, dev), n, cfg)
        words = rf._nonfinite_mask_cuda(b.rows)
        torch.cuda.synchronize()
        same = {"full cull": same_bits(c_m, c_f) and same_bits(t_m, t_f),
                "chunk reference": (same_bits(c_m, c_r)
                                    and same_bits(t_m, t_r)),
                "mask words": torch.equal(
                    words, rf._nonfinite_mask_plain(b.rows)),
                "exits within the runs": bool(
                    ((exits >= 0) & (exits <= n.repeat_interleave(
                        per_tile))).all())}
        if not all(same.values()):
            raise AssertionError(f"tail seed {seed}: {same}")
        planted = planted_tail(seed, b, cfg, exits, n, per_tile)
        reset_counts()
        rf.render_flat(p, cfg)
        expect_launches(f"tail seed {seed}, render_flat", read_counts(),
                        {"expand_flat": 1, "fwd_flat": 1, "fwd_flat_mask": 1})
        share = skipped_share(exits, n, per_tile)
        frac = float((exits.float() / n.repeat_interleave(per_tile).clamp(
            min=1)).mean())
        log(f"  seed {2600 + seed}: tile {cfg.tile_h}x{cfg.tile_w}, M "
            f"{m_cap}, {int(n.sum())} listed pairs: equal bit for bit "
            f"(colour, T) to the full cull and the chunk reference; mask "
            f"words equal the plain twin's ({int((words != 0).sum())} set); "
            f"exit at slot {float(exits.float().mean()):.1f} of "
            f"{float(n.float().mean()):.1f} on average ({frac:.4f} of the "
            f"run), {int((exits == 0).sum())} patches saturated from the "
            f"start; chunks left unculled {share:.4f}; {planted}")
    t_m = device_time(lambda: rf._fwd_flat_cuda(*fwd_in), reps=20)
    t_f = device_time(lambda: rf._fwd_flat_cuda(*fwd_in, walked=walked),
                      reps=20)
    t_k = device_time(lambda: rf._nonfinite_mask_cuda(b.rows), reps=20)
    parts = {("mask pass" if "nonfinite_mask" in name else "kernel 10"):
             round(v[0], 5) for name, v in t_m["kernels"].items()}
    bound_ms = 1e3 * 64 * m_cap / HBM_RATE
    log(f"  the forward, kernel 10 and its mask pass: {device_line(t_m)}; "
        f"apart (profiler, ms a call) {parts} [{smi}]")
    log(f"  kernel 10 with its full cull (the walk before the mask): "
        f"{device_line(t_f)} [{smi}]")
    log(f"  the mask pass alone: {device_line(t_k)}; its bytes bound "
        f"{bound_ms:.5f} ms (64 B a row of M = {m_cap} over "
        f"{HBM_RATE / 1e12:.2f} TB/s), {bound_ms / t_k['device']:.4f} of it; "
        f"the forward {t_f['device'] / t_m['device']:.2f}x faster than the "
        f"full cull; the phase {time.perf_counter() - t_phase:.1f}s")


@contextlib.contextmanager
def walk_forced(forced: bool):
    """With ``forced``, the chunk walks' saturating walk on at any N (the
    chunked TPU kernels' exits, SAT_WALK_THRESHOLD = 1)."""
    from gs2d_tpu_torch.ops import render as rd

    threshold = rd.SAT_WALK_THRESHOLD
    if forced:
        rd.SAT_WALK_THRESHOLD = 1
    try:
        yield
    finally:
        rd.SAT_WALK_THRESHOLD = threshold


def backward_inputs(params, ref, cfg, dev, carry=None, g_color=None,
                    nan_splat=None):
    """Kernel 3's inputs on one population: the resident binning at cfg's
    K, the table (``nan_splat``'s position NaN after the forward), the
    ids, and the planes (fin, gc, cin, tin): the plain forward's colour,
    ``g_color`` (the SSIM cotangent of that render when None) and ``carry``
    (identity when None). Returns (table, ids, count, planes)."""
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_resident as rr
    from gs2d_tpu_torch.ops import tiles as tl

    n, k = params.n, cfg.max_splats_per_tile
    b = tl.bin_splats(params, cfg, k, ids_only=True)
    if int(b.n_dropped):
        raise AssertionError(f"binning dropped {int(b.n_dropped)}")
    table = rr.resident_table(params, cfg)
    ids = rr._remap_ids(b, n)
    fin = rr._fwd_resident_plain(table, ids, b.count, cfg)[0][0].contiguous()
    if nan_splat is not None:
        table.reshape(-1, tl.N_FIELDS)[nan_splat, tl.FIELD_PX] = float("nan")
    if g_color is None:
        g_color = ssim_cotangent(fin, ref, cfg)
    cin, tin = carry if carry is not None else rd.identity_carry(cfg, dev)
    return table, ids, b.count, (fin, g_color.contiguous(), cin, tin)


def backward_cases(dev) -> dict:
    """The compare populations of kernel 3, {name: (params, target, cfg,
    {backward_inputs' keywords}, walk forced, timed)}: a random population
    under a random cotangent from a non-identity carry-in (K = 256 and
    512), the opacity-1 population centred on pixel centres, saturated
    64-row tiles (the chunk walk's saturating walk forced), the pcg3d init
    of the default fit at the SSIM path's K = 256 (timed), random N=130
    with splat 40 at a NaN position, and the deep, tall 64-row case
    (timed). The dense compare reuses the first four populations."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_resident as rr
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import init_params, params_from_numpy

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
    rand = {"carry": (c_pre[0].contiguous(), t_pre[0].contiguous()),
            "g_color": torch.randn(
                (3, base.padded_height, base.padded_width),
                generator=torch.Generator(dev).manual_seed(22), device=dev)}
    p1 = population(23, 300, w, h, opacity=(1.0, 1.0))
    p1["pos"][:64] = np.floor(p1["pos"][:64]) + 0.5
    cfg_main = SplatConfig(width=w, height=h, n_splats=1024)
    p_init = init_params(cfg_main, dev)
    cfg_ssim = tl.tune_tile_height(cfg_main, p_init).replace(
        max_splats_per_tile=rd._max_per_tile(cfg_main))
    p_deep, cfg_deep, deep = deep_case(dev)
    return {
        "random + carry-in + random cotangent, K=256": (
            params_from_numpy(population(20, 600, w, h), dev), ref, base,
            rand, False, False),
        "random + carry-in + random cotangent, K=512": (
            params_from_numpy(population(20, 1500, w, h), dev), ref,
            base.replace(n_splats=1500, max_splats_per_tile=512), rand,
            False, False),
        "opacity-1 centred": (params_from_numpy(p1, dev), ref,
                              base.replace(n_splats=300), {}, False, False),
        "saturated, 64-row tiles, walk forced": (
            params_from_numpy(opaque_stack(24, 256, w, h), dev), ref,
            SplatConfig(width=w, height=h, n_splats=256, tile_h=64,
                        max_splats_per_tile=512), {}, True, False),
        "pcg3d init (SSIM path), K=256": (p_init, ref, cfg_ssim, {}, False,
                                          True),
        "random N=130, splat 40 at a NaN position": (
            params_from_numpy(population(3, 130, w, h), dev), ref,
            base.replace(n_splats=130, max_splats_per_tile=128),
            {"nan_splat": 40}, False, False),
        deep: (p_deep, ref, cfg_deep, {}, False, True),
    }


def compare_bwd_resident_case(name, params, ref, cfg, dev, inputs,
                              timed=False, smi: str = ""):
    """Kernel 3 on one population (``inputs``: backward_inputs' keywords).
    It runs twice and must repeat bit for bit; it equals the chunk
    reference (gs2d_bwd_chunk on the table rows its ids name, under the
    same planes) bit for bit, with equal NaN masks; its survivors per patch,
    and those of kernels 8/9 on the same rows, are the plain cull mask's
    (patch_cover_mask); and it agrees with its plain version (not compared
    with a NaN splat: both give NaNs there). A timed case also times
    kernels 8/9 and the chunk reference on the same rows and splits kernels
    3 and 8/9 into the patch kernel and the patch sum. Returns
    (max_abs_err, times or None)."""
    from gs2d_tpu_torch.ops import render_dense as rdn
    from gs2d_tpu_torch.ops import render_resident as rr

    n, k = params.n, cfg.max_splats_per_tile
    table, ids, count, planes = backward_inputs(params, ref, cfg, dev,
                                                **inputs)
    args = (table, ids, count, *planes, n, cfg)
    tp = gathered_rows(table, ids)
    dense_in = (tp, ids, count, *planes, n, cfg)
    m_k = rr._bwd_resident_cuda(*args)
    m_k2 = rr._bwd_resident_cuda(*args)
    _, g_ch = rdn._bwd_chunk_cuda(*dense_in)
    torch.cuda.synchronize()
    if not same_bits(m_k2, m_k):
        raise AssertionError(f"{name}: bwd_resident does not repeat bit for "
                             "bit")
    if not same_bits(m_k[:9, :n], g_ch):
        raise AssertionError(f"{name}: kernel 3 differs from the chunk "
                             "reference")
    note_reference("bwd_chunk", (m_k[:9, :n],), (g_ch,))
    mask = rr.patch_cover_mask(table, ids, count, cfg, rr.patch_rows())
    want = mask.sum(dim=-1).reshape(-1).to(torch.int32)
    walked = patch_survivors({
        "kernel 3": lambda w: rr._bwd_resident_cuda(*args, walked=w),
        "kernels 8/9": lambda w: rdn._bwd_dense_cuda(*dense_in, walked=w)},
        want, dev)
    n_nan = int(torch.isnan(g_ch).sum())
    log(f"  {name}: N={n} K={k} tile {cfg.tile_h}x{cfg.tile_w} max_count="
        f"{int(count.max())} | kernel 3 repeats and equals the chunk "
        f"reference bit for bit (moments; NaN in {n_nan}); (patch, slot) "
        f"steps {int(count.sum()) * mask.shape[1]}, survivors "
        f"{int(want.sum())} (plain mask, equal patch by patch in kernel 3 "
        f"and in kernels 8/9 on the same rows), walked "
        f"{walked['kernel 3']}")
    if "nan_splat" in inputs:
        if not n_nan or not torch.isfinite(g_ch).any():
            raise AssertionError(f"{name}: not the case it should be")
        return 0.0, None
    require_finite(name, moments=m_k)
    m_p, plain_ms = timed_call(lambda: rr._bwd_resident_plain(*args))
    ratio = moment_ratio(m_k, m_p)
    err, scale = grad_error(m_k, m_p, n, rr._table_fields(table, n))
    log(f"  {name}: bwd_resident vs plain: moment err/tol {ratio:.3g}, grad "
        f"err {err:.3g} of |grad| max {scale:.3g}")
    if ratio > 1.0:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    if not timed:
        return err, None
    work = live_work(tp, count, cfg)
    bwd_bytes = nbytes(table, ids, count, *planes, m_k)
    dense_bytes = nbytes(tp, ids, count, *planes, g_ch)
    for what, fn, parts in (
            ("kernel 3", lambda: rr._bwd_resident_cuda(*args),
             BWD_RESIDENT_PARTS),
            ("kernels 8/9", lambda: rdn._bwd_dense_cuda(*dense_in),
             BWD_DENSE_PARTS)):
        log_split(f"{what} at {name}", kernel_split(fn, parts), parts, smi)
    return err, {
        "bwd_resident": timed_entry(
            lambda: rr._bwd_resident_cuda(*args), plain_ms, "bwd", work, cfg,
            bwd_bytes),
        "bwd_dense, same rows (plain ms: kernel 3's)": timed_entry(
            lambda: rdn._bwd_dense_cuda(*dense_in), plain_ms, "bwd", work,
            cfg, dense_bytes),
        BWD_CHUNK_TIMES: timed_entry(
            lambda: rdn._bwd_chunk_cuda(*dense_in), plain_ms, "bwd", work,
            cfg, dense_bytes),
    }


def compare_dense_case(name, params, ref, cfg, dev, carry=None,
                       g_color=None, timed=(), smi: str = ""):
    """The three dense kernels vs their plain versions on one population at
    cfg's K: the forward, the backward under ``g_color`` (3, Hp, Wp; the
    SSIM cotangent of the render when None) from ``carry`` (identity when
    None), run twice and bit for bit, and the fused L2 step. All three are
    also held to the chunk walk bit for bit (the forward to the forward
    reference; the backward to the backward reference under the same
    planes; the L2 step to dense_vs_chain), and the forward's and the
    backward's survivors per patch to the plain cull mask
    (listed_cover_mask of the tile_params). Returns ({kernel: max_abs_err},
    {kernel: times} for the kernels in ``timed``, a timed forward with the
    forward reference's beside it; a timed L2 step also gets its survivors
    and its split logged)."""
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_dense as rdn
    from gs2d_tpu_torch.ops import render_resident as rr
    from gs2d_tpu_torch.ops import tiles as tl

    n, k = params.n, cfg.max_splats_per_tile
    b = tl.bin_splats(params, cfg, k)
    if int(b.n_dropped):
        raise AssertionError(f"{name}: binning dropped {int(b.n_dropped)}")
    tp, ids, count = b.tile_params, b.ids, b.count
    ref_chw = rd.pad_ref_chw(ref, cfg, dev)
    c_k, t_k = rdn._fwd_dense_cuda(tp, count, cfg)
    c_ch, t_ch = rdn._fwd_chunk_cuda(tp, count, cfg)
    (c_p, t_p), fwd_plain_ms = timed_call(
        lambda: rdn._fwd_dense_plain(tp, count, cfg))
    if g_color is None:
        g_color = ssim_cotangent(c_p, ref, cfg)
    cin, tin = carry if carry is not None else rd.identity_carry(cfg, dev)
    bwd_in = (tp, ids, count, c_p, g_color.contiguous(), cin, tin, n, cfg)
    m_k, g_k = rdn._bwd_dense_cuda(*bwd_in)
    m_k2, g_k2 = rdn._bwd_dense_cuda(*bwd_in)
    m_k, m_k2 = slot_sums(m_k, count, cfg), slot_sums(m_k2, count, cfg)
    m_ch, g_ch = rdn._bwd_chunk_cuda(*bwd_in)
    mask = rr.listed_cover_mask(tp, count, cfg, rr.patch_rows())
    want = mask.sum(dim=-1).reshape(-1).to(torch.int32)
    walked = patch_survivors({"kernels 8/9": lambda w: rdn._bwd_dense_cuda(
        *bwd_in, walked=w)}, want, dev)["kernels 8/9"]
    walked_fwd = patch_survivors({
        "kernels 6/7": lambda w: rdn._fwd_dense_cuda(tp, count, cfg,
                                                     walked=w)},
        want, dev)["kernels 6/7"]
    (m_p, g_p), bwd_plain_ms = timed_call(
        lambda: rdn._bwd_dense_plain(*bwd_in))
    l2_in = (tp, ids, count, ref_chw, n, cfg)
    l2_k = rdn._l2_dense_cuda(*l2_in)
    l2_k = (l2_k[0], slot_sums(l2_k[1], count, cfg), l2_k[2])
    l2_p, l2_plain_ms = timed_call(lambda: rdn._l2_dense_plain(*l2_in))
    chained = dense_vs_chain(*l2_in)
    torch.cuda.synchronize()
    require_finite(name, color=c_k, T=t_k, moments=m_k, l2_color=l2_k[0],
                   l2_moments=l2_k[2])
    if not (torch.equal(m_k, m_k2) and torch.equal(g_k, g_k2)):
        raise AssertionError(f"{name}: bwd_dense does not repeat bit for "
                             "bit")
    replayed = torch.equal(m_k, m_ch) and torch.equal(g_k, g_ch)
    forward = same_bits(c_k, c_ch) and same_bits(t_k, t_ch)
    note_reference("fwd_chunk", (c_k, t_k), (c_ch, t_ch))
    note_reference("bwd_chunk", (m_k, g_k), (m_ch, g_ch))
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
        f"err {fwd_err:.3g}, equals the forward reference bit for bit "
        f"(colour, T): {forward}, walked {walked_fwd} | bwd: moment err/tol "
        f"{ratios['bwd']:.3g}, grad "
        f"err {bwd_err:.3g} of {bwd_scale:.3g}, repeats bit for bit, equals "
        f"the chunk reference bit for bit (slot sums, moments): {replayed}; "
        f"(patch, slot) steps {int(count.sum()) * mask.shape[1]}, survivors "
        f"{int(want.sum())} (plain mask, equal patch by patch), walked "
        f"{walked} | l2: color err {l2_col:.3g}, moment err/tol "
        f"{ratios['l2']:.3g}, grad err {l2_err:.3g} of {l2_scale:.3g}; "
        f"equals the chunk walk (6/7, gC, then the chunk reference) bit for "
        f"bit: {chained}")
    if max(fwd_err, l2_col) > COLOR_ATOL or max(ratios.values()) > 1.0:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    if not chained:
        raise AssertionError(f"{name}: kernel 4/5 differs from the chunk "
                             "walk")
    if not forward:
        raise AssertionError(f"{name}: kernel 6/7 differs from the forward "
                             "reference")
    if not replayed:
        raise AssertionError(f"{name}: kernel 8/9 differs from the chunk "
                             "reference")
    errs = {"fwd_dense": fwd_err, "bwd_dense": bwd_err,
            "l2_dense": max(l2_col, l2_err)}
    if not timed:
        return errs, {}
    if "l2_dense" in timed:
        dense_l2_report(name, *l2_in, dev, smi)
    work = live_work(tp, count, cfg)
    base = nbytes(tp, ids, count)
    fwd_bytes = nbytes(tp, count, c_k, t_k)
    entries = {
        "fwd_dense": lambda: timed_entry(
            lambda: rdn._fwd_dense_cuda(tp, count, cfg), fwd_plain_ms, "fwd",
            work, cfg, fwd_bytes),
        FWD_CHUNK_TIMES: lambda: timed_entry(
            lambda: rdn._fwd_chunk_cuda(tp, count, cfg), fwd_plain_ms, "fwd",
            work, cfg, fwd_bytes),
        "bwd_dense": lambda: timed_entry(
            lambda: rdn._bwd_dense_cuda(*bwd_in), bwd_plain_ms, "bwd", work,
            cfg, base + nbytes(c_p, g_color, cin, tin, g_k)),
        "l2_dense": lambda: timed_entry(
            lambda: rdn._l2_dense_cuda(*l2_in), l2_plain_ms, "l2", work, cfg,
            base + nbytes(ref_chw, l2_k[0], l2_k[2])),
    }
    if "fwd_dense" in timed:
        timed = (*timed, FWD_CHUNK_TIMES)
    return errs, {kk: entries[kk]() for kk in timed}


# Kernels 4/5 and 12's two kernels (csrc/render_dense.cu,
# csrc/render_resident.cu), for their time split.
L2_DENSE_PARTS = ("l2_dense_kernel", "patch_sum_kernel")
L2_WINDOW_PARTS = ("l2_resident_kernel", "patch_sum_kernel")


def log_split(what: str, split: dict, parts, smi: str) -> None:
    log(f"  {what} split (device ms a launch, torch.profiler, "
        f"{split['seen']} of 10 calls' launches seen): "
        + ", ".join(f"{x} {split[x]:.4f}" for x in parts)
        + f"; device {split['device']:.4f}, CUDA events "
        f"{split['events']:.4f} ms a call [{smi}]")


def dense_l2_report(name, tp, ids, count, ref_chw, n, cfg, dev,
                    smi: str) -> None:
    """Kernel 4/5's survivors per patch against the plain cull mask of the
    dense rows (listed_cover_mask), its time split into the patch kernel
    and the patch sum, and the chunk walk's time on the same inputs."""
    from gs2d_tpu_torch.ops import render_dense as rdn
    from gs2d_tpu_torch.ops import render_resident as rr

    mask = rr.listed_cover_mask(tp, count, cfg, rr.patch_rows())
    want = mask.sum(dim=-1).reshape(-1).to(torch.int32)
    walked = patch_survivors({"kernels 4/5": lambda w: rdn._l2_dense_cuda(
        tp, ids, count, ref_chw, n, cfg, walked=w)}, want, dev)
    log(f"  {name}: (patch, slot) steps {int(count.sum()) * mask.shape[1]}, "
        f"survivors {int(want.sum())} (plain mask, equal patch by patch in "
        f"kernels 4/5), walked before the saturation exit "
        f"{walked['kernels 4/5']}")
    split = kernel_split(lambda: rdn._l2_dense_cuda(tp, ids, count, ref_chw,
                                                    n, cfg), L2_DENSE_PARTS)
    log_split(f"kernels 4/5 at {name}", split, L2_DENSE_PARTS, smi)
    t = read_device_time("chain", lambda: chain(tp, ids, count, ref_chw, n,
                                                cfg), 20)
    log(f"  the chunk walk (the forward reference, gC, then the backward "
        f"reference) on the same inputs: {device_line(t)} [{smi}]")


def compare_new(dev, smi: str):
    """The compare cases of kernel 3 (backward_cases, each also against the
    chunk reference) and of the dense kernels on the same populations: the
    random one under a random cotangent from a non-identity carry-in (K =
    256 and K = 512, so both members of each dense pair run), the opacity-1
    one, saturated 64-row tiles with the walk forced, and the pcg3d init of
    the default fit (timed: kernel 3 and the dense forward and backward at
    the SSIM path's K = 256, the dense L2 step at the L2 fit's tuned K =
    512). Returns (max errors, times)."""
    from gs2d_tpu_torch.ops import tiles as tl

    log("[compare] bwd_resident and the dense kernels vs plain PyTorch and "
        "the chunk reference")
    errs = {"bwd_resident": 0.0, "fwd_dense": 0.0, "bwd_dense": 0.0,
            "l2_dense": 0.0}
    times = {}

    def add(e, t):
        for kk, v in e.items():
            errs[kk] = max(errs[kk], v)
        times.update(t or {})

    cases = backward_cases(dev)
    for name, (p, ref, cfg, inputs, forced, timed) in cases.items():
        with walk_forced(forced):
            e, t = compare_bwd_resident_case(name, p, ref, cfg, dev, inputs,
                                             timed, smi)
            # The kernels' line takes kernel 3's time at the SSIM path's
            # init; the deep case's is logged only.
            if "nan_splat" not in inputs:
                add({"bwd_resident": e}, t if name.startswith("pcg3d")
                    else None)
            if timed:
                log_times(t, f"at {name}", smi)
            if name.startswith(("random", "opacity", "saturated")) \
                    and "nan_splat" not in inputs:
                add(*compare_dense_case(
                    name, p, ref, cfg.replace(binning="dense"), dev,
                    carry=inputs.get("carry"),
                    g_color=inputs.get("g_color")))
    p_init, ref, cfg_ssim, _, _, _ = cases["pcg3d init (SSIM path), K=256"]
    e, t = compare_dense_case("pcg3d init (SSIM path), K=256", p_init, ref,
                              cfg_ssim.replace(binning="dense"), dev,
                              timed=("fwd_dense", "bwd_dense"))
    add(e, t)
    cfg_main = cfg_ssim.replace(max_splats_per_tile=None)
    cfg_l2 = tl.tune_tile_capacity(p_init, cfg_main).replace(binning="dense")
    e, t = compare_dense_case(
        f"pcg3d init (L2 path), K={cfg_l2.max_splats_per_tile}", p_init, ref,
        cfg_l2, dev, timed=("l2_dense",), smi=smi)
    add(e, t)
    log_times({kk: times[kk] for kk in ("fwd_dense", FWD_CHUNK_TIMES,
                                        "bwd_dense", "l2_dense")},
              "at the default fit's init", smi)
    return errs, times


def compare_dense_10k(dev, smi: str) -> dict:
    """Kernel 4/5 at the 10k fit's init on the dense binning the
    ``--binning dense`` fit tunes (K = 1024): against its plain version and
    the chunk walk, with its survivors and its split. Returns its times."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import init_params

    log("[compare] dense L2 kernels 4/5 at the 10k init vs plain PyTorch "
        "and the chunk walk")
    full = load_image(FULL)
    cfg = SplatConfig(width=full.shape[1], height=full.shape[0],
                      n_splats=N_10K)
    p = init_params(cfg, dev)
    cfg = tl.tune_tile_capacity(p, tl.tune_tile_height(cfg, p)).replace(
        binning="dense")
    _, times = compare_dense_case(
        f"pcg3d init 10240, K={cfg.max_splats_per_tile}", p, full, cfg, dev,
        timed=("l2_dense",), smi=smi)
    log_times(times, "at the 10k init", smi)
    return times


def deep_tall(seed: int, n: int, width: int, height: int) -> dict:
    """n wide, faint splats over the whole image: every 32-row tile lists
    nearly all of them (deep) and each spans many tile rows (tall), so
    tiles.tune_tile_height picks 64-row tiles for a resident population."""
    rng = np.random.default_rng(seed)
    d = {"pos": np.stack([rng.uniform(0.0, width, n),
                          rng.uniform(0.0, height, n)], -1),
         "sx": rng.uniform(60.0, 100.0, n), "sy": rng.uniform(60.0, 100.0, n),
         "rot": rng.uniform(0.0, np.pi, n),
         "color": rng.uniform(0.0, 1.0, (n, 3)),
         "opacity": rng.uniform(0.01, 0.05, n)}
    return {k: v.astype(np.float32) for k, v in d.items()}


def deep_case(dev):
    """The deep, tall population of 2600 splats on the default target, for
    which tune_tile_height picks 64-row tiles, at K = its fullest tile
    rounded up to 256. Returns (params, cfg, name)."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import params_from_numpy

    h, w = load_image(MINI).shape[:2]
    n = 2600
    p = params_from_numpy(deep_tall(40, n, w, h), dev)
    cfg = tl.tune_tile_height(SplatConfig(width=w, height=h, n_splats=n), p)
    if cfg.tile_h != 64:
        raise AssertionError(f"tune_tile_height picked {cfg.tile_h} rows")
    b = tl.bin_splats(p, cfg, 4096, ids_only=True)
    cfg = cfg.replace(max_splats_per_tile=-(-int(b.count.max()) // 256)
                      * 256)
    return p, cfg, f"deep, tall, N={n}, 64-row tiles"


def compare_resident64(dev, smi: str):
    """Kernels 1 and 2 on 64x128 tiles, walked in two 32-row passes, on the
    deep case (kernel 3's is one of backward_cases). Returns (max errors,
    times)."""
    from gs2d_tpu_torch.io.image import load_image

    log("[compare] resident kernels 1 and 2 on 64x128 tiles vs plain "
        "PyTorch")
    p, cfg, name = deep_case(dev)
    errs, times = compare_case(name, p, load_image(MINI), cfg, dev,
                               timed=True)
    log_times(times, f"on 64-row tiles (K={cfg.max_splats_per_tile})", smi)
    return errs, times


def window_population(dev):
    """The window fit's population and target: the pcg3d init of 8192
    splats on squirrel_cls (535x426), Morton-reordered, at 32-row tiles.
    Returns (state, cfg with binning "window", target)."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.train.loop import init_train_state
    from gs2d_tpu_torch.train.reorder import reorder_state

    full = load_image(FULL)
    h, w = full.shape[:2]
    cfg = SplatConfig(width=w, height=h, n_splats=N_WINDOW, tile_h=32,
                      binning="window")
    return reorder_state(init_train_state(cfg, dev), cfg), cfg, full


def escaped_numpy(ids, n: int, width: int) -> int:
    """Live ids past their tile's window, counted in numpy."""
    ids = ids.cpu().numpy()
    live = ids >= 0
    min_id = np.where(live, ids, n).min(axis=1)
    n_pad = -(-n // 128) * 128
    base = np.clip((min_id // 128) * 128, 0, max(n_pad - width, 0))
    return int((live & (ids >= base[:, None] + width)).sum())


def compare_window(dev, smi: str):
    """Kernel 12 on the window fit's population at K and W tuned as fit
    tunes them, at three widths: W = n_pad (also against the chunk walk,
    vs_chain) and the tuned W (no escape: colour and moments equal kernel
    1's bit for bit; the tuned W timed, split, and its survivors against
    the plain cull mask) and W = 128 (escapes: their count equals a numpy
    count, the colour kernel 1's). Each against its plain version. Returns
    (max error, times, cfg)."""
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_resident as rr
    from gs2d_tpu_torch.ops import render_window as rw
    from gs2d_tpu_torch.ops import tiles as tl

    log("[compare] window kernel 12 vs kernel 1 and plain PyTorch")
    state, cfg, full = window_population(dev)
    p, n = state.params, N_WINDOW
    cfg = rw.tune_window(p, tl.tune_tile_capacity(p, cfg))
    k, tuned = cfg.max_splats_per_tile, cfg.window_width
    b = tl.bin_splats(p, cfg, k, ids_only=True)
    if int(b.n_dropped):
        raise AssertionError(f"window population: binning dropped "
                             f"{int(b.n_dropped)}")
    table = rr.resident_table(p, cfg)
    ids = rr._remap_ids(b, n)
    ref_chw = rd.pad_ref_chw(full, cfg, dev)
    c_r, g_r = rr._l2_resident_cuda(table, ids, b.count, ref_chw, n, cfg)
    vs_chain(f"window init, K={k}", table, ids, b.count, ref_chw, n, cfg)
    err, times = 0.0, {}
    fields = rr._table_fields(table, n)
    for label, width in (("n_pad", rw._n_pad(n)), ("tuned", tuned),
                         ("escapes", 128)):
        bases, escaped = rw.window_bases(b, n, width)
        args = (table, ids, b.count, bases, ref_chw, n, cfg, width)
        c_w, g_w = rw._l2_window_cuda(*args)
        (c_p, g_p), plain_ms = timed_call(
            lambda: rw._l2_window_plain(*args))
        require_finite(label, color=c_w, moments=g_w)
        want = escaped_numpy(b.ids, n, width)
        col_err = float((c_w - c_p).abs().max())
        ratio = moment_ratio(g_w, g_p)
        g_err, g_scale = grad_error(g_w, g_p, n, fields)
        same = torch.equal(g_w, g_r)
        log(f"  W = {width} ({label}): N={n} K={k} tiles={cfg.n_tiles_y}x"
            f"{cfg.n_tiles_x} max_count={int(b.count.max())} escaped "
            f"{int(escaped)} (numpy {want}) | colour equals kernel 1's: "
            f"{torch.equal(c_w, c_r)}, moments equal kernel 1's: {same} | "
            f"vs plain: colour err {col_err:.3g}, moment err/tol "
            f"{ratio:.3g}, grad err {g_err:.3g} of |grad| max "
            f"{g_scale:.3g}")
        if int(escaped) != want or not torch.equal(c_w, c_r):
            raise AssertionError(f"{label}: escapes or colour wrong")
        if want == 0 and not same:
            raise AssertionError(f"{label}: no escape, but the moments "
                                 "differ from kernel 1's")
        if col_err > COLOR_ATOL or ratio > 1.0:
            raise AssertionError(f"{label}: kernel disagrees with plain "
                                 "version")
        err = max(err, col_err, g_err)
        if label == "tuned":
            mask = rr.patch_cover_mask(table, ids, b.count, cfg,
                                       rr.patch_rows())
            want = mask.sum(dim=-1).reshape(-1).to(torch.int32)
            walked = patch_survivors({
                "kernel 12": lambda w: rw._l2_window_cuda(*args, walked=w),
                "kernel 1": lambda w: rr._l2_resident_cuda(
                    table, ids, b.count, ref_chw, n, cfg, walked=w)},
                want, dev)
            log(f"  W = {width}: (patch, slot) steps "
                f"{int(b.count.sum()) * mask.shape[1]}, survivors "
                f"{int(want.sum())} (plain mask, equal patch by patch in "
                f"kernel 12, kernel 1), walked before the saturation exit "
                f"{walked['kernel 12']}")
            log_split(f"kernel 12 at W = {width}", kernel_split(
                lambda: rw._l2_window_cuda(*args), L2_WINDOW_PARTS),
                L2_WINDOW_PARTS, smi)
            work = live_work(table.reshape(-1, tl.N_FIELDS)[ids.long()],
                             b.count, cfg)
            times["l2_window"] = timed_entry(
                lambda: rw._l2_window_cuda(*args), plain_ms, "l2", work, cfg,
                nbytes(table, ids, b.count, bases, ref_chw, c_w, g_w))
            times["l2_resident, same inputs"] = timed_entry(
                lambda: rr._l2_resident_cuda(table, ids, b.count, ref_chw, n,
                                             cfg),
                timed_call(lambda: rr._l2_resident_plain(
                    table, ids, b.count, ref_chw, n, cfg))[1], "l2", work,
                cfg, nbytes(table, ids, b.count, ref_chw, c_r, g_r))
    log_times(times, f"at the window fit's init (K={k}, W={tuned})", smi)
    return err, times, cfg


# Kernel 13's three kernels (csrc/render_mxu.cu, render_resident.cu), for
# its time split.
MXU_PARTS = ("l2_mxu_kernel", "mxu_combine_kernel", "segment_sum_kernel")


def mxu_vs_chunk(name, args) -> tuple:
    """Kernel 13 against its reference (gs2d_l2_mxu_chunk) on one input,
    bit for bit: colour, per-(tile, slot) rows and gradients, NaN masks
    included. Returns the reference's outputs."""
    from gs2d_tpu_torch.ops import render_mxu as rm

    got = rm._l2_mxu_cuda(*args)
    want = rm._l2_mxu_chunk_cuda(*args)
    torch.cuda.synchronize()
    same = {what: same_bits(g, w) for what, g, w in
            zip(("colour", "rows", "gradients"), got, want)}
    if not all(same.values()):
        raise AssertionError(f"{name}: kernel 13 differs from its "
                             f"reference: {same}")
    note_reference("l2_mxu_chunk", got, want)
    log(f"  {name}: kernel 13 equals its reference (gs2d_l2_mxu_chunk) bit "
        f"for bit (colour, rows, gradients; NaN in "
        f"{int(torch.isnan(want[0]).sum())} colour values, "
        f"{int(torch.isnan(want[2]).sum())} gradients)")
    return want


def nan_forward_args(dev):
    """Kernel 13's arguments (6/7 take tile_params, count and cfg of them)
    on the random N=130 population of compare_nan_case, dense binning at K
    = 128, with a NaN position for the first splat of tile 0 whose row walk
    meets the tile's rows: a NaN position's cover is column 0 of those
    rows, where its alpha is NaN, so the forward's colour and T hold NaNs
    (splat 40's cover misses column 0)."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import params_from_numpy

    ref = load_image(MINI)
    h, w = ref.shape[:2]
    cfg = SplatConfig(width=w, height=h, n_splats=130, tile_h=32,
                      max_splats_per_tile=128, binning="dense")
    b = tl.bin_splats(params_from_numpy(population(3, 130, w, h), dev), cfg,
                      128)
    py, hh = b.tile_params[0, :, tl.FIELD_PY], b.tile_params[0, :, tl.FIELD_H]
    meets = ((py - hh).trunc() <= cfg.tile_h - 1) & ((py + hh).trunc() >= 0)
    slot = int(torch.nonzero(meets[: int(b.count[0])])[0, 0])
    tp = b.tile_params.clone()
    tp[b.ids == b.ids[0, slot], tl.FIELD_PX] = float("nan")
    return (tp, b.ids, b.count, rd.pad_ref_chw(ref, cfg, dev), 130, cfg, 128)


def compare_nan_forward(dev) -> None:
    """Kernels 6/7 against the forward reference bit for bit on
    nan_forward_args' population, equal NaN masks, NaNs in T required."""
    from gs2d_tpu_torch.ops import render_dense as rdn

    tp, _, count, _, _, cfg, _ = nan_forward_args(dev)
    got = rdn._fwd_dense_cuda(tp, count, cfg)
    want = rdn._fwd_chunk_cuda(tp, count, cfg)
    torch.cuda.synchronize()
    if not (same_bits(got[0], want[0]) and same_bits(got[1], want[1])):
        raise AssertionError("NaN forward: kernels 6/7 differ from the "
                             "forward reference")
    if not (torch.isnan(want[1]).any() and torch.isfinite(want[1]).any()):
        raise AssertionError("NaN forward: not the case it should be")
    note_reference("fwd_chunk", got, want)
    log(f"  random N=130, a tile-0 splat at a NaN position: kernels 6/7 "
        f"equal the forward reference bit for bit (colour, T; NaN in "
        f"{int(torch.isnan(want[0]).sum())} colour values, "
        f"{int(torch.isnan(want[1]).sum())} T values)")


def compare_mxu(dev, smi: str):
    """Kernel 13 at the default fit's init (268x213, 1024 splats, K = 512,
    chunk 256) against its plain version, against kernel 4 (the dense L2
    kernel) on the same binning and against its reference (mxu_vs_chunk),
    its survivors per patch against the plain cull mask
    (listed_cover_mask); kernel 13 and the reference timed, 13 split. The
    reference gate also runs on 64-row tiles at the same init and on
    nan_forward_args' population (NaNs in colour and gradients). Returns
    (max error, times, the binning's inputs for the entry-point run)."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_dense as rdn
    from gs2d_tpu_torch.ops import render_mxu as rm
    from gs2d_tpu_torch.ops import render_resident as rr
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import FIELDS, init_params

    log("[compare] MXU-form kernel 13 vs plain PyTorch, kernel 4 and its "
        "reference")
    ref = load_image(MINI)
    h, w = ref.shape[:2]
    cfg = SplatConfig(width=w, height=h, n_splats=1024)
    p = init_params(cfg, dev)
    cfg = tl.tune_tile_capacity(p, tl.tune_tile_height(cfg, p)).replace(
        binning="dense")
    n, k, kc = p.n, cfg.max_splats_per_tile, 256
    b = tl.bin_splats(p, cfg, k)
    if int(b.n_dropped):
        raise AssertionError(f"mxu: binning dropped {int(b.n_dropped)}")
    ref_chw = rd.pad_ref_chw(ref, cfg, dev)
    args = (b.tile_params, b.ids, b.count, ref_chw, n, cfg, kc)
    c_k, rows_k, g_k = rm._l2_mxu_cuda(*args)
    c_k2, rows_k2, g_k2 = rm._l2_mxu_cuda(*args)
    (c_p, rows_p, g_p), plain_ms = timed_call(
        lambda: rm._l2_mxu_plain(*args))
    c_d, _, m_d = rdn._l2_dense_cuda(b.tile_params, b.ids, b.count, ref_chw,
                                     n, cfg)
    torch.cuda.synchronize()
    require_finite("mxu", color=c_k, rows=rows_k, grads=g_k)
    if not (torch.equal(c_k, c_k2) and torch.equal(g_k, g_k2)):
        raise AssertionError("l2_mxu does not repeat bit for bit")
    col_err = float((c_k - c_p).abs().max())
    ratio = max(moment_ratio(rows_k, rows_p), moment_ratio(g_k, g_p)) \
        * GRAD_RTOL / MXU_PLAIN_RTOL
    g_err = float((g_k - g_p).abs().max())
    g_mxu = rd.unpack_moments(g_k, n)
    g_dense = rd.moments_to_grads(rd.unpack_moments(m_d, n),
                                  tl.packed_fields(p, cfg.splat_bounds))
    d_col = float((c_k - c_d).abs().max())
    d_ratio = max(float((getattr(g_mxu, f) - getattr(g_dense, f)).abs().max())
                  / (MXU_GRAD_RTOL * max(1.0, float(getattr(
                      g_dense, f).abs().max()))) for f in FIELDS)
    log(f"  pcg3d init: N={n} K={k} kc={kc} tiles={cfg.n_tiles_y}x"
        f"{cfg.n_tiles_x} max_count={int(b.count.max())} | vs plain: colour "
        f"err {col_err:.3g} (tol {COLOR_ATOL}), gradient err/tol {ratio:.3g} "
        f"(tol {MXU_PLAIN_RTOL} of each field's scale), max |grad err| "
        f"{g_err:.3g}, repeats bit for bit | vs kernel 4: colour err "
        f"{d_col:.3g} (tol {MXU_COLOR_ATOL}), gradient err/tol {d_ratio:.3g} "
        f"(tol {MXU_GRAD_RTOL} * max(1, |g|))")
    if col_err > COLOR_ATOL or ratio > 1.0:
        raise AssertionError("l2_mxu disagrees with its plain version")
    if d_col > MXU_COLOR_ATOL or d_ratio > 1.0:
        raise AssertionError("l2_mxu disagrees with kernel 4")
    mxu_vs_chunk(f"pcg3d init, 32-row tiles, K={k}", args)
    cfg64 = tl.tune_tile_capacity(p, cfg.replace(
        tile_h=64, max_splats_per_tile=None)).replace(binning="dense")
    b64 = tl.bin_splats(p, cfg64, cfg64.max_splats_per_tile)
    if int(b64.n_dropped):
        raise AssertionError(f"mxu: binning dropped {int(b64.n_dropped)}")
    mxu_vs_chunk(f"pcg3d init, 64-row tiles, K={cfg64.max_splats_per_tile}",
                 (b64.tile_params, b64.ids, b64.count,
                  rd.pad_ref_chw(ref, cfg64, dev), n, cfg64,
                  min(kc, cfg64.max_splats_per_tile)))
    want = mxu_vs_chunk("random N=130, a tile-0 splat at a NaN position, "
                        "K=128", nan_forward_args(dev))
    if not all(torch.isnan(x).any() and torch.isfinite(x).any()
               for x in (want[0], want[2])):
        raise AssertionError("mxu NaN case: not the case it should be")
    mask = rr.listed_cover_mask(b.tile_params, b.count, cfg, rr.patch_rows())
    want = mask.sum(dim=-1).reshape(-1).to(torch.int32)
    walked = patch_survivors({"kernel 13": lambda wk: rm._l2_mxu_cuda(
        *args, walked=wk)}, want, dev)["kernel 13"]
    steps = int(b.count.sum()) * mask.shape[1]
    log(f"  pcg3d init: (patch, slot) steps {steps}, survivors "
        f"{int(want.sum())} (plain mask, equal patch by patch in kernel 13), "
        f"walked before the saturation exit {walked}")
    log_split("kernel 13 at the default init", kernel_split(
        lambda: rm._l2_mxu_cuda(*args), MXU_PARTS), MXU_PARTS, smi)
    work = live_work(b.tile_params, b.count, cfg)
    n_bytes = nbytes(b.tile_params, b.ids, b.count, ref_chw, c_k, g_k)
    times = {"l2_mxu": timed_entry(
        lambda: rm._l2_mxu_cuda(*args), plain_ms, "mxu", work, cfg, n_bytes),
        MXU_CHUNK_TIMES: timed_entry(
            lambda: rm._l2_mxu_chunk_cuda(*args), plain_ms, "mxu", work, cfg,
            n_bytes)}
    log_times(times, f"at the default fit's init (K={k}, kc={kc})", smi)
    return max(col_err, g_err), times, (b, ref_chw, n, cfg)


def mxu_entry_phase(inputs) -> dict:
    """The MXU-form step through its entry point, l2_render_and_grads_mxu,
    as a user calls it, the launch counts set to 0 just before and read
    just after. Returns the counts."""
    from gs2d_tpu_torch.ops import render_mxu as rm
    from gs2d_tpu_torch.params import FIELDS

    b, ref_chw, n, cfg = inputs
    log("[entry] render_mxu.l2_render_and_grads_mxu at the default init")
    reset_counts()
    color, grads = rm.l2_render_and_grads_mxu(b, ref_chw, n, cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    require_finite("l2_render_and_grads_mxu", render=color,
                   **{f"d/d{f}": getattr(grads, f) for f in FIELDS})
    if color.shape != (cfg.height, cfg.width, 3) or grads.pos.shape != (n, 2):
        raise AssertionError("l2_render_and_grads_mxu: wrong shapes")
    expect_launches("MXU entry point", launches, {"l2_mxu": 1})
    log(f"  launches: { {k: v for k, v in launches.items() if v} }; colour "
        f"{tuple(color.shape)}, gradients of {n} splats, finite")
    return launches


def window_fit_phase(dev, smi: str, runs: int = 2):
    """The window layout through train.loop.fit (K and W tuned by fit) and
    the resident fit of the same reordered population, each logged at
    every step with the launch counts set to 0 just before and read just
    after; then ``runs`` timed fits of each without a per-step sync (the
    statics tuned beforehand, as the CLI does). Gates: the two MSE
    trajectories are equal bit for bit up to the first step with an
    escaped pair, and iterations 0, 1 and 9 are gs2d_tpu's scan path's.
    Returns (window launches, resident launches, the window fit's timed
    it/s, its {iter: mse})."""
    from gs2d_tpu_torch.ops import render_window as rw
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.train.loop import fit

    state, cfg, full = window_population(dev)
    log(f"[fit] train.loop.fit, binning window: squirrel_cls "
        f"{cfg.width}x{cfg.height}, {cfg.n_splats} Morton-reordered splats, "
        "tile_h 32, L2, 200 iterations")

    def logged(binning):
        reset_counts()
        _, hist = fit(full, cfg.replace(binning=binning), 200, dev,
                      state=state, log_every=1, log_fn=None)
        torch.cuda.synchronize()
        return read_counts(), hist

    launches_w, hist_w = logged("window")
    launches_r, hist_r = logged("resident")
    expect_launches("window fit", launches_w, {"l2_window": 200})
    expect_launches("resident fit of the window population", launches_r,
                    {"l2_resident": 200})
    mse = {r["iter"]: r["mse"] for r in hist_w}
    mse_r = {r["iter"]: r["mse"] for r in hist_r}
    if len(mse) != 200 or not all(np.isfinite(list(mse.values()))):
        raise AssertionError("window trajectory incomplete or non-finite")
    escapes = [rw_["n_dropped"] - rr_["n_dropped"]
               for rw_, rr_ in zip(hist_w, hist_r)]
    first = next((i for i, e in enumerate(escapes) if e), 200)
    equal = all(mse[i] == mse_r[i] for i in range(min(first + 1, 200)))
    tuned = rw.tune_window(state.params,
                           tl.tune_tile_capacity(state.params, cfg))
    log(f"  K={tuned.max_splats_per_tile} W={tuned.window_width} of "
        f"{rw._n_pad(N_WINDOW)}; escaped pairs: {sum(escapes)} over 200 "
        f"steps (first at step {first if first < 200 else 'none'}); "
        f"capacity drops {sum(r['n_dropped'] for r in hist_r)}")
    log(f"  window MSE equals the resident fit's bit for bit up to "
        f"iteration {min(first, 199)}: {equal}; MSE-255 @ 50 / 200: "
        f"{mse[49]:.4f} / {mse[199]:.4f} (resident {mse_r[49]:.4f} / "
        f"{mse_r[199]:.4f})")
    if not equal:
        raise AssertionError("window trajectory differs from the resident "
                             "one while nothing escaped")
    check_trajectory(mse, TRAJECTORY_WINDOW)
    step_ms = {}
    for binning, statics in (("window", tuned),
                             ("resident", tuned.replace(binning="resident",
                                                        window_width=None))):
        rates = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit(full, statics, 200, dev, state=state, log_every=0,
                log_fn=None)
            torch.cuda.synchronize()
            rates.append(200 / (time.perf_counter() - t0))
        log(f"  timed {binning} fits ({runs} x 200 iters, no per-step "
            f"sync): it/s {', '.join(f'{r:.2f}' for r in rates)}; median "
            f"{float(np.median(rates)):.2f} = {median_ms(rates):.3f} "
            f"ms/step [{smi}]")
        step_ms[binning] = rates
    return launches_w, launches_r, step_ms["window"], mse


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
    from gs2d_tpu_torch.train.graphs import launch_counters

    for counts in launch_counters():
        for kk in counts:
            counts[kk] = 0


def read_counts() -> dict:
    from gs2d_tpu_torch.train.graphs import launch_counters

    return {k: v for counts in launch_counters() for k, v in counts.items()}


def read_metrics(out: str) -> list:
    return [json.loads(x) for x in
            open(os.path.join(out, "metrics.jsonl")).read().splitlines()]


def logged_fit(argv, out=None, iters: int = 200, no_drops=False,
               details=False) -> tuple:
    """One CLI fit of ``iters`` iterations logged at every step, the launch
    counts set to 0 just before it and read just after, into ``out`` (a
    temporary directory when None); ``no_drops`` fails it on an overflow
    warning. Returns (launches, {iter: mse}), and with ``details`` also
    the run's metrics records and printed output."""
    with contextlib.ExitStack() as stack:
        if out is None:
            out = stack.enter_context(tempfile.TemporaryDirectory())
        seen = len(read_metrics(out)) \
            if os.path.exists(os.path.join(out, "metrics.jsonl")) else 0
        reset_counts()
        printed = run_cli(argv + ["--log-every", "1", "--out", out])
        launches = read_counts()
        recs = read_metrics(out)[seen:]
        mse = {r["iter"]: r["mse"] for r in recs if "iter" in r}
        done = [r for r in recs if r.get("event") == "done"][0]
        png = os.path.getsize(os.path.join(out, "render_final.png"))
    sync = "once a block" if "--scan-chunk" in argv else "every step"
    log(f"  launches: { {k: v for k, v in launches.items() if v} }; "
        f"render_final.png {png} bytes; logged run (sync {sync}): "
        f"{done['iters_per_s']:.1f} it/s")
    warnings = [x for x in printed.splitlines() if x.startswith("WARNING")]
    log(f"  warnings: {warnings if warnings else 'none'}")
    if len(mse) != iters or not all(np.isfinite(list(mse.values()))):
        raise AssertionError("trajectory incomplete or non-finite")
    drops = [x for x in warnings if "capacity overflow" in x]
    if drops and no_drops:
        raise AssertionError(f"pairs dropped to a capacity cap: {drops}")
    if details:
        return launches, mse, recs, printed
    return launches, mse


def fit_phase(image: str, splats: int, smi: str, extra=(),
              runs: int = 5, no_drops=False, keep=None):
    """The CLI's 200-iteration fit of ``image`` (with ``extra`` flags): once
    logged at every step (launch counts and the MSE trajectory; ``no_drops``
    as in logged_fit), then ``runs`` timed runs without a per-step sync,
    the last of them into the directory ``keep`` when one is given.
    Returns (launches, {iter: mse}, it/s of the timed runs)."""
    argv = [image, "--splats", str(splats), "--iters", "200", "--device",
            "cuda", *extra]
    log(f"[fit] python -m gs2d_tpu_torch.fit {os.path.basename(image)} "
        f"{' '.join(argv[1:])}")
    launches, mse, recs, printed = logged_fit(argv, no_drops=no_drops,
                                              details=True)
    rates = []
    for i in range(runs):
        with contextlib.ExitStack() as stack:
            out = keep if keep and i == runs - 1 else stack.enter_context(
                tempfile.TemporaryDirectory())
            run_cli(argv + ["--log-every", "0", "--out", out])
            rates.append(read_metrics(out)[-1]["iters_per_s"])
    q1, med, q3 = np.percentile(rates, [25, 50, 75])
    log(f"  timed runs ({runs} x 200 iters, no per-step sync): it/s "
        f"{', '.join(f'{r:.2f}' for r in rates)}; median {med:.2f} "
        f"(quartiles {q1:.2f}-{q3:.2f}) = {1e3 / med:.3f} ms/step "
        f"[{smi}]")
    if "--scan-chunk" in extra:
        return launches, mse, rates, scan_summary(recs, printed, smi)
    return launches, mse, rates


def scan_summary(recs, printed, smi: str) -> dict:
    """What a scanned CLI fit's logged run says of itself: the rebins of
    its 200 steps, its capture line and its steady ms a step (the replays
    of blocks 2-4: record times are block ends, so the first block's
    tuning, warm-up and capture stay out)."""
    steps = {r["iter"]: r for r in recs if "iter" in r}
    capture = [x for x in printed.splitlines()
               if x.startswith("captured the train step")]
    if len(capture) != 1:
        raise AssertionError(f"scanned fit: capture lines {capture}")
    steady = 1e3 * (steps[199]["elapsed_s"] - steps[49]["elapsed_s"]) / 150
    out = {"rebins": sum(r["rebinned"] for r in steps.values()),
           "capture": capture[0], "steady_ms": steady}
    log(f"  {capture[0]} [{smi}]")
    log(f"  rebins in 200 steps: {out['rebins']}; steady {steady:.4f} "
        f"ms/step over steps 50-199 (logged run) [{smi}]")
    return out


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


def device_profile(run, steps: int) -> dict:
    """{"busy": device ms a step, "ops": device kernels and copies a step,
    "rows": [(ms a step, count a step, name)] largest first} of ``steps``
    steps that ``run()`` launches, from utils.profiling.device_trace."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp, device_trace(tmp) as prof:
        run()
        torch.cuda.synchronize()
    rows, total, launches = [], 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed themselves
        dt = ev.self_device_time_total / steps / 1e3
        rows.append((dt, ev.count // steps, ev.key))
        total += dt
        launches += ev.count
    rows.sort(reverse=True)
    return {"busy": total, "ops": launches / steps, "rows": rows}


def profile_lines(prof: dict, step_ms: float, steps: int, wall_ms=None) -> str:
    """A device_profile as log lines, the idle share taken against
    ``step_ms``, the step time of an unprofiled run."""
    wall = "" if wall_ms is None else \
        f" (profiled step wall {wall_ms:.3f} ms)"
    lines = [f"  device busy {prof['busy']:.4f} ms/step over {steps} steps, "
             f"{prof['ops']:.0f} device kernels and copies a step; "
             f"unprofiled step {step_ms:.4f} ms, idle share "
             f"{max(0.0, 1 - prof['busy'] / step_ms):.3f}{wall}"]
    lines += [f"    {ms:.4f} ms/step x{cnt}: {key[:70]}"
              for ms, cnt, key in prof["rows"][:8]]
    if not prof["rows"]:
        lines.append("    profiler saw no device time")
    return "\n".join(lines)


def step_profile(step, state, ref_in, step_ms: float, steps: int = 10):
    """Device time per step by kernel over a steady window of ``step`` from
    ``state`` (device_profile); the idle share is taken against
    ``step_ms``, the step time of an unprofiled run. Returns (log lines,
    the device_profile with "idle")."""
    for _ in range(5):
        state, _ = step(state, ref_in)
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    def run():
        s = state
        for _ in range(steps):
            s, _ = step(s, ref_in)

    prof = device_profile(run, steps)
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    prof["idle"] = max(0.0, 1 - prof["busy"] / step_ms)
    return profile_lines(prof, step_ms, steps, wall_ms), prof


def fused_cells(dev) -> dict:
    """The train steps of the fits, as the fits tune them: {label: (step
    function, initial state, target as the step takes it)}. The fused L2
    steps of every layout, and the modular SSIM step of the default fit,
    resident and dense."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import render_window as rw
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import init_params
    from gs2d_tpu_torch.train.loop import (init_train_state, make_train_step,
                                           make_train_step_fused)

    cells = {}
    for image, n in ((MINI, 1024), (FULL, N_10K)):
        ref = load_image(image)
        cfg = SplatConfig(width=ref.shape[1], height=ref.shape[0],
                          n_splats=n)
        p = init_params(cfg, dev)
        cfg = tl.tune_tile_height(cfg, p)
        tuned = tl.tune_tile_capacity(p, cfg)
        kind = "default" if n == 1024 else "10k"
        if n == 1024:
            cells[f"resident L2 train step, {kind} fit"] = tuned
        else:
            cells[f"flat L2 train step, {kind} fit"] = rf.tune_flat_config(
                p, cfg)
        dense = tuned.replace(binning="dense")
        cells[f"dense L2 train step, {kind} fit (K="
              f"{dense.max_splats_per_tile})"] = dense
    out = {label: (make_train_step_fused(cfg), init_train_state(cfg, dev),
                   rd.pad_ref_chw(load_image(MINI if cfg.n_splats == 1024
                                             else FULL), cfg, dev))
           for label, cfg in cells.items()}
    state, cfg, full = window_population(dev)
    cfg = rw.tune_window(state.params,
                         tl.tune_tile_capacity(state.params, cfg))
    out[f"window L2 train step (K={cfg.max_splats_per_tile}, "
        f"W={cfg.window_width})"] = (make_train_step_fused(cfg), state,
                                     rd.pad_ref_chw(full, cfg, dev))
    mini = load_image(MINI)
    cfg = SplatConfig(width=mini.shape[1], height=mini.shape[0],
                      n_splats=1024)
    cfg = tl.tune_tile_height(cfg, init_params(cfg, dev))
    for binning in ("resident", "dense"):
        ssim_cfg = cfg.replace(binning=binning)
        out[f"modular SSIM train step ({binning}), default fit"] = (
            make_train_step(ssim_cfg, float(SSIM)),
            init_train_state(ssim_cfg, dev),
            torch.as_tensor(mini, dtype=torch.float32, device=dev))
    return out


def profile_cell(cells: dict, prefix: str, step_ms=None) -> dict:
    """Logs the step profile of the cell whose label starts with
    ``prefix``, against ``step_ms`` (the timed fits' step), or, when None,
    against 50 unprofiled steps of the same step function timed here.
    Returns the device_profile with "idle" and "step_ms"."""
    label = next(k for k in cells if k.startswith(prefix))
    step, state, ref_chw = cells[label]
    if step_ms is None:
        s = state
        for _ in range(5):
            s, _ = step(s, ref_chw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            s, _ = step(s, ref_chw)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / 50
    log(f"[profile] {label}, 10 steps")
    text, prof = step_profile(step, state, ref_chw, step_ms)
    log(text)
    return {**prof, "step_ms": step_ms}


def median_ms(rates) -> float:
    return 1e3 / float(np.median(rates))


def probe_entry(t: dict, plain_ms: float, bound_ms: tuple):
    """{ms, device, plain_ms, bound_ms, bound_by} of a probe kernel whose
    device_time reading is ``t`` and whose bound is ``bound_ms`` (ms, what
    bounds it)."""
    return {"ms": t["device"], "device": t, "plain_ms": plain_ms,
            "bound_ms": bound_ms[0], "bound_by": bound_ms[1]}


# A probe's share of its bound above this is a counting fault, as in
# probe_phase's roofline workloads.
PROBE_SHARE_MAX = 1.05


def compare_probes(dev, smi: str):
    """Kernels 14 and 15a-c against their plain versions on the card, at
    the shapes the measurement scripts give them: kernel 14 at every chain
    count of its sweep (the count with the best rate is reported), the
    moment probes at K = 512 on one block and on one block per SM (the
    latter is timed and reported). Each moment probe also against its
    reference (15a's lane tree bit for bit, 15b's and 15c's designs before
    wgmma within their tolerance), its per-step values against the plain
    steps, and a second launch bit for bit; then one line of ns per
    splat-tile reduction, and no probe above PROBE_SHARE_MAX of its bound.
    Returns (max errors, times); the references' differences go to
    REF_ERRS."""
    from gs2d_tpu_torch.ops import probes

    log("[compare] probe kernels 14, 15a-c vs plain PyTorch on the card")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    errs, times = {}, {}
    best = None
    for chains in probes.FMA_CHAINS[1:]:
        got = probes.fma_peak(chains, dev)
        want = probes.fma_peak_plain(chains, probes.FMA_INNER, 1, 1, dev)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = probes.FMA_ULPS * 2.0 ** -23 * float(want.abs().max())
        if not torch.isfinite(got).all() or err > tol:
            raise AssertionError(f"fma_peak chains={chains}: err {err} > "
                                 f"{tol}")
        errs["fma_peak"] = max(errs.get("fma_peak", 0.0), err)
        t = read_device_time("fma_peak",
                             lambda: probes.fma_peak(chains, dev), 5)
        ms = t["device"]
        flops = probes.fma_peak_flops(chains, probes.FMA_INNER, got.numel())
        log(f"  fma_peak chains={chains}: sum {float(got[0, 0])!r}, err "
            f"{err:.3g} (tol {tol:.3g}), {device_line(t)}, "
            f"{flops / ms / 1e9:.3f} TFLOP/s [{smi}]")
        if best is None or flops / ms > best[0]:
            best = (flops / ms, chains, t, flops, nbytes(got))
    _, chains, t, flops, out_bytes = best
    t_ops, t_bytes = flops / F32_PEAK, out_bytes / HBM_RATE
    times["fma_peak"] = probe_entry(
        t, cuda_ms(lambda: probes.fma_peak_plain(
            chains, probes.FMA_INNER, probes.FMA_GRID, probes.FMA_THREADS,
            dev), 3),
        (1e3 * max(t_ops, t_bytes),
         "operations" if t_ops >= t_bytes else "bytes"))
    k = probes.N_K
    for kind, (name, fn, plain) in probes.MOMENT_PROBES.items():
        rtol = GRAD_RTOL if kind == "vpu" else PROBE_TC_RTOL
        ref = probes.MOMENT_REFERENCES.get(kind)
        for n_blocks in (1, sms):
            got = fn(dev, n_k=k, n_blocks=n_blocks)
            want = plain(k, n_blocks, dev)
            torch.cuda.synchronize()
            # Each output against the size of its own terms: 15c's columns
            # cycle through nine moments whose sizes differ by about 1e3.
            err = (got - want).abs()
            sizes = probes.moments_output_sizes(kind, want, k)
            tol = rtol * sizes
            worst = int((err / tol).argmax())
            log(f"  {name}, {n_blocks} block(s): err {float(err.max()):.3g};"
                f" nearest its tolerance at column {worst % probes.TILE_W}: "
                f"err {float(err.flatten()[worst]):.3g} of "
                f"{float(want.flatten()[worst]):.6g}, "
                f"{float((err / sizes).max()):.3g} of its terms' size "
                f"{float(sizes.flatten()[worst]):.6g} (tol {rtol} of it)")
            if not torch.isfinite(got).all() or bool((err > tol).any()):
                raise AssertionError(f"{name} disagrees with its plain "
                                     "version")
            errs[name] = max(errs.get(name, 0.0), float(err.max()))
            if ref is not None:
                compare_probe_design(kind, got, sizes, rtol, n_blocks, dev)
        bound = probes.moments_bound(kind, k, sms, nbytes(got))
        times[name] = probe_entry(
            read_device_time(name, lambda: fn(dev, n_k=k, n_blocks=sms)),
            cuda_ms(lambda: plain(k, sms, dev), 1), bound)
        if ref is not None:
            ref_name, launch = ref
            times[PROBE_REF_TIMES[ref_name]] = probe_entry(
                read_device_time(ref_name, lambda: launch(k, sms, dev)),
                times[name]["plain_ms"], bound)
    ns = {kk: 1e6 * times[key]["ms"] / k for kk, key in (
        ("15a", "moments_cuda_cores"),
        ("15a old", PROBE_REF_TIMES["moments_cuda_cores_tree"]),
        ("15b", "moments_tensor_cores"),
        ("15b old", PROBE_REF_TIMES["moments_tensor_cores_staged"]),
        ("15c", "moments_scratch_contraction"),
        ("15c old", PROBE_REF_TIMES["moments_scratch_contraction_sync"]))}
    log(f"  ns per splat-tile reduction (device time / K, K = {k}, {sms} "
        f"blocks): " + ", ".join(f"{kk} {v:.1f}" for kk, v in ns.items())
        + f"; 15a / 15a old {ns['15a'] / ns['15a old']:.3f}, 15b / 15a "
        f"{ns['15b'] / ns['15a']:.3f}, 15c / 15a "
        f"{ns['15c'] / ns['15a']:.3f} [{smi}]")
    for kk, t in times.items():
        log(f"  {kk}: kernel {device_line(t['device'])}, plain "
            f"{t['plain_ms']:.2f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}), "
            f"{t['bound_ms'] / t['ms']:.5f} of the bound [{smi}]")
        if t["bound_ms"] / t["ms"] > PROBE_SHARE_MAX:
            raise AssertionError(f"{kk}: {t['bound_ms'] / t['ms']} of its "
                                 "bound: counting fault")
    return errs, times


def compare_probe_design(kind, got, sizes, rtol, n_blocks, dev) -> None:
    """A moment probe's redesign on the card, beside the output ``got`` it
    gave on n_blocks blocks: a second launch equal bit for bit, its
    reference (the design before it) within PROBE_REF_RTOL[kind] of the
    outputs' terms' size, which for 0 is bit for bit (torch.equal; 15a
    against its lane tree), the difference noted in REF_ERRS, and its
    per-step values within rtol of their terms' size of the plain steps."""
    from gs2d_tpu_torch.ops import probes

    name, fn, _ = probes.MOMENT_PROBES[kind]
    ref_name, launch = probes.MOMENT_REFERENCES[kind]
    width, plain_steps = probes.MOMENT_STEPS[kind]
    k = probes.N_K
    steps = torch.full((k, width), float("nan"), device=dev)
    again = fn(dev, n_k=k, n_blocks=n_blocks, steps=steps)
    old = launch(k, n_blocks, dev)
    want_steps = plain_steps(k, dev)
    step_sizes = plain_steps(k, dev, sizes=True).clamp(min=1.0)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches differ")
    d_old = (got - old).abs()
    d_steps = (steps - want_steps).abs()
    ref_rtol = PROBE_REF_RTOL[kind]
    log(f"  {name}, {n_blocks} block(s): against {ref_name} "
        f"{float((d_old / sizes).max()):.3g} (tol {ref_rtol}"
        f"{', bit for bit' if ref_rtol == 0 else ''}), its steps against "
        f"the plain steps {float((d_steps / step_sizes).max()):.3g} of "
        f"their terms' size (tol {rtol}); a second launch bit for bit")
    if not torch.isfinite(old).all() or bool((d_old > ref_rtol * sizes)
                                             .any()):
        raise AssertionError(f"{name} disagrees with {ref_name}")
    if ref_rtol == 0 and not torch.equal(got, old):
        raise AssertionError(f"{name} differs from {ref_name} in its bits")
    if not torch.isfinite(steps).all() \
            or bool((d_steps > rtol * step_sizes).any()):
        raise AssertionError(f"{name}: its steps disagree with the plain "
                             "steps")
    note_reference(ref_name, [got], [old])


def probe_phase() -> dict:
    """The two measurement entry points in this process, their lines
    logged, the launch counts set to 0 just before and read just after.
    Fails on a share of the published ceiling above 100% or a measured FMA
    ceiling more than 5% above the published one (either would be a
    counting fault). Returns the counts."""
    from gs2d_tpu_torch.ops import probes
    from gs2d_tpu_torch.scripts import probe_mxu_moments, roofline

    log("[probe] python -m gs2d_tpu_torch.scripts.probe_mxu_moments; "
        "python -m gs2d_tpu_torch.scripts.roofline")
    reset_counts()
    moments, roof = {}, {}
    for mod, got in ((probe_mxu_moments, moments), (roofline, roof)):
        rc = mod.main(["--device", "cuda"], collect=got, log=log)
        if rc != 0:
            raise AssertionError(f"{mod.__name__} exited {rc}")
    torch.cuda.synchronize()
    launches = read_counts()
    if len(moments) != 6 or len(roof["workloads"]) != 5:
        raise AssertionError("a probe line or a workload is missing")
    if 2 * roof["fma_per_s"] > 1.05 * F32_PEAK:
        raise AssertionError(f"measured FMA ceiling {2 * roof['fma_per_s']} "
                             "FLOP/s above the published one: counting fault")
    for r in roof["workloads"]:
        if not 0.0 < r["share_published"] <= 1.0:
            raise AssertionError(f"{r['workload']}: share "
                                 f"{r['share_published']} of the published "
                                 "ceiling")
    want = {"l2_resident": 1, "l2_dense": 2, "fwd_flat": 2, "fwd_flat_mask": 2,
            "bwd_flat": 2}
    # A workload's first call, then device_time's at 10 reps: a warm-up, 10
    # event-timed calls, one on a side stream, 10 captured, and 20 traced
    # in each of one to three attempts at a profiler window.
    per = (1 + 1 + 10 + 1 + 10 + 20, 1 + 1 + 10 + 1 + 10 + 3 * 20)
    for kk, n in want.items():
        if not n * per[0] <= launches[kk] <= n * per[1]:
            raise AssertionError(f"roofline: {kk} launched {launches[kk]} "
                                 f"times, expected {n * per[0]} to "
                                 f"{n * per[1]}")
    for kk in probes.launches:
        if kk not in probes.REFERENCE_COUNTERS and not launches[kk]:
            raise AssertionError(f"{kk}: not launched by its script")
    log(f"  launches: { {k: v for k, v in launches.items() if v} }")
    return launches


def fit_1080p_phase(dev, smi: str) -> dict:
    """BASELINE.json configs[2] through the CLI: a synthetic 1920x1080
    target written to a temporary .npy, 102 400 splats, --binning auto
    (flat), 200 iterations, one logged run and one timed run; then kernels
    10 and 11 against their plain versions at this init. Gates: the launch
    counts, no dropped pair, finite parameters (the final checkpoint), the
    kernels' agreement. The same fit scanned (--scan-chunk 50
    --rebin-margin 2) under the same gates. Returns the logged runs' summed
    counts and {"1080p/100k flat": (eager numbers, scanned numbers)}."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.checkpoint import Checkpointer
    from gs2d_tpu_torch.io.image import synthetic_target
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import FIELDS, init_params
    from gs2d_tpu_torch.train.loop import (init_train_state,
                                           make_fit_scan_fused,
                                           make_train_step_fused)

    ref = synthetic_target(1080, 1920)
    cfg = SplatConfig(width=1920, height=1080, n_splats=N_100K)
    with tempfile.TemporaryDirectory() as tmp:
        image = os.path.join(tmp, "synthetic_1080p.npy")
        np.save(image, ref)
        runs = {}
        for name, extra in (("eager", []), ("scanned", LAZY)):
            out = os.path.join(tmp, name)
            launches, mse, rates, *summary = fit_phase(
                image, N_100K, smi, ["--checkpoint-every", "200", *extra],
                runs=1, no_drops=True, keep=out)
            expect_launches(f"1080p flat fit ({name})", launches,
                            {"fwd_flat": 201, "fwd_flat_mask": 201,
                             "bwd_flat": 200,
                             "expand_flat": EXPANSIONS[name]})
            log(f"  MSE-255 @ 1 / 50 / 200: {mse[0]:.4f} / {mse[49]:.4f} / "
                f"{mse[199]:.4f} (no reference trajectory at this size)")
            step, state = Checkpointer(os.path.join(
                out, "checkpoints")).restore_latest(
                    init_train_state(cfg, dev))
            if step != 200:
                raise AssertionError(f"1080p fit: latest checkpoint {step}")
            require_finite("1080p fit", **{f: getattr(state.params, f)
                                           for f in FIELDS})
            log("  checkpoint step_200.npz: all parameters finite")
            runs[name] = (launches, mse, rates, *summary)
    launches = {k: runs["eager"][0][k] + runs["scanned"][0][k]
                for k in runs["eager"][0]}
    same = sum(runs["eager"][1][i] == runs["scanned"][1][i]
               for i in range(200))
    log(f"  the scanned lazy fit's MSEs equal the eager fit's at {same} of "
        "200 iterations (no gate at this size)")
    p_init = init_params(cfg, dev)
    cfg = tl.tune_tile_height(cfg, p_init)
    _, times = compare_flat_case("pcg3d init 102400 on 1920x1080", p_init,
                                 ref, cfg, dev, timed=True)
    log_times(times, "at the 1080p/100k init", smi)
    log("[profile] flat L2 train step at 1080p/100k, 10 steps")
    rates = runs["eager"][2]
    text, prof = step_profile(
        make_train_step_fused(rf.tune_flat_config(p_init, cfg)),
        init_train_state(cfg, dev), rd.pad_ref_chw(ref, cfg, dev),
        median_ms(rates))
    log(text)
    lazy = rf.tune_flat_config(p_init, cfg.replace(rebin_margin=2.0))
    log("[profile] scanned flat L2 train step at 1080p/100k, --rebin-margin "
        "2, 10 replays")
    scan = runs["scanned"][3]
    scan["prof"] = replay_profile(make_fit_scan_fused(lazy),
                                  init_train_state(cfg, dev),
                                  rd.pad_ref_chw(ref, lazy, dev),
                                  scan["steady_ms"])
    return launches, {"1080p/100k flat": (
        {**prof, "step_ms": median_ms(rates), "rates": rates},
        {**scan, "rates": runs["scanned"][2]})}


def resume_phase(extra=()) -> dict:
    """The default fit (with ``extra`` flags) for 200 iterations with
    --checkpoint-every 100; then 100 iterations into a second directory and
    --resume for the other 100. The resumed fit's MSEs at iterations
    100-199 must equal the uninterrupted fit's bit for bit. Returns the
    summed counts."""
    log(f"[resume] the default fit{''.join(' ' + a for a in extra)}, "
        "uninterrupted and resumed at 100")
    base = [MINI, "--splats", "1024", "--device", "cuda",
            "--checkpoint-every", "100", *extra]
    total = {}

    def add(launches, n):
        expect_launches("checkpointed fit", launches,
                        {"l2_resident": n, "fwd_resident": 1})
        for kk, v in launches.items():
            total[kk] = total.get(kk, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        one, two = os.path.join(tmp, "whole"), os.path.join(tmp, "halves")
        launches, whole = logged_fit(base + ["--iters", "200"], out=one)
        add(launches, 200)
        launches, first = logged_fit(base + ["--iters", "100"], out=two,
                                     iters=100)
        add(launches, 100)
        launches, second = logged_fit(base + ["--iters", "100", "--resume"],
                                      out=two, iters=100)
        add(launches, 100)
        steps = [sorted(int(f[5:-4]) for f in os.listdir(
            os.path.join(d, "checkpoints"))) for d in (one, two)]
    if steps != [[100, 200], [100, 200]]:
        raise AssertionError(f"checkpoint steps {steps}")
    if sorted(second) != list(range(100, 200)):
        raise AssertionError("the resumed fit does not log iterations "
                             "100-199")
    same = sum(whole[i] == {**first, **second}[i] for i in range(200))
    log(f"  checkpoints at {steps[0]}; resumed MSEs equal the uninterrupted "
        f"fit's bit for bit at {same} of 200 iterations (MSE-255 @ 100 / "
        f"200: {whole[99]:.4f} / {whole[199]:.4f}, resumed "
        f"{first[99]:.4f} / {second[199]:.4f})")
    if same != 200:
        raise AssertionError("resume does not equal the uninterrupted fit")
    return total


def recovery_phase(dev) -> dict:
    """train.loop.fit_with_recovery on the default workload (1024 splats, 60
    iterations, checkpoint_every 20) with a fault injected as gs2d_tpu's
    test does: the first call of loop.fit runs 30 real iterations,
    checkpointing, then raises FloatingPointError. Gates: exactly one
    recovery, the learning rate halved, the latest checkpoint at step 60, a
    finite state, kernels 2 and 3 launched. Then the CLI's --recover with
    no fault: 0 recoveries and a render. Returns the summed counts."""
    import gs2d_tpu_torch.train.loop as loop_mod
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.checkpoint import Checkpointer, load_npz_config
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.params import FIELDS

    log("[recover] fit_with_recovery, 1024 splats, 60 iterations, a fault "
        "injected after 30")
    ref = load_image(MINI)
    cfg = SplatConfig(width=ref.shape[1], height=ref.shape[0], n_splats=1024,
                      tile_h=32)
    calls = {"n": 0}
    orig_fit = loop_mod.fit

    def sabotaged_fit(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            orig_fit(args[0], args[1], 30, *args[3:], **kw)
            raise FloatingPointError("injected")
        return orig_fit(*args, **kw)

    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(os.path.join(tmp, "ck"))
        reset_counts()
        loop_mod.fit = sabotaged_fit
        try:
            state, hist, n_rec = loop_mod.fit_with_recovery(
                ref, cfg, 60, ck, dev, checkpoint_every=20, log_every=10,
                log_fn=lines.append)
        finally:
            loop_mod.fit = orig_fit
        torch.cuda.synchronize()
        launches = read_counts()
        latest, steps = ck.latest_step(), ck.all_steps()
        lr = load_npz_config(os.path.join(tmp, "ck",
                                          "step_60.npz")).learning_rate
    for line in lines:
        log(f"  {line}")
    log(f"  {n_rec} recovery, checkpoints {steps}, learning rate "
        f"{cfg.learning_rate} -> {lr}, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    require_finite("fit_with_recovery", **{f: getattr(state.params, f)
                                           for f in FIELDS})
    if n_rec != 1 or latest != 60 or lr != cfg.learning_rate * 0.5:
        raise AssertionError("recovery: wrong count, step or learning rate")
    # 30 steps before the fault, then 40 from the checkpoint at step 20.
    expect_launches("fit_with_recovery", launches,
                    {"fwd_resident": 70, "bwd_resident": 70})
    total = dict(launches)
    log("[recover] python -m gs2d_tpu_torch.fit --recover, no fault")
    with tempfile.TemporaryDirectory() as out:
        reset_counts()
        printed = run_cli([MINI, "--splats", "1024", "--iters", "60",
                           "--device", "cuda", "--recover",
                           "--checkpoint-every", "20", "--log-every", "20",
                           "--out", out])
        launches = read_counts()
        png = os.path.getsize(os.path.join(out, "render_final.png"))
    log(f"  {printed.splitlines()[-1]}; render_final.png {png} bytes; "
        f"launches { {k: v for k, v in launches.items() if v} }")
    if "done (0 recoveries)" not in printed:
        raise AssertionError("--recover without a fault reported recoveries")
    expect_launches("--recover fit", launches,
                    {"fwd_resident": 61, "bwd_resident": 60})
    for kk, v in launches.items():
        total[kk] = total.get(kk, 0) + v
    return total


# The scanned fits' flags: blocks of 50 steps without the host, and
# bench.py's lazy rebinning contract.
SCAN = ["--scan-chunk", "50"]
LAZY = SCAN + ["--rebin-margin", "2"]
# The flat expansion's launches in a 200-step CLI fit: eager, one a step
# and one for the final render; scanned under LAZY, the host's alone (the
# capture's cache, each of the 4 blocks' fresh binning, the final render),
# since a replay's rebins run under the conditional node and count none.
EXPANSIONS = {"eager": 201, "scanned": 6}


def replay_profile(fit_k, state, ref, steady_ms: float,
                   steps: int = 10) -> dict:
    """device_profile of ``steps`` replays of the step ``fit_k`` captures
    (one call of ``steps`` from ``state`` captures it, then the statics are
    reloaded at ``state``), the idle share against ``steady_ms``."""
    from gs2d_tpu_torch.train.loop import state_leaves

    fit_k(state, ref, steps)
    g = fit_k.graph
    g.load(state_leaves(state), ref)

    def run():
        for _ in range(steps):
            g.graph.replay()

    prof = device_profile(run, steps)
    prof["idle"] = max(0.0, 1 - prof["busy"] / steady_ms)
    log(profile_lines(prof, steady_ms, steps))
    return prof


def cached_and_rebin_steps(fit_k, state, ref) -> None:
    """One replay of a captured lazy step on a fresh cache (the tripwire
    holds) and one after every splat moved 8 px since it was binned (it
    fails and the conditional node runs the binning), each profiled. The
    cached ids are overwritten with a sentinel (-7, a padding id to the
    kernels) before each replay. Gates: the rebinned flags; the sentinel
    survives the cached step, so the binning did not run, and the rebin
    step leaves the binning of the moved splats, so it ran."""
    from gs2d_tpu_torch.train.loop import state_leaves

    g = fit_k.graph
    for name, moved in (("cached step", 0.0), ("rebin step", 8.0)):
        g.load(state_leaves(state), ref)
        g.leaves[0].add_(moved)  # pos
        want = g.make_caches[0](g.leaves)[0] if moved else None
        g.caches[0][0].fill_(-7)
        prof = device_profile(g.graph.replay, 1)
        flag = int(g.aux["rebinned"][0])
        sorts = [k for _, _, k in prof["rows"] if "sort" in k.lower()]
        log(f"  {name}: {prof['ops']:.0f} device operations, busy "
            f"{prof['busy']:.4f} ms, rebinned {flag}, sort/search kernels "
            f"the profiler named {len(sorts)}")
        ran = not bool((g.caches[0][0] == -7).all())
        if flag != (moved > 0) or ran != (moved > 0) or (
                moved and not torch.equal(g.caches[0][0], want)):
            raise AssertionError(f"{name}: rebinned {flag}, binning ran "
                                 f"{ran}")


def scan_cells(dev) -> dict:
    """The scanned fitters of the fits, tuned as the CLI tunes them:
    {label: (fit_k, initial state, target as the step takes it)}."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import render_window as rw
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.train.loop import (init_train_state, make_fit_scan,
                                           make_fit_scan_fused)

    cells = {}
    for label, image, n, kw in (
            ("default", MINI, 1024, {}),
            ("default, --rebin-margin 2", MINI, 1024, {"rebin_margin": 2.0}),
            ("10k, --rebin-margin 2", FULL, N_10K, {"rebin_margin": 2.0}),
            ("dense default", MINI, 1024, {"binning": "dense"}),
            ("resident SSIM", MINI, 1024, {})):
        ref = load_image(image)
        cfg = SplatConfig(width=ref.shape[1], height=ref.shape[0],
                          n_splats=n, **kw)
        state = init_train_state(cfg, dev)
        cfg = tl.tune_tile_height(cfg, state.params)
        if label == "resident SSIM":  # the CLI keeps the default K here
            cells[label] = (make_fit_scan(cfg, float(SSIM)), state,
                            torch.as_tensor(ref, dtype=torch.float32,
                                            device=dev))
            continue
        cfg = rf.tune_flat_config(state.params, cfg) if rf.use_flat(cfg) \
            else tl.tune_tile_capacity(state.params, cfg)
        cells[label] = (make_fit_scan_fused(cfg), state,
                        rd.pad_ref_chw(ref, cfg, dev))
    state, cfg, full = window_population(dev)
    cfg = rw.tune_window(state.params,
                         tl.tune_tile_capacity(state.params, cfg))
    cells["window"] = (make_fit_scan_fused(cfg), state,
                       rd.pad_ref_chw(full, cfg, dev))
    return cells


def scan_phase(dev, smi: str, eager_mse: dict, eager: dict,
               pair_1080p: dict) -> dict:
    """The scanned fits (--scan-chunk 50: one train step captured as a CUDA
    graph and replayed, train/graphs.py) beside their eager twins:

    - the default, dense, resident SSIM and window fits, and the default
      and 10k fits with --rebin-margin 2 (lazy rebinning under a
      conditional node), each equal to its eager fit bit for bit over 200
      steps, with the eager fits' gates and launch counts (one a replay);
    - --rebin-margin -1 at the default and 10k inits (the margin it picks);
    - --opacity-cull on the default fit, with and without a margin: finite,
      the pair counts with and without the cull printed;
    - the scanned default fit checkpointed and resumed at 100 (resume_phase);
    - the replays' device profile (busy ms, operations, idle share), a
      cached and a rebin step of the lazy default fit, and one table of
      every scanned fit beside its eager twin.

    Returns the summed launch counts of the phase's logged runs."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import init_params
    from gs2d_tpu_torch.train.loop import fit

    t_phase = time.perf_counter()
    total, scanned = {}, {}

    def count(launches):
        for kk, v in launches.items():
            total[kk] = total.get(kk, 0) + v

    def same_as_eager(name, mse, key):
        same = sum(mse[i] == eager_mse[key][i] for i in range(200))
        log(f"  equals the eager {key} fit's MSEs bit for bit at {same} of "
            "200 iterations")
        if same != 200:
            raise AssertionError(f"scanned {name} fit differs from its eager "
                                 "twin")

    for name, image, n, extra, want, key in (
            ("default", MINI, 1024, SCAN,
             {"l2_resident": 200, "fwd_resident": 1}, "default"),
            ("default, --rebin-margin 2", MINI, 1024, LAZY,
             {"l2_resident": 200, "fwd_resident": 1}, "default"),
            ("10k, --rebin-margin 2", FULL, N_10K, LAZY,
             {"fwd_flat": 201, "fwd_flat_mask": 201, "bwd_flat": 200,
              "expand_flat": EXPANSIONS["scanned"]}, "10k"),
            ("dense default", MINI, 1024, ["--binning", "dense", *SCAN],
             {"l2_dense": 200, "fwd_dense": 1}, "dense"),
            ("resident SSIM", MINI, 1024, ["--ssim", SSIM, *SCAN],
             {"fwd_resident": 201, "bwd_resident": 200}, "ssim")):
        launches, mse, rates, summary = fit_phase(image, n, smi, extra,
                                                  runs=2)
        expect_launches(f"scanned {name} fit", launches, want)
        count(launches)
        same_as_eager(name, mse, key)
        scanned[name] = {**summary, "rates": rates}
        if key == "default":
            check_trajectory(mse, {it: (v, TRAJECTORY_RTOL)
                                   for it, v in TRAJECTORY.items()})
            check_trajectory(mse, TRAJECTORY_JAX)
        elif key == "10k":
            check_trajectory(mse, TRAJECTORY_10K)

    state, cfg, full = window_population(dev)
    log("[scan] train.loop.fit, binning window, scan_chunk 50, 200 "
        "iterations")
    lines = []
    reset_counts()
    _, hist = fit(full, cfg, 200, dev, state=state, log_every=1,
                  log_fn=lines.append, scan_chunk=50)
    torch.cuda.synchronize()
    launches = read_counts()
    expect_launches("scanned window fit", launches, {"l2_window": 200})
    count(launches)
    same_as_eager("window", {r["iter"]: r["mse"] for r in hist}, "window")
    elapsed = {r["iter"]: r["elapsed_s"] for r in hist}
    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(full, cfg, 200, dev, state=state, log_fn=None, scan_chunk=50)
        torch.cuda.synchronize()
        rates.append(200 / (time.perf_counter() - t0))
    capture = [x for x in lines if x.startswith("captured")][0]
    scanned["window"] = {
        "rates": rates, "rebins": 0, "capture": capture,
        "steady_ms": 1e3 * (elapsed[199] - elapsed[49]) / 150}
    log(f"  {capture}; steady {scanned['window']['steady_ms']:.4f} ms/step "
        f"over steps 50-199; timed it/s "
        f"{', '.join(f'{r:.2f}' for r in rates)} [{smi}]")

    log("[scan] --rebin-margin -1 (auto) at the default and 10k inits")
    for image, n in ((MINI, 1024), (FULL, N_10K)):
        launches, _, _, printed = logged_fit(
            [image, "--splats", str(n), "--iters", "50", "--device", "cuda",
             "--rebin-margin", "-1", *SCAN], iters=50, details=True)
        count(launches)
        picked = [x for x in printed.splitlines() if x.startswith(
            "rebin margin")]
        log(f"  {os.path.basename(image)}, {n} splats: {picked}")
        if len(picked) != 1:
            raise AssertionError("auto margin not reported")

    log("[scan] --opacity-cull (1/256) on the default fit, scanned, with "
        "and without --rebin-margin 2")
    for extra in (SCAN, LAZY):
        launches, mse = logged_fit([MINI, "--splats", "1024", "--iters",
                                    "200", "--device", "cuda",
                                    "--opacity-cull", *extra])
        count(launches)
        log(f"  {' '.join(extra)}: MSE-255 @ 50 / 200: {mse[49]:.4f} / "
            f"{mse[199]:.4f} (eager, no cull: {eager_mse['default'][49]:.4f} "
            f"/ {eager_mse['default'][199]:.4f}; lossy by design, no gate)")
    mini = load_image(MINI)
    cfg = SplatConfig(width=mini.shape[1], height=mini.shape[0],
                      n_splats=1024, tile_h=32)
    p = init_params(cfg, dev)
    pairs = [int(tl.bin_splats(p, cfg.replace(opacity_cull_alpha=a), 1,
                               counts_only=True).sum()) for a in (0.0, 1 / 256)]
    log(f"  pairs at the init: {pairs[0]} without the cull, {pairs[1]} with "
        "it (every opacity is 1.0 and stays so without --optimize-opacity, "
        "so the cull removes none)")

    count(resume_phase(SCAN))

    cells = scan_cells(dev)
    for label, (fit_k, state, ref) in cells.items():
        log(f"[profile] scanned {label} fit's step, 10 replays")
        scanned[label]["prof"] = replay_profile(
            fit_k, state, ref, scanned[label]["steady_ms"])
        if label == "default, --rebin-margin 2":
            cached_and_rebin_steps(fit_k, state, ref)
    del cells

    log(f"[scan] scanned fits beside their eager twins [{smi}] (it/s: the "
        "CLI's timed runs, tuning excluded, a scanned run's capture "
        "included; ms/step: the eager runs' median, the scanned logged "
        "run's steps 50-199; busy ms, operations and idle share a step: "
        "torch.profiler over 10 eager steps or 10 replays)")
    pairs = [("default", eager["default"]),
             ("default, --rebin-margin 2", eager["default"]),
             ("10k, --rebin-margin 2", eager["10k"]),
             ("dense default", eager["dense"]), ("window", eager["window"]),
             ("resident SSIM", eager["ssim"])]
    pairs += [(k, e) for k, (e, _) in pair_1080p.items()]
    scanned.update({k: sc for k, (_, sc) in pair_1080p.items()})
    for name, e in pairs:
        sc = scanned[name]
        log(f"  {name}: eager {float(np.median(e['rates'])):.2f} it/s, "
            f"{e['step_ms']:.4f} ms/step, busy {e['busy']:.4f} ms, "
            f"{e['ops']:.0f} ops, idle {e['idle']:.3f} | scanned "
            f"{float(np.median(sc['rates'])):.2f} it/s, "
            f"{sc['steady_ms']:.4f} ms/step, busy {sc['prof']['busy']:.4f} "
            f"ms, {sc['prof']['ops']:.0f} ops, idle "
            f"{sc['prof']['idle']:.3f}, {sc['rebins']} rebins in 200 steps")
    log(f"  the scanned phase took {time.perf_counter() - t_phase:.1f}s")
    return total


ADAPTIVE = ["--optimize-opacity", "--densify-every", "100",
            "--opacity-reset-every", "200"]
# The scanned default step's device operations before the densify signal
# existed (PERF.md section 5): a step built without it must run these, to
# within the profiler's count of the same step on different H100 machines,
# which reads it 562 to 564 (the tree before the batched fitters as well
# as after them; PERF.md section 6). The signal adds 48.
SCANNED_DEFAULT_OPS = 563


def check_drops(name: str, recs, printed, every: int = 0) -> None:
    """No pair dropped without a report: a fit whose steps dropped pairs
    printed an overflow warning, and with ``every`` (fit_adaptive's
    windows) one a window that dropped any, the final window included."""
    drops = {r["iter"]: r["n_dropped"] for r in recs if "iter" in r}
    warned = [x for x in printed.splitlines() if "capacity overflow" in x]
    windows = sorted({it // every for it, d in drops.items() if d}) \
        if every else []
    log(f"  {name}: {sum(drops.values())} pairs dropped in the logged steps, "
        f"windows that dropped any {windows}, overflow warnings "
        f"{len(warned)}")
    if sum(drops.values()) and not warned or len(warned) < len(windows):
        raise AssertionError(f"{name}: pairs dropped without a report")


def live_counts(printed) -> list:
    return [x.split(":")[1].strip() for x in printed.splitlines()
            if x.startswith("densify/prune at iter")]


def improves(name: str, mse: dict, plain: dict, last: int,
             twin: str = "") -> None:
    """Every step before the first densify (at 100) equals the fit without
    densify, and the last MSE is at most 1.02 x its (gs2d_tpu's
    test_fit_adaptive_refills_and_improves rule)."""
    same = sum(mse[i] == plain[i] for i in range(100))
    ratio = mse[last] / plain[last]
    log(f"  {name}: steps 0-99 equal the fit without densify {twin} at "
        f"{same} of 100; MSE-255 @ {last + 1}: {mse[last]:.4f} against "
        f"{plain[last]:.4f} without densify (x{ratio:.4f}, at most x1.02)")
    if same != 100 or ratio > 1.02:
        raise AssertionError(f"{name}: {same} of 100 equal, x{ratio:.4f}")


def adaptive_phase(dev, smi: str, ssim_mse: dict) -> dict:
    """Adaptive density control (train/densify.py) through the CLI and on
    the card:

    - the default fit with --optimize-opacity --densify-every 100
      --opacity-reset-every 200, 400 iterations (fit_adaptive), eager and
      --scan-chunk 50 (the signal summed in the captured step): equal bit
      for bit, the live count after every window, one capture per cfg;
      its first 100 steps equal the fit without densify, and its last MSE
      is at most 1.02x that of the same fit without densify, which keeps
      the opacity resets (fit_adaptive with a densify that prunes and
      fills nothing; the fit without either is logged beside it);
    - the 10k flat fit with --densify-every 100, 300 iterations, beside
      the same fit without densify (the same gates);
    - the modular route (--ssim 0.2 --densify-every 100, 200 iterations):
      gs2d_tpu's note line, densify at 100, beside the SSIM fit without it
      (``ssim_mse``);
    - no pair dropped without a report, on each of them;
    - densify_and_prune on the card against the CPU bit for bit, after 100
      scanned steps of the default fit (and with every fourth splat made
      transparent, so that it prunes and refills), and its device time;
    - the scanned default step's device busy ms and operations with and
      without the signal (without: SCANNED_DEFAULT_OPS operations).

    Returns the summed launch counts of the phase's logged runs."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.train.densify import (DensifyConfig,
                                              densify_and_prune,
                                              fit_adaptive, n_live)
    from gs2d_tpu_torch.train.loop import (init_train_state,
                                           make_fit_scan_fused, state_leaves,
                                           state_from_leaves)

    t_phase = time.perf_counter()
    total = {}

    def count(launches):
        for kk, v in launches.items():
            total[kk] = total.get(kk, 0) + v

    base = [MINI, "--splats", "1024", "--device", "cuda"]
    mini = load_image(MINI)
    runs = {}
    for name, extra in (("eager", []), ("scanned", SCAN)):
        argv = base + ["--iters", "400", *ADAPTIVE, *extra]
        log(f"[adaptive] python -m gs2d_tpu_torch.fit {' '.join(argv)}")
        t0 = time.perf_counter()
        launches, mse, recs, printed = logged_fit(argv, iters=400,
                                                  details=True)
        log(f"  {time.perf_counter() - t0:.2f}s with tuning (and capture) "
            f"[{smi}]")
        expect_launches(f"adaptive default fit ({name})", launches,
                        {"l2_resident": 400, "fwd_resident": 1})
        count(launches)
        check_drops(f"{name} fit", recs, printed, every=100)
        runs[name] = (mse, printed)
        log(f"  live splats after each densify: {live_counts(printed)}")
    (mse_e, out_e), (mse_s, out_s) = runs["eager"], runs["scanned"]
    same = sum(mse_s[i] == mse_e[i] for i in range(400))
    captures = len([x for x in out_s.splitlines()
                    if x.startswith("captured the train step")])
    cfgs = 1 + len([x for x in out_s.splitlines() if "re-tuning" in x])
    log(f"  scanned equals eager bit for bit at {same} of 400 MSEs; "
        f"{captures} captures of the train step for {cfgs} cfgs")
    if same != 400 or live_counts(out_s) != live_counts(out_e) \
            or captures != cfgs:
        raise AssertionError("the scanned adaptive fit differs from the "
                             "eager one, or captured more than once a cfg")
    launches, plain = logged_fit(base + ["--iters", "400",
                                         "--optimize-opacity", *SCAN],
                                 iters=400)
    count(launches)
    log(f"  against the fit without densify and without the opacity reset: "
        f"MSE-255 @ 400 x{mse_e[399] / plain[399]:.4f} (the reset's cost; "
        "no gate)")
    # The same fit without densify keeps the reset schedule: fit_adaptive
    # with a densify that prunes and fills nothing.
    cfg = SplatConfig(width=mini.shape[1], height=mini.shape[0],
                      n_splats=1024, optimize_opacity=True)
    state = init_train_state(cfg, dev)
    cfg = tl.tune_tile_capacity(state.params, tl.tune_tile_height(
        cfg, state.params))
    reset_counts()
    _, hist = fit_adaptive(mini, cfg, 400, 100, dev, state=state,
                           dcfg=DensifyConfig(prune_opacity=-np.inf,
                                              prune_min_scale=-np.inf,
                                              max_fraction=0.0),
                           scan_chunk=50, log_every=1, log_fn=None,
                           opacity_reset_every=200)
    torch.cuda.synchronize()
    count(read_counts())
    improves("default fit", mse_e, {r["iter"]: r["mse"] for r in hist
                                    if "iter" in r}, 399,
             "with the same opacity resets")

    argv = [FULL, "--splats", str(N_10K), "--iters", "300", "--device",
            "cuda"]
    log(f"[adaptive] python -m gs2d_tpu_torch.fit {' '.join(argv)} "
        "--densify-every 100, and without it")
    launches, mse, recs, printed = logged_fit(
        argv + ["--densify-every", "100"], iters=300, details=True)
    expect_launches("adaptive 10k fit", launches,
                    {"fwd_flat": 301, "fwd_flat_mask": 301, "bwd_flat": 300,
                     "expand_flat": 301})
    count(launches)
    check_drops("10k fit", recs, printed, every=100)
    log(f"  live splats after each densify: {live_counts(printed)}")
    launches, plain = logged_fit(argv, iters=300)
    count(launches)
    improves("10k fit", mse, plain, 299)

    argv = base + ["--iters", "200", "--ssim", SSIM, "--densify-every",
                   "100"]
    log(f"[adaptive] python -m gs2d_tpu_torch.fit {' '.join(argv)} "
        "(the modular route)")
    launches, mse, recs, printed = logged_fit(argv, details=True)
    # One more forward and backward: the L2 gradient at the densify.
    expect_launches("modular densify fit", launches,
                    {"fwd_resident": 202, "bwd_resident": 201})
    count(launches)
    check_drops("modular fit", recs, printed)
    lines = printed.splitlines()
    if not lines[0].startswith("note: --densify-every with --ssim") or [
            x for x in lines if x.startswith("densify/")] != [
            "densify/prune at iter 100"]:
        raise AssertionError("modular route: note or densify line missing")
    log(f"  {lines[0]}; densify/prune at iter 100")
    improves("modular SSIM fit", mse, ssim_mse, 199)

    log("[adaptive] densify_and_prune on the card and on the CPU, after 100 "
        "scanned steps of the default fit with --optimize-opacity")
    state = init_train_state(cfg, dev)
    ref_p = rd.pad_ref_chw(mini, cfg, dev)
    state, aux = make_fit_scan_fused(cfg, True)(state, ref_p, 100)
    signal = aux.pos_grad_mag
    faded = state_from_leaves([t.clone() for t in state_leaves(state)])
    faded.params.opacity[::4] = 0.1
    for name, st in (("as fitted", state), ("every 4th splat at opacity "
                                            "0.1", faded)):
        card = densify_and_prune(st, signal, cfg, seed=100)
        cpu = densify_and_prune(state_from_leaves(
            [t.cpu() for t in state_leaves(st)]), signal.cpu(), cfg,
            seed=100)
        same = all(torch.equal(a.cpu(), b) for a, b in
                   zip(state_leaves(card), state_leaves(cpu)))
        moved = int((card.params.pos != st.params.pos).any(1).sum())
        log(f"  {name}: card equals CPU bit for bit: {same}; live "
            f"{int(n_live(st.params))} -> {int(n_live(card.params))}, "
            f"{moved} positions changed")
        if not same:
            raise AssertionError(f"densify on the card differs ({name})")
    t = device_time(lambda: densify_and_prune(faded, signal, cfg, seed=100),
                    reps=20)
    log(f"  densify_and_prune, 1024 splats: {device_line(t)} [{smi}] (many "
        "small operations: the replay holds the gaps between them, so no "
        "profiler agreement gate)")

    log("[adaptive] the scanned default step (margin 0) with and without "
        "the densify signal, 10 replays each")
    # scan_cells' default cell: tuned on the init, as the CLI tunes it.
    cfg0 = SplatConfig(width=mini.shape[1], height=mini.shape[0],
                       n_splats=1024)
    init = init_train_state(cfg0, dev)
    cfg0 = tl.tune_tile_capacity(init.params, tl.tune_tile_height(
        cfg0, init.params))
    ref0 = rd.pad_ref_chw(mini, cfg0, dev)
    for on in (False, True):
        # Captured for blocks of 10, as replay_profile captures scan_cells'.
        fit_k = make_fit_scan_fused(cfg0, on)
        fit_k(init, ref0, 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fit_k(init, ref0, 10)
        torch.cuda.synchronize()
        steady = 1e3 * (time.perf_counter() - t0) / 50
        log(f"  with_grad_mag={on}: 5 blocks of 10 replays {steady:.4f} "
            f"ms/step [{smi}]")
        prof = replay_profile(fit_k, init, ref0, steady)
        if not on and abs(round(prof["ops"]) - SCANNED_DEFAULT_OPS) > 1:
            raise AssertionError(f"the scanned default step runs "
                                 f"{prof['ops']} operations, not "
                                 f"{SCANNED_DEFAULT_OPS} (+-1)")
    log(f"  the adaptive phase took {time.perf_counter() - t_phase:.1f}s")
    return total


# ---- several images, and the large flat configurations ---------------------

N_1M = 1 << 20
N_4M = 1 << 22
N_2M = 1 << 21
UHD = (2160, 3840)  # 4K: height, width
FHD = (1080, 1920)


def batched_logged_fit(argv, n_images: int, iters: int) -> tuple:
    """One several-image CLI fit logged at every step, the launch counts set
    to 0 just before it and read just after, into a temporary directory.
    Returns (launches, {iter: [mse of each image]}, the metrics records,
    the printed output); fails unless every render_final_<i>.png is
    written and every MSE is finite."""
    with tempfile.TemporaryDirectory() as out:
        reset_counts()
        printed = run_cli(argv + ["--log-every", "1", "--out", out])
        launches = read_counts()
        recs = read_metrics(out)
        pngs = sorted(x for x in os.listdir(out) if x.endswith(".png"))
    mse = {r["iter"]: r["mse"] for r in recs if "iter" in r}
    want = [f"render_final_{i:02d}.png" for i in range(n_images)]
    log(f"  launches: { {k: v for k, v in launches.items() if v} }; "
        f"renders {pngs}; {printed.splitlines()[-1]}")
    if pngs != want or len(mse) != iters or not np.isfinite(
            [x for v in mse.values() for x in v]).all() or any(
            len(v) != n_images for v in mse.values()):
        raise AssertionError("batched fit: renders, trajectory or MSEs "
                             "wrong")
    return launches, mse, recs, printed


def synthetic_npy(tmp: str, name: str, height: int, width: int,
                  seed: int) -> str:
    from gs2d_tpu_torch.io.image import synthetic_target

    path = os.path.join(tmp, name)
    np.save(path, synthetic_target(height, width, seed=seed))
    return path


def batched_phase(dev, smi: str, mse_l2: dict) -> dict:
    """Several images on one command line (train/loop.py's batched steps,
    train/densify.py::fit_adaptive_batched, the CLI's several-image route):

    - the default fit on two 268x213 targets (squirrel_cls_mini and
      synthetic_target seed 1), 1024 splats, 200 iterations, eager and
      --scan-chunk 50: image 0 equals the one-image default fit
      (``mse_l2``) 200 of 200 bit for bit, the scanned batch equals the
      eager batch for both images, one capture, l2_resident 2 x 200
      launches, both renders written; ms a batched step, and the device
      profile of 10 batched steps beside 10 replays of the one-image
      scanned step;
    - the 10k fit with --densify-every 100 on squirrel_cls and a synthetic
      target of its size, 300 iterations, --scan-chunk 50: each image
      equals the port's one-image fit_adaptive (the CLI on that image
      alone) bit for bit, no pair dropped without a report, the live
      counts of each window.

    Returns the summed launch counts of the phase's logged runs."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.parallel.sharded import init_batched_state
    from gs2d_tpu_torch.train.loop import (init_train_state,
                                           make_fit_scan_batched,
                                           make_fit_scan_fused)

    t_phase = time.perf_counter()
    total = {}

    def count(launches):
        for kk, v in launches.items():
            total[kk] = total.get(kk, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        mini = load_image(MINI)
        h, w = mini.shape[:2]
        second = synthetic_npy(tmp, "synthetic_mini.npy", h, w, 1)
        base = [MINI, second, "--splats", "1024", "--iters", "200",
                "--device", "cuda"]
        runs = {}
        for name, extra in (("eager", []), ("scanned", SCAN)):
            log(f"[batched] python -m gs2d_tpu_torch.fit "
                f"{' '.join(os.path.basename(a) for a in base[:2])} "
                f"{' '.join(base[2:] + extra)}")
            launches, mse, recs, printed = batched_logged_fit(
                base + extra, 2, 200)
            expect_launches(f"batched default fit ({name})", launches,
                            {"l2_resident": 400, "fwd_resident": 2})
            count(launches)
            check_drops(f"batched {name} fit", recs, printed)
            runs[name] = (mse, recs, printed)
        (mse_e, recs_e, _), (mse_s, recs_s, out_s) = runs["eager"], \
            runs["scanned"]
        first = sum(mse_e[i][0] == mse_l2[i] for i in range(200))
        same = sum(mse_s[i] == mse_e[i] for i in range(200))
        captures = len([x for x in out_s.splitlines()
                        if x.startswith("captured the train step")])
        log(f"  image 0 equals the one-image default fit at {first} of 200 "
            f"MSEs (MSE-255 @ 50 {mse_e[49][0]:.4f}, @ 200 "
            f"{mse_e[199][0]:.4f}; image 1 {mse_e[199][1]:.4f}); scanned "
            f"equals eager at {same} of 200 steps (both images); "
            f"{captures} capture")
        if first != 200 or same != 200 or captures != 1:
            raise AssertionError("the batched default fit differs from the "
                                 "one-image fit or from its eager twin, or "
                                 "captured more than once")
        check_trajectory({i: v[0] for i, v in mse_e.items()},
                         {it: (want, TRAJECTORY_RTOL)
                          for it, want in TRAJECTORY.items()})
        steps = {r["iter"]: r for r in recs_s if "iter" in r}
        steady = 1e3 * (steps[199]["elapsed_s"] - steps[49]["elapsed_s"]) \
            / 150
        eager_ms = 1e3 * (recs_e[-1]["seconds"]) / 200
        log(f"  ms a batched step (2 images): eager {eager_ms:.4f} (logged "
            f"run, a sync a step), scanned {steady:.4f} (steps 50-199 of "
            f"the logged run) [{smi}]")

        # The device profiles: 10 batched steps against 10 replays of the
        # one-image scanned step, as the CLI tunes them.
        cfg = SplatConfig(width=w, height=h, n_splats=1024)
        init = init_train_state(cfg, dev)
        cfg = tl.tune_tile_capacity(init.params, tl.tune_tile_height(
            cfg, init.params))
        ref0 = rd.pad_ref_chw(mini, cfg, dev)
        one_k = make_fit_scan_fused(cfg)
        one_k(init, ref0, 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            one_k(init, ref0, 10)
        torch.cuda.synchronize()
        one_ms = 1e3 * (time.perf_counter() - t0) / 50
        log(f"[profile] the one-image scanned default step, 10 replays "
            f"(5 blocks of 10: {one_ms:.4f} ms a step) [{smi}]")
        one = replay_profile(one_k, init, ref0, one_ms)
        refs = torch.stack([rd.pad_ref_chw(r, cfg, dev) for r in
                            (mini, load_image(second))])
        state = init_batched_state(cfg, 2, dev)
        fit_k = make_fit_scan_batched(cfg)
        fit_k(state, refs, 10)
        log("[profile] the batched scanned default step (2 images, each "
            "loaded into the captured step's buffers), 10 steps")
        prof = device_profile(lambda: fit_k(state, refs, 10), 10)
        log(profile_lines(prof, steady, 10))
        log(f"  a batched step is {prof['busy'] / one['busy']:.3f}x the "
            f"one-image step's busy ms and {prof['ops'] / one['ops']:.3f}x "
            "its operations")

        full = load_image(FULL)
        h, w = full.shape[:2]
        second = synthetic_npy(tmp, "synthetic_10k.npy", h, w, 1)
        tail = ["--splats", str(N_10K), "--iters", "300", "--device",
                "cuda", "--densify-every", "100", *SCAN]
        log(f"[batched] python -m gs2d_tpu_torch.fit squirrel_cls.npy "
            f"synthetic_10k.npy {' '.join(tail)}")
        t0 = time.perf_counter()
        launches, mse_b, recs, printed = batched_logged_fit(
            [FULL, second, *tail], 2, 300)
        log(f"  {time.perf_counter() - t0:.2f}s with tuning and capture "
            f"[{smi}]")
        expect_launches("batched adaptive 10k fit", launches,
                        {"fwd_flat": 602, "fwd_flat_mask": 602,
                         "bwd_flat": 600, "expand_flat": 602})
        count(launches)
        check_drops("batched adaptive fit", recs, printed, every=100)
        live_b = live_counts(printed)
        log(f"  live splats after each densify (image 0, image 1): "
            f"{live_b}")
        for i, image in enumerate((FULL, second)):
            launches, mse, _, printed = logged_fit(
                [image, *tail], iters=300, details=True)
            count(launches)
            same = sum(mse[it] == mse_b[it][i] for it in range(300))
            live = [x.split()[0] for x in live_counts(printed)]
            log(f"  image {i}: equals the one-image fit_adaptive at {same} "
                f"of 300 MSEs (MSE-255 @ 300 {mse[299]:.4f}); its live "
                f"counts {live}")
            if same != 300 or live != [x.split(",")[i].split()[0]
                                       for x in live_b]:
                raise AssertionError(f"batched adaptive image {i} differs "
                                     "from its one-image fit")
    log(f"  the batched phase took {time.perf_counter() - t_phase:.1f}s")
    return total


# ---- the mesh: parallel/ on torch.distributed --------------------------------

MESH_TILES = (2, 4)                              # tile axes of the band checks
MESH_SHARDS = ((1, 1, 2), (1, 1, 4), (1, 2, 2))  # (data, tile, splat) meshes
# Splat shards against the unsharded kernels (both at min_throughput 0): the
# MSE within the JAX tests' rtol 1e-3 (tests/test_sharding.py), and the
# parameters after Adam within their atol / rtol: at lr 0.05 pos and color
# (atol 2e-2, rtol 1e-4), at lr 1e-4 every field (atol 1e-4, rtol 1e-7).
SHARD_MSE_RTOL = 1e-3
SHARD_PARAM_TOLS = {0.05: (("pos", "color"), 2e-2, 1e-4),
                    1e-4: (None, 1e-4, 1e-7)}
# The splat shards' first-step gradient may be at most this many times as
# far from the float64 gradient as the unsharded kernel's is (field by
# field, floor GRAD_RTOL): the two are float32 evaluations of the same
# sums in different orders.
SHARD_F64_FACTOR = 2.0
# The --mesh 1,1,1 fit's MSEs against the one-image fit's: the mesh sums the
# squared error over bands (gs2d_tpu's sum * 255^2 / n), the one-image fit
# takes the mean of ((C - ref) * 255)^2, an ulp apart.
MESH_MSE_RTOL = 1e-6


@contextlib.contextmanager
def plain_versions(modules=("render_resident", "render_dense", "render_flat",
                            "tiles_flat")):
    """The kernel wrappers of ``modules`` (of gs2d_tpu_torch.ops; by
    default the resident, dense and flat layouts and the flat binning's
    expansion) run their plain PyTorch versions on the card's tensors (no
    launch is counted)."""
    import importlib

    mods = [importlib.import_module(f"gs2d_tpu_torch.ops.{m}")
            for m in modules]
    saved = [m.on_card for m in mods]
    for m in mods:
        m.on_card = lambda t: False
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.on_card = f


def band_bin(p, cfg, layout: str, band):
    """The layout's binning of the whole grid (band None) or of the band
    (row0, rows); no pair may drop."""
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.ops import tiles_flat as tlf

    kw = {} if band is None else dict(band_row0=band[0], band_rows=band[1])
    if layout == "flat":
        b = tlf.bin_splats_flat(p, cfg, cfg.flat_capacity, kc=cfg.flat_chunk,
                                max_chunks=cfg.flat_max_chunks, **kw)
    else:
        b = tl.bin_splats(p, cfg, cfg.max_splats_per_tile,
                          ids_only=layout == "resident", **kw)
    if int(b.n_dropped):
        raise AssertionError(f"{layout} band {band}: pairs dropped")
    return b


def band_calls(layout: str, b, p, cfg, band):
    """The layout's forward (kernels 2, 6/7, 10), L2 step (1, 4/5, 10 + 11)
    and carry-fed backward (3, 8/9, 11) wrappers on binning ``b`` under
    ``band`` = (row0, rows), or the whole grid."""
    from gs2d_tpu_torch.ops import render_dense as rdn
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import render_resident as rr

    kw = {} if band is None else dict(band_row0=band[0], band_rows=band[1])
    n, kc, mc = p.n, cfg.flat_chunk, cfg.flat_max_chunks
    table = rr.resident_table(p, cfg) if layout == "resident" else None

    def fwd():
        if layout == "flat":
            return rf.forward_flat(b, cfg, kc, mc, **kw)
        if layout == "resident":
            return rr.forward_resident(b, table, n, cfg, crop=False, **kw)
        return rdn.forward_tiled(b, cfg, crop=False, **kw)

    def l2(ref_chw):
        if layout == "flat":
            return rf.l2_render_and_grads_flat(b, ref_chw, n, cfg, kc, mc, p,
                                               **kw)
        if layout == "resident":
            return rr.l2_render_and_grads_resident(b, table, ref_chw, n, cfg,
                                                   **kw)
        return rdn.l2_render_and_grads(b, ref_chw, n, cfg, p, **kw)

    def bwd(fin, gc, carry):
        if layout == "flat":
            return rf.backward_flat(b, fin, gc, n, cfg, kc, mc, p,
                                    carry_in=carry, **kw)
        if layout == "resident":
            return rr.backward_resident(b, table, fin, gc, n, cfg,
                                        carry_in=carry, **kw)
        return rdn.backward_tiled(b, fin, gc, n, cfg, p, carry_in=carry,
                                  **kw)

    return fwd, l2, bwd


def grads_ratio(got, want) -> float:
    """The largest |got - want| over GRAD_RTOL * max(1, |want| max) of any
    gradient field (1 is the gate)."""
    from gs2d_tpu_torch.params import FIELDS

    return max(float((getattr(got, f) - getattr(want, f)).abs().max())
               / (GRAD_RTOL * max(1.0, float(getattr(want, f).abs().max())))
               for f in FIELDS)


def mesh_cases(dev) -> list:
    """(label, layout, cfg, params, padded target (3, Hp, Wp)) at the main
    paths' inits: the default fit's (resident and dense) and the 10k
    fit's (flat), with the tile heights the CLI picks."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import init_params

    out = []
    for label, image, n, layouts in (("default", MINI, 1024,
                                      ("resident", "dense")),
                                     ("10k", FULL, N_10K, ("flat",))):
        ref = load_image(image)
        cfg = SplatConfig(width=ref.shape[1], height=ref.shape[0],
                          n_splats=n)
        p = init_params(cfg, dev)
        cfg = tl.tune_tile_height(cfg, p)
        for layout in layouts:
            out.append((label, layout, cfg.replace(binning=layout), p, ref))
    return out


def padded_chw(ref, cfg, dev):
    from gs2d_tpu_torch.ops import render as rd

    return rd.pad_ref_chw(ref, cfg, dev)[0]


def banded_kernels(dev, cases) -> None:
    """Each case on tile axes of 2 and 4 bands (the grid rounded to whole
    bands, the binning statics tuned a band): every band's forward equals
    the unbanded kernel's rows bit for bit; the bands' L2 gradients summed
    in band order agree with the unbanded step's (GRAD_RTOL); on the last
    band (the image's bottom and the padding rows under it) the banded
    forward, L2 step and carry-fed backward equal their plain versions
    under the same band arguments (COLOR_ATOL, GRAD_RTOL)."""
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.params import FIELDS, GaussianParams
    from gs2d_tpu_torch.parallel.mesh import virtual_mesh
    from gs2d_tpu_torch.parallel.sharded import prepare_config

    for label, layout, cfg0, p, ref in cases:
        for n_bands in MESH_TILES:
            cfg = prepare_config(cfg0, virtual_mesh(1, n_bands, 1, dev), p)
            cfg_full = cfg if layout != "flat" else rf.tune_flat_config(
                p, cfg.replace(flat_capacity=None, flat_max_chunks=None))
            ref_chw = padded_chw(ref, cfg, dev)
            fwd, l2, _ = band_calls(layout, band_bin(p, cfg_full, layout,
                                                     None), p, cfg_full, None)
            c_full, t_full = fwd()
            _, g_full = l2(ref_chw[None].contiguous())
            gen = torch.Generator(dev).manual_seed(n_bands)
            gc = torch.randn(c_full.shape, generator=gen, device=dev)
            carry = (0.5 * c_full, 0.5 * t_full)
            rows = cfg.n_tiles_y // n_bands
            bh = rows * cfg.tile_h
            total, plain = None, {}
            for i in range(n_bands):
                band = (i * rows, rows)
                sl = slice(i * bh, (i + 1) * bh)
                b = band_bin(p, cfg, layout, band)
                fwd, l2, bwd = band_calls(layout, b, p, cfg, band)
                c_k, t_k = fwd()
                if not (torch.equal(c_k, c_full[sl])
                        and torch.equal(t_k, t_full[sl])):
                    raise AssertionError(f"{label} {layout}: band {i} of "
                                         f"{n_bands} differs from the rows")
                ref_b = ref_chw[None, :, sl].contiguous()
                col_k, g_k = l2(ref_b)
                total = g_k if total is None else GaussianParams(**{
                    f: getattr(total, f) + getattr(g_k, f) for f in FIELDS})
                if i < n_bands - 1:
                    continue
                bwd_in = (c_full[sl], gc[sl].contiguous(),
                          (carry[0][sl], carry[1][sl].contiguous()))
                gb_k = bwd(*bwd_in)
                with plain_versions():
                    c_p, t_p = fwd()
                    col_p, g_p = l2(ref_b)
                    gb_p = bwd(*bwd_in)
                plain = {
                    "colour": max(float((c_k - c_p).abs().max()),
                                  float((t_k - t_p).abs().max()),
                                  float((col_k - col_p).abs().max())),
                    "l2": grads_ratio(g_k, g_p),
                    "backward": grads_ratio(gb_k, gb_p)}
            summed = grads_ratio(total, g_full)
            log(f"  {label} {layout}, {n_bands} bands of {rows} tile rows "
                f"(grid {cfg.n_tiles_y}x{cfg.n_tiles_x}): forward rows bit "
                f"for bit; band sums / GRAD_RTOL {summed:.3e}; last band vs "
                f"plain: colour {plain['colour']:.2e} (COLOR_ATOL "
                f"{COLOR_ATOL}), L2 / GRAD_RTOL {plain['l2']:.3e}, "
                f"carry-fed backward / GRAD_RTOL {plain['backward']:.3e}")
            if summed > 1 or plain["colour"] > COLOR_ATOL \
                    or plain["l2"] > 1 or plain["backward"] > 1:
                raise AssertionError(f"{label} {layout}: banded kernels off")


def f64_gradients(p, cfg, ref, dev):
    """The first L2 step's parameter gradients at min_throughput 0 with every
    sum in float64: the plain dense walk (render_dense._l2_dense_plain) on
    the float32 binning's rows cast to float64, coverage decided on the
    float32 rows as the kernels decide it. The reference of every layout's
    float32 step at this init."""
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_dense as rdn
    from gs2d_tpu_torch.ops import tiles as tl

    cfg = tl.tune_tile_capacity(p, cfg.replace(
        binning="dense", max_splats_per_tile=None, min_throughput=0.0))
    b = band_bin(p, cfg, "dense", None)
    ref64 = padded_chw(ref, cfg, dev).double()[None]
    _, _, g9 = rdn._l2_dense_plain(rdn._tile_params(b).double(), b.ids,
                                   b.count, ref64, p.n, cfg)
    return rd.moments_to_grads(rd.unpack_moments(g9, p.n),
                               rdn._fields_of(p, cfg))


def f64_fit(p, cfg0, ref, dev, steps: int = 3):
    """``steps`` steps of the fit at min_throughput 0 from ``p`` with the
    float64 gradients (``f64_gradients`` at the parameters rounded to
    float32, which the binning takes) and Adam in float64: the parameters
    the float32 fits are held to."""
    from gs2d_tpu_torch.train.adam import adam_update, init_adam_state

    params = p.map(lambda x: x.double())
    opt = init_adam_state(params)
    for _ in range(steps):
        g = f64_gradients(params.map(lambda x: x.float()), cfg0, ref, dev)
        params, opt = adam_update(params, g, opt, cfg0)
    return params


def shard_items(p, ref_chw, plan, mesh, dtype=torch.float32) -> dict:
    """{coord: (its slice of the splats, its band of the padded target)}:
    the band step's inputs on a virtual mesh."""
    n_local = p.n // mesh.shape["splat"]
    ref_img = ref_chw.permute(1, 2, 0).to(dtype)
    return {c: (p.map(lambda x: x[c[2] * n_local: (c[2] + 1) * n_local]),
                ref_img[c[1] * plan.band_h:
                        (c[1] + 1) * plan.band_h].contiguous())
            for c in mesh.coords}


def shard_grads(out: dict, mesh):
    """The whole population's gradients and colour from a band step's
    {coord: (band colour, grads, n_dropped)}."""
    from gs2d_tpu_torch.params import FIELDS, GaussianParams

    fin = torch.cat([out[(0, t, 0)][0] for t in range(mesh.shape["tile"])])
    return fin, GaussianParams(**{f: torch.cat(
        [getattr(out[(0, 0, s)][1], f) for s in range(mesh.shape["splat"])])
        for f in FIELDS})


def sharded_f64(p, cfg0, ref, mesh, dev):
    """The splat shards' first step in float64 (the plain dense versions
    on the shards' binnings with their rows cast to float64, the fold and
    the tile-axis sum in float64): the shards' arithmetic without
    float32's rounding."""
    from gs2d_tpu_torch.parallel import sharded as tsh

    cfg = tsh.prepare_config(cfg0.replace(
        binning="dense", max_splats_per_tile=None), mesh, p)
    plan = tsh._plan(cfg, mesh, "fold", "pallas", 0, 0.0)
    items = shard_items(p, padded_chw(ref, cfg, dev), plan, mesh,
                        torch.float64)
    prebuilt = {}
    for c, (pc, _) in items.items():
        b = tsh._bin_band(pc, plan, tsh._band_r0(plan, c))
        prebuilt[c] = b._replace(tile_params=b.tile_params.double())
    with plain_versions():
        out = tsh._pallas_band_step(mesh.comm, items, plan,
                                    prebuilt=prebuilt)
    return shard_grads(out, mesh)[1]


def sharded_kernels(dev, cases) -> None:
    """Splat shards in one process, on (1, 1, 2), (1, 1, 4) and (1, 2, 2),
    at the default and the 10k inits, all at min_throughput 0 (the
    sharded step's). For each mesh, the first step of
    ``_pallas_band_step`` on a virtual mesh (the forward kernels 2, 6/7,
    10 per shard, the plain ordered fold, the carry-fed backward 3, 8/9,
    11 per shard, the tile-axis sum):

    - against itself through the kernels' plain versions (the same fold):
      colour within COLOR_ATOL, gradients within GRAD_RTOL;
    - in float64 (``sharded_f64``) against the unsharded step in float64
      (``f64_gradients``) within GRAD_RTOL: the shards' arithmetic is the
      unsharded step's;
    - against the unsharded L2 kernels in float32: colour within
      COLOR_ATOL; both steps' gradients against the float64 gradient, each
      field's largest error of the shards at most SHARD_F64_FACTOR times
      the unsharded kernel's (floor GRAD_RTOL). Logged beside it, where
      the two float32 steps part: how many parameters differ by more than
      GRAD_RTOL, and how many of those have an exact gradient smaller than
      that difference;
    - ``fit_sharded`` and ``train.loop.fit``, three steps from the same
      init at lr 0.05 and 1e-4, each against the float64 fit (``f64_fit``)
      under the JAX tests' tolerances (SHARD_PARAM_TOLS, from
      tests/test_sharding.py:49-101) where float32 resolves the first-step
      gradient, that is where the exact gradient exceeds
      SHARD_F64_FACTOR times the larger error of the two float32 steps
      (Adam's first step takes its sign): where the unsharded fit meets the
      tolerance there, the shards' fit must too; where it misses it, the
      shards' fit may miss it by at most SHARD_F64_FACTOR times as much
      (largest |diff| over the tolerance); the two fits' MSEs within
      SHARD_MSE_RTOL. Logged beside it,
      the shards against the unsharded fit directly, as the JAX tests
      compare them, and how many values each comparison puts over."""
    from gs2d_tpu_torch.params import FIELDS
    from gs2d_tpu_torch.parallel import sharded as tsh
    from gs2d_tpu_torch.parallel.mesh import virtual_mesh
    from gs2d_tpu_torch.train.loop import fit, state_index

    def shard_limit(ex) -> float:
        """1 (the JAX tolerance) where the unsharded fit meets it against
        the float64 fit, else SHARD_F64_FACTOR times its miss."""
        u = ex["unsharded"][0]
        return 1.0 if u <= 1.0 else SHARD_F64_FACTOR * u

    exact = {}
    for label, layout, cfg0, p, ref in cases:
        cfg0 = cfg0.replace(min_throughput=0.0)
        if label not in exact:
            t = time.perf_counter()
            exact[label] = f64_gradients(p, cfg0, ref, dev)
            log(f"  {label}: the float64 gradient in "
                f"{time.perf_counter() - t:.1f}s")
        g64 = exact[label]
        for shape in MESH_SHARDS:
            t_case = time.perf_counter()
            mesh = virtual_mesh(*shape, dev)
            cfg = tsh.prepare_config(cfg0, mesh, p)
            cfg_full = cfg if layout != "flat" else tsh.prepare_config(
                cfg0.replace(tile_rows_multiple=cfg.tile_rows_multiple),
                virtual_mesh(1, 1, 1, dev), p)
            ref_chw = padded_chw(ref, cfg, dev)
            _, l2, _ = band_calls(layout, band_bin(p, cfg_full, layout,
                                                   None), p, cfg_full, None)
            col, g_full = l2(ref_chw[None].contiguous())
            plan = tsh._plan(cfg, mesh, "fold", "pallas", 0, 0.0)
            items = shard_items(p, ref_chw, plan, mesh)
            fin, g = shard_grads(tsh._pallas_band_step(mesh.comm, items,
                                                       plan), mesh)
            with plain_versions():
                fin_p, g_p = shard_grads(tsh._pallas_band_step(
                    mesh.comm, items, plan), mesh)
            vs_plain = (float((fin - fin_p).abs().max()), grads_ratio(g, g_p))
            if (label, shape) not in exact:  # the same for every layout
                exact[label, shape] = sharded_f64(p, cfg0, ref, mesh, dev)
            f64 = grads_ratio(exact[label, shape], g64)
            colour = float((fin[: cfg.height, : cfg.width] - col)
                           .abs().max())
            worst, n_diff, n_below, unresolved = 0.0, 0, 0, {}
            for f in FIELDS:
                x64 = getattr(g64, f)
                tol = GRAD_RTOL * max(1.0, float(x64.abs().max()))
                e_full = (getattr(g_full, f).double() - x64).abs()
                e_shard = (getattr(g, f).double() - x64).abs()
                worst = max(worst, float(e_shard.max()) / (
                    SHARD_F64_FACTOR * max(float(e_full.max()), tol)))
                diff = (getattr(g, f) - getattr(g_full, f)).double().abs()
                n_diff += int((diff > tol).sum())
                n_below += int(((diff > tol) & (x64.abs() < diff)).sum())
                unresolved[f] = x64.abs() <= SHARD_F64_FACTOR * torch.maximum(
                    e_full, e_shard)
            errs = {}
            for lr, (fields, atol, rtol) in SHARD_PARAM_TOLS.items():
                key = (label, lr)
                if key not in exact:
                    exact[key] = f64_fit(p, cfg0.replace(learning_rate=lr),
                                         ref, dev)
                got, hist = tsh.fit_sharded(
                    ref[None], cfg.replace(learning_rate=lr), mesh, 3,
                    log_every=1, log_fn=None)
                want, whist = fit(ref, cfg_full.replace(learning_rate=lr), 3,
                                  dev, log_every=1, log_fn=None)
                got = state_index(got, 0).params
                ex = {"shards": [0.0, 0], "unsharded": [0.0, 0],
                      "direct": [0.0, 0]}
                n_left = 0
                for f in fields or FIELDS:
                    keep = ~unresolved[f]
                    n_left += int((~keep).sum())
                    w64 = getattr(exact[key], f)
                    w = getattr(want.params, f)
                    for name, x, y in (("shards", getattr(got, f), w64),
                                       ("unsharded", w, w64),
                                       ("direct", getattr(got, f), w)):
                        over = (x.double() - y).abs() / (rtol * y.abs()
                                                         + atol)
                        ex[name][1] += int((over > 1).sum())
                        if bool(keep.any()):
                            ex[name][0] = max(ex[name][0],
                                              float(over[keep].max()))
                rel = max(abs(a["mse"][0] - b["mse"]) / b["mse"]
                          for a, b in zip(hist, whist))
                errs[lr] = (ex, n_left, rel)
            log(f"  {label} {layout}, mesh {shape}, first step: kernels vs "
                f"plain colour {vs_plain[0]:.2e} (tol {COLOR_ATOL}), grads / "
                f"GRAD_RTOL {vs_plain[1]:.3e}; float64 shards vs float64 "
                f"unsharded / GRAD_RTOL {f64:.3e}; vs the unsharded kernel: "
                f"colour {colour:.2e} (tol {COLOR_ATOL}), grads vs float64 / "
                f"GRAD_RTOL: unsharded {grads_ratio(g_full, g64):.3e}, "
                f"shards {grads_ratio(g, g64):.3e} (shards' error / "
                f"({SHARD_F64_FACTOR} x the unsharded's) {worst:.3f}, tol "
                f"1); shards vs unsharded {grads_ratio(g, g_full):.3e}: "
                f"{n_diff} parameters over GRAD_RTOL, {n_below} of them where "
                f"|float64 gradient| < the difference "
                f"({time.perf_counter() - t_case:.1f}s)")
            for lr, (ex, nl, r) in errs.items():
                fields, atol, rtol = SHARD_PARAM_TOLS[lr]
                log(f"    3 steps at lr {lr}, {'/'.join(fields or ['all'])}, "
                    f"max |diff| / ({atol} + {rtol} |want|) where float32 "
                    f"resolves the gradient ({nl} values left out), and the "
                    f"values over 1 in all: shards vs float64 fit "
                    f"{ex['shards'][0]:.3f}, {ex['shards'][1]}; unsharded vs "
                    f"float64 fit {ex['unsharded'][0]:.3f}, "
                    f"{ex['unsharded'][1]} (the shards' gate "
                    f"{shard_limit(ex):.3f}); shards vs unsharded "
                    f"{ex['direct'][0]:.3f}, {ex['direct'][1]}; MSE rel "
                    f"{r:.2e} (tol {SHARD_MSE_RTOL})")
            if vs_plain[0] > COLOR_ATOL or vs_plain[1] > 1 or f64 > 1 \
                    or colour > COLOR_ATOL or worst > 1 or any(
                        ex["shards"][0] > shard_limit(ex)
                        or r > SHARD_MSE_RTOL
                        for ex, _, r in errs.values()):
                raise AssertionError(f"{label} {layout} {shape}: splat "
                                     "shards disagree with the unsharded "
                                     "kernels")


def eager_step_profiles(dev, cfg, ref, mesh, smi: str) -> None:
    """One eager step of the default fit through the mesh
    (``make_sharded_train_step`` on ``mesh``) and through train.loop's
    one-image step, from the same init: ms a step over 50 steps, the
    device's busy ms and operations a step (10 steps), and the host
    operations that take the most host time (torch.profiler, 10 steps)."""
    from torch.profiler import ProfilerActivity, profile

    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.parallel.sharded import (make_sharded_train_step,
                                                 pad_ref_batch)
    from gs2d_tpu_torch.train.loop import (init_batched_state,
                                           init_train_state,
                                           make_train_step_fused)

    step, sh = make_sharded_train_step(cfg, mesh, with_grad_mag=False)
    ref_in = rd.pad_ref_chw(ref, cfg, dev)
    one = make_train_step_fused(cfg)
    runs = {"mesh": [step, sh["state"](init_batched_state(cfg, 1, dev)),
                     sh["ref"](pad_ref_batch(ref[None], cfg, dev))],
            "one-image": [one, init_train_state(cfg, dev), ref_in]}

    def run(label, n):
        r = runs[label]
        for _ in range(n):
            r[1], _ = r[0](r[1], r[2])

    hosts = {}
    for label in runs:
        run(label, 5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(label, 50)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / 50
        prof = device_profile(lambda: run(label, 10), 10)
        with profile(activities=[ProfilerActivity.CPU]) as host:
            run(label, 10)
        hosts[label] = {e.key: (e.self_cpu_time_total / 1e4, e.count / 10)
                        for e in host.key_averages()}
        rows = sorted(((t, n, key) for key, (t, n) in hosts[label].items()),
                      reverse=True)
        log(f"[mesh] one eager {label} step of the default fit: "
            f"{ms:.4f} ms a step (50 steps) [{smi}]")
        log(profile_lines(prof, ms, 10))
        log(f"  host (torch.profiler, CPU): {sum(r[0] for r in rows):.4f} "
            f"ms a step of host operations' own time, "
            f"{sum(r[1] for r in rows):.0f} operations a step; the most:")
        for t, n, key in rows[:6]:
            log(f"    {t:.4f} ms/step x{n:.0f}: {key[:70]}")
    mesh, one = hosts["mesh"], hosts["one-image"]
    extra = sorted(((mesh[k][0] - one.get(k, (0.0, 0))[0],
                     mesh[k][1] - one.get(k, (0.0, 0))[1], k)
                    for k in mesh), reverse=True)
    log("  the mesh step's extra host time, by operation (ms a step, "
        "operations a step): " + "; ".join(
            f"{k[:40]} +{t:.4f} ms x{n:+.0f}" for t, n, k in extra[:8]))


def mesh_state_equals_fit(dev, smi: str) -> None:
    """fit_sharded on a process mesh of one device (NCCL, a world of one
    rank) against train.loop.fit, 200 eager steps of the default fit from
    the same tuned config: the final parameters and Adam state; then the
    eager steps' profiles (``eager_step_profiles``)."""
    import torch.distributed as dist

    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.parallel.mesh import make_mesh
    from gs2d_tpu_torch.parallel.sharded import fit_sharded, prepare_config
    from gs2d_tpu_torch.params import init_params
    from gs2d_tpu_torch.train.loop import fit, state_index, state_leaves

    ref = load_image(MINI)
    cfg = SplatConfig(width=ref.shape[1], height=ref.shape[0],
                      n_splats=1024)
    cfg = tl.tune_tile_height(cfg, init_params(cfg, dev))
    mesh = make_mesh(1, 1, 1, devices=[dev])
    try:
        cfg = prepare_config(cfg, mesh, init_params(cfg, dev))
        got, _ = fit_sharded(ref[None], cfg, mesh, 200, log_fn=None)
        want, _ = fit(ref, cfg, 200, dev, log_fn=None)
        eager_step_profiles(dev, cfg, ref, mesh, smi)
    finally:
        dist.destroy_process_group()
    same = all(torch.equal(x, y) for x, y in
               zip(state_leaves(state_index(got, 0)), state_leaves(want)))
    log(f"  fit_sharded on a process mesh of one device (NCCL, world of "
        f"one) vs train.loop.fit, 200 eager steps: final state bit for bit: "
        f"{same}")
    if not same:
        raise AssertionError("the mesh of one device differs from the fit")


# The captured virtual meshes of ``captured_meshes``: (label, image,
# splats, mesh shape, combine, rebin margin, images).
CAPTURED_MESHES = (
    ("default (1,2,1) fold", "mini", 1024, (1, 2, 1), "fold", 0.0, 1),
    ("default (1,1,2) scan", "mini", 1024, (1, 1, 2), "scan", 0.0, 1),
    ("default (1,2,2) fold, margin 2", "mini", 1024, (1, 2, 2), "fold", 2.0,
     1),
    ("default (2,1,1), two images, margin 2", "mini", 1024, (2, 1, 1),
     "fold", 2.0, 2),
    ("10k flat (1,2,1), margin 2", "full", N_10K, (1, 2, 1), "fold", 2.0, 1),
)


def mesh_targets(image: str, n_images: int) -> np.ndarray:
    """The fit's target, and for a second image a synthetic target of its
    size (seed 1, as the batched phase's)."""
    from gs2d_tpu_torch.io.image import load_image, synthetic_target

    ref = load_image(MINI if image == "mini" else FULL)
    return np.stack([ref] + [synthetic_target(*ref.shape[:2], seed=1)]
                    * (n_images - 1))


def captured_meshes(dev, smi: str) -> dict:
    """Captured virtual meshes on one card (``make_fit_scan_sharded``: one
    captured step holds every coordinate's band step and the mesh's
    combines as tensor operations, replayed with no host work between the
    steps of a block): for each of CAPTURED_MESHES, ``fit_sharded`` in
    blocks of 50 against the same mesh's per-step ``fit_sharded``, 200
    steps logged at every step, from the same init: final state and 200
    MSEs bit for bit; both fits' steady ms a step (steps 50-199; the
    scanned run's records are block ends); for the default fit's meshes
    the device profile of 10 replays and the replays' idle share against
    the scanned steady ms. The launch counts are set to 0 just before each
    scanned run and read just after. Returns their sum."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.parallel.mesh import virtual_mesh
    from gs2d_tpu_torch.parallel.sharded import (fit_sharded,
                                                 make_fit_scan_sharded,
                                                 pad_ref_batch,
                                                 prepare_config)
    from gs2d_tpu_torch.params import init_params
    from gs2d_tpu_torch.train.loop import (init_batched_state, state_index,
                                           state_leaves)

    t_sub = time.perf_counter()
    total = {}
    log("[mesh] captured virtual meshes on one card: blocks of 50 against "
        "the same mesh's per-step fit, 200 steps")
    for label, image, n, shape, combine, margin, n_img in CAPTURED_MESHES:
        refs = mesh_targets(image, n_img)
        cfg = SplatConfig(width=refs.shape[2], height=refs.shape[1],
                          n_splats=n, rebin_margin=margin)
        cfg = tl.tune_tile_height(cfg, init_params(cfg, dev))
        mesh = virtual_mesh(*shape, device=dev)
        init = init_batched_state(cfg, n_img, dev)
        kw = dict(log_every=1, log_fn=None, combine=combine, state=init)
        eager, h_e = fit_sharded(refs, cfg, mesh, 200, **kw)
        reset_counts()
        lines = []
        scanned, h_s = fit_sharded(refs, cfg, mesh, 200, scan_chunk=50,
                                   **{**kw, "log_fn": lines.append})
        torch.cuda.synchronize()
        launches = read_counts()
        for kk, v in launches.items():
            total[kk] = total.get(kk, 0) + v
        state_same = all(torch.equal(x, y) for x, y in
                         zip(state_leaves(scanned), state_leaves(eager)))
        mse_e = [r["mse"] for r in h_e]
        mse_s = [r["mse"] for r in h_s]
        same = sum(a == b for a, b in zip(mse_s, mse_e))
        at_e = {r["iter"]: r["elapsed_s"] for r in h_e}
        at_s = {r["iter"]: r["elapsed_s"] for r in h_s}
        ms_e = 1e3 * (at_e[199] - at_e[49]) / 150
        ms_s = 1e3 * (at_s[199] - at_s[49]) / 150
        rebins = sum(r["rebinned"] for r in h_s)
        log(f"  {label}: {lines[0] if lines else 'no mode line'}; final "
            f"state bit for bit {state_same}, {same} of 200 MSEs equal "
            f"(MSE @ 200 {mse_s[-1]}), {rebins} rebinned steps; steady ms "
            f"a step: scanned {ms_s:.4f}, per-step {ms_e:.4f} [{smi}]")
        log(f"    launches of the scanned run: "
            f"{ {k: v for k, v in launches.items() if v} }")
        if not state_same or same != 200:
            raise AssertionError(f"captured virtual mesh {label}: the "
                                 "blocks differ from the per-step fit")
        if image != "mini" or n_img != 1:
            continue
        cfg_p = prepare_config(cfg, mesh, state_index(init, 0).params)
        fit_k, sh = make_fit_scan_sharded(cfg_p, mesh, combine=combine)
        states = sh["state"](init)
        bands = sh["ref"](pad_ref_batch(refs, cfg_p, dev))
        fit_k(states, bands, 10)
        g = fit_k.graph
        g.load([t for c in mesh.coords for t in state_leaves(states[c])],
               torch.stack([bands[c] for c in mesh.coords]))

        def replays():
            for _ in range(10):
                g.graph.replay()

        prof = device_profile(replays, 10)
        log(f"    10 replays of the captured step ({len(mesh.coords)} "
            f"coordinates, {len(g.caches)} lazy caches):")
        log(profile_lines(prof, ms_s, 10))
    log(f"  the captured virtual meshes took "
        f"{time.perf_counter() - t_sub:.1f}s [{smi}]")
    return total


# A mesh's fit against the fit of one device, where the two sum in other
# orders: the MSE tolerance of gs2d_tpu's own sharding tests
# (tests/test_sharding.py, 3 steps) for the tile axis; the splat axis also
# turns the early-out off (min_throughput 0).
CLUSTER_RTOL = {"1,2,1": 1e-3, "1,1,2": 1e-2}


def cluster_case(dev, shape) -> tuple:
    """The default fit's targets (one an image of the data axis), cfg (2 px
    rebin margin, tuned tile height) and init for a mesh of ``shape``, as
    every rank of ``cluster_rank`` and the virtual mesh it is held to build
    them."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import init_params
    from gs2d_tpu_torch.train.loop import init_batched_state

    refs = mesh_targets("mini", shape[0])
    cfg = SplatConfig(width=refs.shape[2], height=refs.shape[1],
                      n_splats=1024, rebin_margin=2.0)
    cfg = tl.tune_tile_height(cfg, init_params(cfg, dev))
    return refs, cfg, init_batched_state(cfg, shape[0], dev)


def cluster_rank(argv) -> int:
    """One rank of a NCCL cluster of ``mesh_cluster`` (``chip_smoke.py
    --cluster-rank RANK NPROC PORT D,T,S COMBINE OUT``): ``cluster_case``'s
    fit on the mesh, 20 per-step steps and 20 in blocks of 10 (each rank's
    step captured with its NCCL collectives, its band's lazy rebin under a
    conditional node), from the same init. Rank 0 writes both fits' MSEs,
    the mode line and both fits' ms a step (steps 10-19) to OUT as JSON and
    both final states to OUT.pt."""
    from gs2d_tpu_torch.parallel.mesh import make_mesh
    from gs2d_tpu_torch.parallel.multihost import initialize_cluster
    from gs2d_tpu_torch.parallel.sharded import fit_sharded
    from gs2d_tpu_torch.train.loop import state_leaves

    rank, nproc, port = int(argv[0]), int(argv[1]), int(argv[2])
    shape = tuple(int(x) for x in argv[3].split(","))
    combine, out = argv[4], argv[5]
    initialize_cluster(coordinator_address=f"127.0.0.1:{port}",
                       num_processes=nproc, process_id=rank)
    import torch.distributed as dist

    try:
        mesh = make_mesh(*shape)
        refs, cfg, init = cluster_case(mesh.device, shape)
        kw = dict(log_every=1, combine=combine, state=init)
        eager, h_e = fit_sharded(refs, cfg, mesh, 20, log_fn=None, **kw)
        lines = []
        scanned, h_s = fit_sharded(refs, cfg, mesh, 20, scan_chunk=10,
                                   log_fn=lines.append, **kw)
        torch.cuda.synchronize()
        if rank == 0:
            ms = lambda h: 1e3 * (h[19]["elapsed_s"] - h[9]["elapsed_s"]) / 10
            with open(out, "w") as f:
                json.dump({"eager": [r["mse"] for r in h_e],
                           "scanned": [r["mse"] for r in h_s],
                           "mode": lines[:1], "ms_eager": ms(h_e),
                           "ms_scanned": ms(h_s),
                           "rebinned": sum(r["rebinned"] for r in h_s)}, f)
            torch.save({k: [t.cpu() for t in state_leaves(v)]
                        for k, v in (("eager", eager), ("scanned", scanned))},
                       out + ".pt")
    finally:
        dist.destroy_process_group()
    return 0


def mesh_cluster(dev, smi: str, mse_mesh: dict) -> None:
    """With two or more cards, NCCL clusters, one process a card:

    - the CLI's ``--mesh 1,2,1`` and ``--mesh 1,1,2`` on two ranks, 20 steps
      of the default fit, eager (against the world-of-one fit's first 20
      MSEs within CLUSTER_RTOL) and with ``--scan-chunk 10 --rebin-margin
      2`` (each rank replays one captured step with its NCCL collectives in
      the graph; against the eager cluster's MSEs bit for bit);
    - ``cluster_rank`` on the same meshes (fold combine), and with four or
      more cards on (1,2,2) with the fold and the scan combine (all-gathers,
      all-reduces and the scan's point-to-point exchanges in the graph):
      the captured blocks against the per-step fit, and the per-step fit
      against the virtual mesh of the same shape on one card (the same
      sums in the same order), final states and 20 MSEs bit for bit."""
    import subprocess

    from gs2d_tpu_torch.parallel.mesh import _free_port, virtual_mesh
    from gs2d_tpu_torch.parallel.sharded import fit_sharded
    from gs2d_tpu_torch.train.loop import state_leaves

    n = torch.cuda.device_count()
    if n < 2:
        log(f"  a cluster of NCCL ranks needs two cards; this machine has "
            f"{n}: no cluster ran, no graph holding NCCL collectives was "
            f"replayed across ranks [{smi}]")
        return
    log(f"  {n} cards, NCCL {torch.cuda.nccl.version()}")

    def launch(cmds, nproc):
        port = _free_port()
        procs = [subprocess.Popen(
            cmd(port), env=dict(os.environ,
                                COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                                NUM_PROCESSES=str(nproc),
                                PROCESS_ID=str(r), LOCAL_RANK=str(r)),
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r, cmd in enumerate(cmds)]
        try:
            outs = [pr.communicate(timeout=180)[0] for pr in procs]
        finally:
            for pr in procs:
                pr.kill()
        if any(pr.returncode for pr in procs):
            raise AssertionError("cluster failed: " + " | ".join(
                o[-1500:] for o in outs))
        return outs

    def ranks(shape: str, combine: str):
        """cluster_rank on len(shape) ranks against the virtual mesh."""
        dims = tuple(int(x) for x in shape.split(","))
        nproc = dims[0] * dims[1] * dims[2]
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "rank0.json")
            launch([lambda port, r=r: [
                sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                "--cluster-rank", str(r), str(nproc), str(port), shape,
                combine, out] for r in range(nproc)], nproc)
            res = json.load(open(out))
            states = torch.load(out + ".pt")
        refs, cfg, init = cluster_case(dev, dims)
        want, hist = fit_sharded(refs, cfg, virtual_mesh(*dims, device=dev),
                                 20, log_every=1, log_fn=None,
                                 combine=combine, state=init)
        same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
        blocks = sum(a == b for a, b in zip(res["scanned"], res["eager"]))
        virtual = sum(a == r["mse"] for a, r in zip(res["eager"], hist))
        blocks_state = same(states["scanned"], states["eager"])
        virtual_state = same(states["eager"],
                             [t.cpu() for t in state_leaves(want)])
        log(f"  --mesh {shape}, {nproc} NCCL ranks, {combine} combine "
            f"(cluster_rank): {res['mode']}; blocks of 10 at margin 2 "
            f"against 20 per-step steps: {blocks} of 20 MSEs equal, final "
            f"state bit for bit {blocks_state}, {res['rebinned']} rebinned "
            f"steps; the per-step fit against the virtual mesh: {virtual} "
            f"of 20 MSEs equal, final state bit for bit {virtual_state}; "
            f"ms a step (steps 10-19): scanned {res['ms_scanned']:.4f}, "
            f"per-step {res['ms_eager']:.4f} [{smi}]")
        if blocks != 20 or virtual != 20 or not blocks_state \
                or not virtual_state:
            raise AssertionError(f"{shape} {combine} cluster: the blocks, "
                                 "the per-step fit and the virtual mesh "
                                 "differ")

    for shape in ("1,2,1", "1,1,2"):
        rtol = CLUSTER_RTOL[shape]
        runs = {}
        for label, extra in (("eager", []), ("scanned", [
                "--scan-chunk", "10", "--rebin-margin", "2"])):
            with tempfile.TemporaryDirectory() as tmp:
                argv = [sys.executable, "-m", "gs2d_tpu_torch.fit", MINI,
                        "--splats", "1024", "--iters", "20", "--log-every",
                        "1", "--mesh", shape, "--out", tmp, *extra]
                outs = launch([lambda port: argv] * 2, 2)
                runs[label] = {r["iter"]: r["mse"][0]
                               for r in read_metrics(tmp) if "iter" in r}
            mode = [x for x in outs[0].splitlines()
                    if x.startswith("scanned blocks")]
            if label == "scanned" and not mode:
                raise AssertionError(f"--mesh {shape}: no scanned blocks")
        rel = max(abs(runs["eager"][i] - mse_mesh[i]) / mse_mesh[i]
                  for i in range(20))
        same = sum(runs["scanned"][i] == runs["eager"][i] for i in range(20))
        log(f"  --mesh {shape}, two NCCL ranks (the CLI): 20 steps, max MSE "
            f"rel diff from the world of one {rel:.2e} (tol {rtol}); "
            f"--scan-chunk 10 --rebin-margin 2 ({mode[0]}): {same} of 20 "
            f"MSEs equal the eager cluster's [{smi}]")
        if rel > rtol or same != 20:
            raise AssertionError(f"--mesh {shape} cluster off the fit")
        ranks(shape, "fold")
    if n < 4:
        log(f"  a (1,2,2) cluster needs four cards; this machine has {n}")
        return
    for combine in ("fold", "scan"):
        ranks("1,2,2", combine)


def mesh_phase(dev, smi: str) -> dict:
    """The mesh (parallel/ on torch.distributed; ``mesh_phase``):

    - banded kernels in one process (``banded_kernels``) and splat shards in
      one process (``sharded_kernels``) at the default and the 10k inits;
    - ``fit_sharded`` on a process mesh of one device against
      ``train.loop.fit``, final state bit for bit;
    - the CLI's ``--mesh 1,1,1`` (NCCL, a world of one rank) beside the
      one-image fit of the same flags (``twins``): the default fit eager
      and ``--scan-chunk 50 --rebin-margin 2`` (the 0.1% trajectory
      gates), the 10k flat fit (the JAX scan path's gates), each within
      MESH_MSE_RTOL of its twin, with both fits' ms a step; and a
      ``--checkpoint-every 100`` run resumed at 100, 200 of 200 MSEs equal
      to the unbroken run;
    - captured virtual meshes (``captured_meshes``): blocks of 50 on
      (1,2,1), (1,1,2), (1,2,2) and (2,1,1) meshes of the default fit and
      (1,2,1) of the 10k fit, each equal to its per-step fit bit for bit;
    - with two or more cards, NCCL clusters, eager and captured
      (``mesh_cluster``).

    Returns the summed launch counts of the phase's logged runs."""
    t_phase = time.perf_counter()
    total = {}

    def count(launches):
        for kk, v in launches.items():
            total[kk] = total.get(kk, 0) + v

    log("[mesh] banded kernels in one process (tile axes 2 and 4)")
    cases = mesh_cases(dev)
    banded_kernels(dev, cases)
    log("[mesh] splat shards in one process (the ordered fold)")
    sharded_kernels(dev, cases)
    mesh_state_equals_fit(dev, smi)

    def steady(recs) -> float:
        """ms a step over steps 50-199 of a logged run (record times are
        block ends when scanned)."""
        at = {r["iter"]: r["elapsed_s"] for r in recs if "iter" in r}
        return 1e3 * (at[199] - at[49]) / 150

    def twins(image, splats, extra, label):
        """The one-image fit and the --mesh 1,1,1 fit of the same flags,
        each logged at every step: the mesh's MSEs against the one-image
        fit's within MESH_MSE_RTOL, both fits' steady ms a step."""
        argv = [image, "--splats", str(splats), "--iters", "200",
                "--device", "cuda", *extra]
        log(f"[mesh] python -m gs2d_tpu_torch.fit {os.path.basename(image)} "
            f"{' '.join(argv[1:])} [--mesh 1,1,1]")
        l_one, want, recs_one, _ = logged_fit(argv, details=True)
        launches, mse, recs, printed = logged_fit(argv + ["--mesh", "1,1,1"],
                                                  details=True)
        count(l_one)
        mse = {k: v[0] for k, v in mse.items()}
        mode = [x for x in printed.splitlines()
                if x.startswith("scanned blocks")]
        rel = max(abs(mse[i] - want[i]) / want[i] for i in range(200))
        log(f"  {mode[0] if mode else 'eager steps'}; against the one-image "
            f"{label} fit: bit for bit {same_trajectory(mse, want)}, max "
            f"MSE rel diff {rel:.2e} (tol {MESH_MSE_RTOL}); steady ms a "
            f"step (steps 50-199, logged): mesh {steady(recs):.4f}, "
            f"one-image {steady(recs_one):.4f} [{smi}]")
        if rel > MESH_MSE_RTOL:
            raise AssertionError(f"--mesh 1,1,1 {label} fit off the fit")
        return launches, mse

    launches, mse_mesh = twins(MINI, 1024, [], "default")
    expect_launches("--mesh 1,1,1 default fit", launches,
                    {"l2_resident": 200, "fwd_dense": 1})
    count(launches)
    check_trajectory(mse_mesh, {it: (want, TRAJECTORY_RTOL)
                                for it, want in TRAJECTORY.items()})
    launches, mse = twins(MINI, 1024, LAZY, "scanned default")
    count(launches)
    check_trajectory(mse, {it: (want, TRAJECTORY_RTOL)
                           for it, want in TRAJECTORY.items()})
    launches, mse = twins(FULL, N_10K, [], "10k flat")
    expect_launches("--mesh 1,1,1 10k fit", launches,
                    {"fwd_flat": 200, "fwd_flat_mask": 200,
                     "bwd_flat": 200, "fwd_dense": 1,
                     "expand_flat": 200})
    count(launches)
    check_trajectory(mse, TRAJECTORY_10K)
    with tempfile.TemporaryDirectory() as out:
        base = [MINI, "--splats", "1024", "--iters", "100", "--device",
                "cuda", "--mesh", "1,1,1", "--checkpoint-every", "100"]
        log("[mesh] the default fit with --mesh 1,1,1 --checkpoint-every "
            "100, 100 iterations, then --resume for 100")
        launches, first = logged_fit(base, out=out, iters=100)
        count(launches)
        launches, second = logged_fit(base + ["--resume"], out=out,
                                      iters=100)
        count(launches)
    resumed = {**{k: v[0] for k, v in first.items()},
               **{k: v[0] for k, v in second.items()}}
    same = sum(resumed[i] == mse_mesh[i] for i in range(200))
    log(f"  resumed at 100: {same} of 200 MSEs equal the unbroken --mesh "
        f"1,1,1 fit")
    if same != 200:
        raise AssertionError("the resumed mesh fit differs")
    count(captured_meshes(dev, smi))
    mesh_cluster(dev, smi, mse_mesh)
    log(f"  the mesh phase took {time.perf_counter() - t_phase:.1f}s [{smi}]")
    return total


def top_band_cut(params, cfg, rows: int):
    """The splats whose tile box lies in the top ``rows`` tile rows, and
    the cfg of that band alone (height rows x tile_h, the same tiles):
    kernels 10 and 11 see the same pairs there as in the full image's
    binning of them, and the plain versions' host-bound walks stay short."""
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import FIELDS, GaussianParams

    _, _, _, ty1, off = tl.splat_tile_bbox(params, cfg)
    keep = torch.nonzero(~off & (ty1 < rows))[:, 0]
    cut = GaussianParams(**{f: getattr(params, f)[keep].contiguous()
                            for f in FIELDS})
    return cut, cfg.replace(height=rows * cfg.tile_h, n_splats=cut.n,
                            flat_capacity=None, flat_max_chunks=None)


def memory_line(what: str, peak: int, cfg, smi: str) -> str:
    from gs2d_tpu_torch.ops import render_flat as rf

    partial = 4 * int(np.prod(rf.partial_shape(cfg, cfg.flat_capacity)))
    return (f"  {what}: peak {peak / 2**30:.3f} GiB allocated "
            f"(torch.cuda.max_memory_allocated), kernel 11's patch partials "
            f"{rf.partial_shape(cfg, cfg.flat_capacity)} = "
            f"{partial / 2**30:.3f} GiB, {partial / peak:.3f} of it [{smi}]")


def large_fit(dev, smi: str, label: str, size, n: int, iters: int,
              init_scale, band: int) -> tuple:
    """One large single-image fit through train.loop.fit(use_fused=True) on
    a synthetic target: the tuned statics and the tuner's seconds,
    ``_needs_split``, the fit logged at every step (with scan_chunk 5, which
    a split cfg ignores with gs2d_tpu's message), its peak memory, the
    binning's own peak, kernels 10 and 11 against their plain
    versions on the top ``band`` tile rows' splats, and a device profile
    of 3 steps. Gates: no dropped pair, finite parameters, the MSE falls,
    one launch of kernels 10 and 11 a step. Returns (launches, numbers)."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import synthetic_target
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.ops import tiles_flat as tlf
    from gs2d_tpu_torch.params import FIELDS
    from gs2d_tpu_torch.train import loop

    t_phase = time.perf_counter()
    h, w = size
    log(f"[large] {label}: {w}x{h}, {n} splats, init sigma "
        f"{init_scale[0]}-{init_scale[1]}, flat, {iters} iterations through "
        "train.loop.fit(use_fused=True)")
    ref = synthetic_target(h, w)
    cfg = SplatConfig(width=w, height=h, n_splats=n, binning="flat",
                      init_scale_min=init_scale[0],
                      init_scale_max=init_scale[1])
    state = loop.init_train_state(cfg, dev)
    cfg = tl.tune_tile_height(cfg, state.params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg = rf.tune_flat_config(state.params, cfg)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    split = loop._needs_split(cfg)
    log(f"  tune_flat_config {tune_s:.3f}s [{smi}]: flat_capacity "
        f"{cfg.flat_capacity} rows, flat_max_chunks {cfg.flat_max_chunks}, "
        f"tile {cfg.tile_h}x{cfg.tile_w} ({cfg.n_tiles_y}x{cfg.n_tiles_x}); "
        f"_needs_split {split} (SPLIT_STEP_ROWS {loop.SPLIT_STEP_ROWS})")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    lines = []
    t0 = time.perf_counter()
    end, hist = loop.fit(ref, cfg, iters, dev, state=state, log_every=1,
                         log_fn=lines.append, scan_chunk=5 if split else 0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts()
    expect_launches(f"{label} fit", launches,
                    {"fwd_flat": iters, "fwd_flat_mask": iters,
                     "bwd_flat": iters, "expand_flat": iters})
    ignored = [x for x in lines if x.startswith("scan_chunk ignored")]
    if split != bool(ignored) or (ignored and lines[0] != (
            "scan_chunk ignored: flat capacity exceeds the single-program "
            "memory budget (split steps)")):
        raise AssertionError(f"{label}: split {split}, messages {lines[:2]}")
    if split:
        log(f"  above the split threshold, eager steps: {lines[0]!r}")
    mse = [r["mse"] for r in hist]
    drops = sum(r["n_dropped"] for r in hist)
    require_finite(f"{label} fit", **{f: getattr(end.params, f)
                                      for f in FIELDS})
    t = [r["elapsed_s"] for r in hist]
    step_ms = 1e3 * float(np.median(np.diff(t)[-5:]))
    log(f"  {fit_s:.2f}s for {iters} steps; MSE-255 @ 1 / {iters}: "
        f"{mse[0]:.4f} / {mse[-1]:.4f}; pairs dropped {drops}; parameters "
        f"finite; step {step_ms:.3f} ms (median of the last 5, a sync a "
        f"step) [{smi}]")
    log(memory_line("the fit", peak, cfg, smi))
    if drops or not mse[-1] < mse[0]:
        raise AssertionError(f"{label}: {drops} pairs dropped, or the MSE "
                             "did not fall")
    refp = rd.pad_ref_chw(ref, cfg, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    m_cap, kc, max_chunks = rf._statics(cfg)
    binning = tlf.bin_splats_flat(end.params, cfg, m_cap, kc=kc,
                                  max_chunks=max_chunks)
    torch.cuda.synchronize()
    bin_peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    log(f"  the binning alone above what it starts from: peak "
        f"{bin_peak / 2**30:.3f} GiB, its outputs {held / 2**30:.3f} GiB "
        f"[{smi}]")
    del binning
    torch.cuda.empty_cache()
    cut, cfg_cut = top_band_cut(state.params, cfg, band)
    errs, times = compare_flat_case(
        f"the top {band} tile row(s) of the {label} init ({cut.n} splats)",
        cut, ref[: cfg_cut.height], cfg_cut, dev, timed=True)
    log_times(times, f"on the {label} cut", smi)
    log(f"[profile] the {label} train step, 3 steps")
    text, prof = step_profile(loop.make_train_step_fused(cfg), end, refp,
                              step_ms, steps=3)
    log(text)
    log(f"  the {label} phase took {time.perf_counter() - t_phase:.1f}s")
    return launches, {"errs": errs, "step_ms": step_ms, "peak": peak,
                      "prof": prof, "tune_s": tune_s, "split": split}


def split_equals_unsplit(dev) -> None:
    """At the 10k config, with SPLIT_STEP_ROWS at 0 for one step, the step
    built above the split threshold equals the fused step bit for bit
    (every leaf, the MSE, the drops and the signal)."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.train import loop

    full = load_image(FULL)
    cfg = SplatConfig(width=full.shape[1], height=full.shape[0],
                      n_splats=N_10K, binning="flat")
    state = loop.init_train_state(cfg, dev)
    cfg = rf.tune_flat_config(state.params, tl.tune_tile_height(
        cfg, state.params))
    ref = rd.pad_ref_chw(full, cfg, dev)
    saved = loop.SPLIT_STEP_ROWS
    loop.SPLIT_STEP_ROWS = 0
    try:
        if not loop._needs_split(cfg):
            raise AssertionError("SPLIT_STEP_ROWS 0: the cfg is not split")
        step = loop.make_train_step_fused(cfg, True)
    finally:
        loop.SPLIT_STEP_ROWS = saved
    (s_a, a), (s_b, b) = step(state, ref), loop._fused_step_body(
        cfg, True)(state, ref)
    same = all(torch.equal(x, y) for x, y in zip(
        loop.state_leaves(s_a), loop.state_leaves(s_b))) and all(
        torch.equal(getattr(a, f), getattr(b, f))
        for f in ("mse", "n_dropped", "pos_grad_mag"))
    log(f"[large] the 10k step with SPLIT_STEP_ROWS 0 (above the split "
        f"threshold) equals the fused step bit for bit: {same}")
    if not same:
        raise AssertionError("the step above the split threshold differs "
                             "from the fused step")


def configs4_phase(dev, smi: str) -> tuple:
    """BASELINE.json configs[4] assembled: fit_adaptive_batched on two
    synthetic 4K targets, 2 Mi splats each, init sigma 1-2, 3 windows of 5
    plus a final 5 (scripts/batched_densify_at_scale.py's defaults),
    --scan-chunk's default 50. Gates: finite, no pair dropped without a
    report, each image's MSE falls; the live counts, the peak memory and
    the seconds a batched iteration logged. Returns (launches, numbers)."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import synthetic_target
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import FIELDS
    from gs2d_tpu_torch.parallel.sharded import init_batched_state
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.train.densify import fit_adaptive_batched
    from gs2d_tpu_torch.train.loop import _needs_split, state_index

    t_phase = time.perf_counter()
    h, w = UHD
    log(f"[configs4] fit_adaptive_batched: 2 synthetic {w}x{h} targets, "
        f"{N_2M} splats each, init sigma 1-2, flat, densify every 5, 20 "
        "iterations, blocks of 50")
    refs = [synthetic_target(h, w, seed=s) for s in (0, 1)]
    cfg = SplatConfig(width=w, height=h, n_splats=N_2M, binning="flat",
                      init_scale_min=1.0, init_scale_max=2.0)
    state = init_batched_state(cfg, 2, dev)
    # The images share one init, so each image's tuned statics are the
    # batch's (fit_adaptive_batched's max over images).
    init = state_index(state, 0).params
    cfg = rf.tune_flat_config(init, tl.tune_tile_height(cfg, init))
    log(f"  flat_capacity {cfg.flat_capacity} rows an image, tile "
        f"{cfg.tile_h}x{cfg.tile_w}; _needs_split {_needs_split(cfg)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    lines = []
    t0 = time.perf_counter()
    end, hist, _ = fit_adaptive_batched(refs, cfg, 20, 5, dev, state=state,
                                        log_every=1, log_fn=lines.append)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts()
    steps = [r for r in hist if "iter" in r]
    events = [r for r in hist if "event" in r]
    # Record times are block ends: the last window's 5 iterations and the
    # densify before them.
    at = {r["iter"]: r["elapsed_s"] for r in steps}
    per_it = 1e3 * (at[19] - at[14]) / 5
    require_finite("configs[4] fit", **{f: getattr(end.params, f)
                                        for f in FIELDS})
    warned = [x for x in lines if "capacity overflow" in x]
    drops = sum(e.get("window_drops", 0) for e in events)
    live = [e["n_live"] for e in events if e["event"] == "densify"]
    captures = [x for x in lines if x.startswith("captured")]
    log(f"  {total_s:.2f}s for 20 batched iterations with tuning and "
        f"captures ({len(captures)}: {captures}); a batched iteration "
        f"{per_it:.2f} ms (2 images; the last window, with the densify "
        f"before it) [{smi}]")
    log(f"  MSE-255 @ 1: {steps[0]['mse']}; @ 20: {steps[-1]['mse']}; live "
        f"after each densify {live}; pairs dropped {drops}, overflow "
        f"warnings {len(warned)}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    log(memory_line("the batched fit", peak, cfg, smi))
    if (drops and not warned) or not all(
            steps[-1]["mse"][i] < steps[0]["mse"][i] for i in range(2)):
        raise AssertionError("configs[4]: an unreported drop, or an MSE "
                             "that did not fall")
    log(f"  the configs[4] phase took {time.perf_counter() - t_phase:.1f}s")
    return launches, {"per_it_ms": per_it, "peak": peak}


def large_phase(dev, smi: str) -> dict:
    """The large flat configurations: 1080p/1M at gs2d_tpu's default init
    (sigma 6-10), 20 iterations, and 4K/4M at init sigma 1-2 (scripts/
    densify_at_scale.py's config), 10 iterations (large_fit); the step
    above the split threshold against the fused one at 10k; the assembled
    configs[4]
    (configs4_phase). Returns the summed launch counts."""
    total = {}

    def count(launches):
        for kk, v in launches.items():
            total[kk] = total.get(kk, 0) + v

    split_equals_unsplit(dev)
    count(large_fit(dev, smi, "1080p/1M", FHD, N_1M, 20, (6.0, 10.0), 1)[0])
    launches, uhd = large_fit(dev, smi, "4K/4M", UHD, N_4M, 10, (1.0, 2.0),
                              1)
    count(launches)
    if not uhd["split"]:
        raise AssertionError("4K/4M: the fit is not above the split "
                             "threshold")
    count(configs4_phase(dev, smi)[0])
    return total


def backward_dump(dev, out: str, other=None) -> int:
    """Kernel 3 and kernels 8/9 (on the table rows kernel 3's ids name) of
    the package beside this script, on every population of backward_cases
    under the same planes: logs whether the two give the same moments bit
    for bit and saves both to ``out`` (torch.save). With ``other``, a dump
    made by another checkout's kernels (this script copied into it, e.g.
    the parent's), holds both to it bit for bit. Runs no plain version and
    no fit. Returns 0 when everything compared is equal, else 1."""
    from gs2d_tpu_torch.ops import render_dense as rdn
    from gs2d_tpu_torch.ops import render_resident as rr

    log("[dump] kernels 3 and 8/9 on kernel 3's compare populations")
    dump, ok = {}, True
    for name, (p, ref, cfg, inputs, forced, _) in backward_cases(dev).items():
        with walk_forced(forced):
            table, ids, count, planes = backward_inputs(p, ref, cfg, dev,
                                                        **inputs)
            m3 = rr._bwd_resident_cuda(table, ids, count, *planes, p.n,
                                       cfg)[:9, : p.n]
            g89 = rdn._bwd_dense_cuda(gathered_rows(table, ids), ids, count,
                                      *planes, p.n, cfg)[-1]
            torch.cuda.synchronize()
        dump[name] = (m3.cpu(), g89.cpu())
        same = same_bits(m3, g89)
        ok &= same
        log(f"  {name}: kernel 3 equals kernels 8/9 bit for bit: {same} "
            f"(NaN in {int(torch.isnan(m3).sum())} of {m3.numel()} "
            "moments)")
    torch.save(dump, out)
    if other is not None:
        theirs = torch.load(other)
        for name, (m3, g89) in dump.items():
            same = (same_bits(m3, theirs[name][0]),
                    same_bits(g89, theirs[name][1]))
            ok &= all(same)
            log(f"  {name}: against {os.path.basename(other)}, kernel 3 "
                f"equal bit for bit: {same[0]}, kernels 8/9: {same[1]}")
    return 0 if ok else 1


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
    # The flat binning's pair expansion: jnp code in gs2d_tpu, no Pallas
    # kernel (the count and emission kernels; launches are emissions).
    ("expand_flat", "gs2d_tpu_torch/csrc/tiles_flat.cu",
     "gs2d_tpu/ops/tiles_flat.py:166"),
    ("bwd_flat", "gs2d_tpu_torch/csrc/render_flat.cu",
     "gs2d_tpu/ops/render_pallas_flat.py:265"),
    ("l2_window", "gs2d_tpu_torch/csrc/render_resident.cu",
     "gs2d_tpu/ops/render_pallas_window.py:112"),
    ("l2_mxu", "gs2d_tpu_torch/csrc/render_mxu.cu",
     "gs2d_tpu/ops/render_pallas_mxu.py:159"),
    ("fma_peak", "gs2d_tpu_torch/csrc/probes.cu", "scripts/roofline.py:95"),
    ("moments_cuda_cores", "gs2d_tpu_torch/csrc/probes.cu",
     "scripts/probe_mxu_moments.py:47"),
    ("moments_tensor_cores", "gs2d_tpu_torch/csrc/probes.cu",
     "scripts/probe_mxu_moments.py:76"),
    ("moments_scratch_contraction", "gs2d_tpu_torch/csrc/probes.cu",
     "scripts/probe_mxu_moments.py:111"),
)
# The references: the designs kernels 6/7, 8/9 and 13 had before their
# warp patches and the lane tree of probe 15a, kept unchanged to hold them
# bit for bit, and the designs the probes 15b and 15c had before wgmma,
# held within PROBE_TC_RTOL. They port
# no TPU kernel and no path launches them: (counter, source, the kernel held
# to it, the key of its time).
REFERENCES = (
    ("fwd_chunk", "gs2d_tpu_torch/csrc/render_dense.cu", "fwd_dense",
     FWD_CHUNK_TIMES),
    ("bwd_chunk", "gs2d_tpu_torch/csrc/render_dense.cu", "bwd_dense",
     BWD_CHUNK_TIMES),
    ("l2_mxu_chunk", "gs2d_tpu_torch/csrc/render_mxu.cu", "l2_mxu",
     MXU_CHUNK_TIMES),
    ("moments_cuda_cores_tree", "gs2d_tpu_torch/csrc/probes.cu",
     "moments_cuda_cores", PROBE_REF_TIMES["moments_cuda_cores_tree"]),
    ("moments_tensor_cores_staged", "gs2d_tpu_torch/csrc/probes.cu",
     "moments_tensor_cores",
     PROBE_REF_TIMES["moments_tensor_cores_staged"]),
    ("moments_scratch_contraction_sync", "gs2d_tpu_torch/csrc/probes.cu",
     "moments_scratch_contraction",
     PROBE_REF_TIMES["moments_scratch_contraction_sync"]),
)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        return 1
    if argv[:1] == ["--cluster-rank"] and len(argv) == 7:
        return cluster_rank(argv[1:])  # one rank of mesh_cluster's
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_image
    from gs2d_tpu_torch.ops import _build
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
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    if argv == ["--profiles"]:
        # The step profiles alone, each against 50 unprofiled steps of its
        # own step function: run from another checkout of the port, this
        # measures that tree's kernels on the same steps.
        cells = fused_cells(dev)
        for label in cells:
            profile_cell(cells, label)
        return 0
    if argv[:1] == ["--backward-dump"] and len(argv) in (2, 3):
        return backward_dump(dev, *argv[1:])
    if argv == ["--mesh"]:
        mesh_phase(dev, smi)  # the mesh phase alone
        return 0
    if argv == ["--expand"]:
        expand_phase(dev, smi)  # the expansion's phase alone
        return 0
    if argv == ["--tail"]:
        tail_phase(dev, smi)  # kernel 10's tail alone
        return 0
    if argv == ["--mesh-cluster"]:
        # The NCCL clusters alone (several cards), against the world of one.
        log("[mesh] the default fit with --mesh 1,1,1, 20 iterations")
        _, mse = logged_fit([MINI, "--splats", "1024", "--iters", "20",
                             "--device", "cuda", "--mesh", "1,1,1"],
                            iters=20)
        mesh_cluster(dev, smi, {k: v[0] for k, v in mse.items()})
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

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
                            dev, timed=True, repeat_plain=True)
    errs = {kk: max(errs[kk], e[kk]) for kk in errs}
    log_times(times, f"at the default fit's init (K="
              f"{cfg_main.max_splats_per_tile})", smi)
    compare_nan_case(dev)

    new_errs, new_times = compare_new(dev, smi)
    flat_errs, flat_times = compare_flat(dev, smi)
    # Integer-equal to the plain expansion, or expand_phase raises.
    errs["expand_flat"], times["expand_flat"] = 0.0, expand_phase(dev, smi)
    tail_phase(dev, smi)
    compare_dense_10k(dev, smi)
    errs.update(new_errs)
    errs.update(flat_errs)
    times.update(new_times)
    times.update(flat_times)
    e64, _ = compare_resident64(dev, smi)
    for kk, v in e64.items():
        errs[kk] = max(errs[kk], v)
    errs["l2_window"], window_times, _ = compare_window(dev, smi)
    errs["l2_mxu"], mxu_times, mxu_inputs = compare_mxu(dev, smi)
    times["l2_window"] = window_times["l2_window"]
    times.update(mxu_times)
    probe_errs, probe_times = compare_probes(dev, smi)
    errs.update(probe_errs)
    times.update(probe_times)
    from gs2d_tpu_torch.ops import probes
    log(f"  fma_peak compiled code (cuobjdump -sass), per chain count: "
        f"{probes.fma_sass_counts()}")
    sass = probes.moments_sass_counts()
    log(f"  moments_cuda_cores (butterfly, G = {probes.MOMENT_STEP_BATCH}) "
        f"and moments_cuda_cores_tree compiled code (cuobjdump -sass; "
        f"static counts, step bodies = FMUL / {probes.MOMENT_STEP_FMUL}): "
        f"{sass}")
    if sass["moments_cuda_cores"]["shfl_per_step"] > 12:
        raise AssertionError("15a's butterfly issues more than 12 shuffles "
                             "a step")

    compare_counts = read_counts()

    # ---- main paths: the CLI's fits -----------------------------------------
    total = {}

    def count(launches):
        for kk, v in launches.items():
            total[kk] = total.get(kk, 0) + v

    # The eager fits' MSEs and step numbers, for their scanned twins.
    eager_mse, eager = {}, {}
    launches, mse_l2, rates = fit_phase(MINI, 1024, smi, runs=2)
    expect_launches("resident L2 fit", launches,
                    {"l2_resident": 200, "fwd_resident": 1})
    count(launches)
    check_trajectory(mse_l2, {it: (want, TRAJECTORY_RTOL)
                              for it, want in TRAJECTORY.items()})
    check_trajectory(mse_l2, TRAJECTORY_JAX)
    cells = fused_cells(dev)
    eager_mse["default"] = mse_l2
    eager["default"] = {**profile_cell(cells, "resident L2 train step",
                                       median_ms(rates)), "rates": rates}

    dense = ["--binning", "dense"]
    launches, mse, rates = fit_phase(FULL, N_10K, smi, runs=2)
    expect_launches("flat L2 fit", launches,
                    {"fwd_flat": 201, "fwd_flat_mask": 201, "bwd_flat": 200,
                     "expand_flat": 201})
    count(launches)
    check_trajectory(mse, TRAJECTORY_10K)
    log(f"  MSE-255 @ 200: {mse[199]:.4f} (no gate)")
    eager_mse["10k"] = mse
    eager["10k"] = {**profile_cell(cells, "flat L2 train step",
                                   median_ms(rates)), "rates": rates}
    launches, mse_dense, rates = fit_phase(FULL, N_10K, smi, dense, runs=1)
    expect_launches("10k dense L2 fit", launches,
                    {"l2_dense": 200, "fwd_dense": 1})
    count(launches)
    # Kernels 4/5 and kernels 10 and 11 walk the same pairs in the same
    # order and sum them in the chunk walk's order, so the two fits agree
    # over 200 steps.
    if not same_trajectory(mse_dense, mse):
        raise AssertionError("the 10k dense L2 fit differs from the flat one")
    log("  equals the flat L2 trajectory bit for bit (200 of 200 MSEs)")
    profile_cell(cells, "dense L2 train step, 10k fit", median_ms(rates))

    ssim = ["--ssim", SSIM]
    launches, mse_ssim, rates = fit_phase(MINI, 1024, smi, ssim, runs=2)
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
    eager_mse["ssim"] = mse_ssim
    eager["ssim"] = {**profile_cell(cells,
                                    "modular SSIM train step (resident)",
                                    median_ms(rates)), "rates": rates}

    launches, mse, rates = fit_phase(MINI, 1024, smi, dense, runs=2)
    expect_launches("dense L2 fit", launches,
                    {"l2_dense": 200, "fwd_dense": 1})
    count(launches)
    check_trajectory(mse, {it: (want, TRAJECTORY_RTOL)
                           for it, want in TRAJECTORY.items()})
    # Kernels 4/5 and kernel 1 run one patch walk over the same pairs, read
    # from the tile_params or through the ids, and the same sums.
    if not same_trajectory(mse, mse_l2):
        raise AssertionError("the dense L2 fit differs from the resident one")
    log("  equals the resident L2 trajectory bit for bit (200 of 200 MSEs)")
    eager_mse["dense"] = mse
    eager["dense"] = {**profile_cell(cells, "dense L2 train step, default "
                                     "fit", median_ms(rates)),
                      "rates": rates}

    launches, mse, rates = fit_phase(MINI, 1024, smi, dense + ssim,
                                     runs=2)
    expect_launches("dense SSIM fit", launches,
                    {"fwd_dense": 201, "bwd_dense": 200})
    count(launches)
    check_trajectory(mse, TRAJECTORY_SSIM)
    # Kernels 8/9 and kernel 3 run one replay over the same pairs, read from
    # the tile_params or through the ids, and the same sums.
    if not same_trajectory(mse, mse_ssim):
        raise AssertionError("the dense SSIM fit differs from the resident "
                             "one")
    log("  equals the resident SSIM trajectory bit for bit (200 of 200 "
        "MSEs)")
    profile_cell(cells, "modular SSIM train step (dense)", median_ms(rates))

    launches, mse, _ = fit_phase(FULL, N_10K, smi, ssim, runs=2)
    expect_launches("flat SSIM fit", launches,
                    {"fwd_flat": 201, "fwd_flat_mask": 201, "bwd_flat": 200,
                     "expand_flat": 201})
    count(launches)
    check_trajectory(mse, TRAJECTORY_SSIM_10K)
    log(f"  MSE-255 @ 200: {mse[199]:.4f} (no gate)")

    *window_launches, rates, eager_mse["window"] = window_fit_phase(dev, smi)
    for launches in window_launches:
        count(launches)
    eager["window"] = {**profile_cell(cells, "window L2 train step",
                                      median_ms(rates)), "rates": rates}

    log("[fit] the default fit on 64-row tiles, logged")
    launches, mse = logged_fit([MINI, "--splats", "1024", "--iters", "200",
                                "--device", "cuda", "--tile-h", "64"])
    expect_launches("64-row resident L2 fit", launches,
                    {"l2_resident": 200, "fwd_resident": 1})
    count(launches)
    check_trajectory(mse, {it: (mse_l2[it], TILE64_RTOL) for it in (0, 1)})
    for it in (49, 199):
        log(f"  MSE-255 @ {it + 1}: {mse[it]:.4f} (32-row fit "
            f"{mse_l2[it]:.4f}; no gate)")

    count(mxu_entry_phase(mxu_inputs))
    count(probe_phase())
    launches, pair_1080p = fit_1080p_phase(dev, smi)
    count(launches)
    count(resume_phase())
    count(scan_phase(dev, smi, eager_mse, eager, pair_1080p))
    count(adaptive_phase(dev, smi, eager_mse["ssim"]))
    count(batched_phase(dev, smi, mse_l2))
    count(mesh_phase(dev, smi))
    count(large_phase(dev, smi))
    count(recovery_phase(dev))
    for kk, _, _, _ in REFERENCES:
        if total.get(kk):
            raise AssertionError(f"a path launched the reference {kk}")
    log(f"  the references (gs2d_fwd_chunk, gs2d_bwd_chunk, "
        f"gs2d_l2_mxu_chunk, gs2d_moments_cuda_cores_tree, "
        f"gs2d_moments_tensor_cores_staged, "
        f"gs2d_moments_scratch_contraction_sync; no port of a TPU kernel): "
        f"{ {kk: compare_counts[kk] for kk, _, _, _ in REFERENCES} } "
        f"launches in the compare phases, 0 on every path")
    log("[done] every phase passed")

    for kk, _, _ in KERNELS:
        if not total.get(kk):
            raise AssertionError(f"{kk}: no launch on any path")
    def entry(kk, src, rep, t, err):
        return {"name": kk, "route": "cuda", "source": src, "replaces": rep,
                "launches": total.get(kk, 0), "max_abs_err": err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None}

    # The references' max_abs_err is their largest difference from the
    # kernel held to them (0 for the chunk references: bit for bit), their
    # plain_ms that kernel's plain version's.
    report = {"kernels": [entry(kk, src, rep, times[kk], errs[kk])
                          for kk, src, rep in KERNELS],
              "references": [
                  {**entry(kk, src, None, times[key], REF_ERRS[kk]),
                   "reference_of": of}
                  for kk, src, of, key in REFERENCES]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
