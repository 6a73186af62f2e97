"""Adaptive density control (the counterpart of ``gs2d_tpu/train/densify.py``,
single-image): prune, clone/split, the periodic opacity reset, and
``fit_adaptive``, the fit that densifies between windows of steps.

- **Static capacity**: the population lives in fixed (N, ...) tensors. Dead
  slots are parked off-screen (pos x = DEAD_POS) with opacity 0, which the
  binning excludes (their bounding box is off-screen), and the optimizer
  keeps them dead (``params.freeze_dead_slots``).
- **Prune**: kill live splats whose opacity fell to the clamp floor (with
  ``cfg.optimize_opacity``) or whose sigmas both collapsed to the floor.
- **Clone/split**: the freed slots, dead ones first, are filled from the
  live splats of the largest accumulated |dL/d pos| (the 3DGS view-space
  gradient signal), at most ``max_fraction`` of N a call: small donors are
  cloned with a jittered position, large ones split (child and donor scaled
  by ``split_scale_factor``).

Every decision is a stable sort, a gather or a scatter over permutations,
so the decisions are integer-equal to gs2d_tpu's and the new state is
bitwise its on the same inputs, on the CPU and on the card alike
(``tests/test_torch_densify.py``). ``densify_and_prune_batched`` and
``fit_adaptive_batched`` do the same for several images, each with its own
population (``tests/test_torch_batched.py``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_flat as rf
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.ops.numerics import pcg3d_unit
from gs2d_tpu_torch.params import DEAD_POS, FIELDS, GaussianParams
from gs2d_tpu_torch.train.adam import AdamState
from gs2d_tpu_torch.train.loop import (STEP_FIELDS, TrainState, _needs_split,
                                       grad_mag, init_batched_state,
                                       init_train_state,
                                       make_fit_scan_batched,
                                       make_fit_scan_fused,
                                       make_train_step_fused, run_batched,
                                       stack_states, state_index)


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    prune_opacity: float = 0.105     # at/near the 0.1 clamp floor
    prune_min_scale: float = 1.01    # both sigmas pinned at the 1.0 floor
    split_scale_threshold: float = 24.0  # sigma above which split, not clone
    clone_pos_jitter: float = 1.0    # pixels
    split_scale_factor: float = 0.6  # 3DGS uses /1.6
    max_fraction: float = 0.25       # densify at most this fraction per call


def _f32(x: float) -> float:
    """``x`` rounded to float32, as gs2d_tpu's weakly typed constants are."""
    return float(np.float32(x))


def live_mask(params: GaussianParams) -> torch.Tensor:
    return params.pos[:, 0] > DEAD_POS * 0.5


def n_live(params: GaussianParams) -> torch.Tensor:
    return live_mask(params).sum(dtype=torch.int32)


def densify_and_prune(state: TrainState, pos_grad_mag: torch.Tensor,
                      cfg: SplatConfig, dcfg: DensifyConfig = DensifyConfig(),
                      seed: int = 0) -> TrainState:
    """One density-control step (gs2d_tpu/train/densify.py:54-155).

    ``pos_grad_mag`` (N,) is the accumulated |dL/d pos| of the window. Pair
    i (i < budget = min(free slots, int(N * max_fraction))) moves the i-th
    best live donor (stable descending sort; dead splats score -inf) into
    the i-th free slot (dead first, in index order), where the donor's
    score is > 0. Killed slots are reset to DEAD_POS, scale 1 and zeros;
    Adam's m and v are zeroed on every touched slot, the bias powers and
    the step count are kept."""
    p = state.params
    n = p.n
    dev = p.device
    alive = live_mask(p)
    # --- prune ------------------------------------------------------------
    degenerate = (p.sx <= _f32(dcfg.prune_min_scale)) \
        & (p.sy <= _f32(dcfg.prune_min_scale))
    transparent = p.opacity <= _f32(dcfg.prune_opacity)
    if not cfg.optimize_opacity:
        transparent = torch.zeros_like(transparent)  # opacity frozen: keep
    kill = alive & (transparent | degenerate)
    alive = alive & ~kill

    # --- choose donors ----------------------------------------------------
    score = torch.where(alive, pos_grad_mag,
                        torch.full_like(pos_grad_mag, -float("inf")))
    donor = torch.argsort(-score, stable=True)      # donors: best first
    target = torch.argsort(alive.to(torch.int32), stable=True)  # dead first
    n_free = n - alive.sum(dtype=torch.int32)
    budget = torch.clamp(n_free, max=int(n * dcfg.max_fraction))
    slot_idx = torch.arange(n, dtype=torch.int64, device=dev)
    act = (slot_idx < budget) & (score[donor] > 0.0)

    # --- build children ---------------------------------------------------
    r = pcg3d_unit(torch.stack([
        slot_idx, torch.full_like(slot_idx, seed & 0xFFFFFFFF),
        torch.full_like(slot_idx, 0x9E3779B9)], dim=-1))
    jitter = (r[:, :2] - 0.5) * (2.0 * dcfg.clone_pos_jitter)
    d_sx, d_sy = p.sx[donor], p.sy[donor]
    big = torch.maximum(d_sx, d_sy) > _f32(dcfg.split_scale_threshold)
    one = torch.ones((n,), dtype=torch.float32, device=dev)
    shrink = torch.full_like(one, _f32(dcfg.split_scale_factor))
    scale_f = torch.where(big, shrink, one)
    moved = p.pos[donor] + jitter
    scale_min = torch.full_like(one, _f32(cfg.scale_min))
    child = GaussianParams(
        pos=torch.stack([moved[:, 0].clamp(0.0, float(cfg.width - 1)),
                         moved[:, 1].clamp(0.0, float(cfg.height - 1))], -1),
        sx=torch.maximum(d_sx * scale_f, scale_min),
        sy=torch.maximum(d_sy * scale_f, scale_min),
        rot=p.rot[donor], color=p.color[donor], opacity=p.opacity[donor])
    # A split also shrinks the donor in place. ``donor`` is a permutation,
    # so gs2d_tpu's ``ones.at[donor].min(f)`` (f <= 1) is this copy.
    donor_scale = one.index_copy(0, donor, torch.where(act & big, shrink, one))

    # --- scatter children into their slots --------------------------------
    def bc(mask, arr):
        return mask.reshape(mask.shape + (1,) * (arr.ndim - 1))

    def place(dst, src_rows, reset_dead):
        out = torch.where(bc(kill, dst), reset_dead, dst)
        upd = torch.where(bc(act, src_rows), src_rows, out[target])
        return out.index_copy(0, target, upd)

    new_params = GaussianParams(
        pos=place(p.pos, child.pos, torch.full_like(p.pos, DEAD_POS)),
        sx=place(p.sx * donor_scale, child.sx, torch.ones_like(p.sx)),
        sy=place(p.sy * donor_scale, child.sy, torch.ones_like(p.sy)),
        rot=place(p.rot, child.rot, torch.zeros_like(p.rot)),
        color=place(p.color, child.color, torch.zeros_like(p.color)),
        opacity=place(p.opacity, child.opacity,
                      torch.zeros_like(p.opacity)),
    )

    # --- reset Adam moments of touched slots ------------------------------
    touched = torch.zeros((n,), dtype=torch.bool, device=dev).index_copy(
        0, target, act) | kill

    def reset(m: GaussianParams) -> GaussianParams:
        return m.map(lambda x: torch.where(bc(touched, x),
                                           torch.zeros_like(x), x))

    opt = state.opt
    return TrainState(params=new_params, opt=AdamState(
        m=reset(opt.m), v=reset(opt.v), beta1t=opt.beta1t,
        beta2t=opt.beta2t, step=opt.step))


def densify_and_prune_batched(state: TrainState, pos_grad_mag: torch.Tensor,
                              cfg: SplatConfig,
                              dcfg: DensifyConfig = DensifyConfig(),
                              seed: int = 0) -> TrainState:
    """``densify_and_prune`` on every image of a batched (B, N, ...) state
    with its row of the (B, N) signal and the same ``seed`` for every
    image, as gs2d_tpu's ``vmap`` gives (densify.py:158-166)."""
    return stack_states([
        densify_and_prune(state_index(state, i), pos_grad_mag[i], cfg, dcfg,
                          seed) for i in range(pos_grad_mag.shape[0])])


def opacity_reset(state: TrainState, cfg: SplatConfig,
                  value: float = 0.3) -> TrainState:
    """Periodic opacity reset (the 3DGS floater-control schedule): caps
    every opacity at ``value`` (lower-only, so dead slots stay at 0) and
    zeroes the opacity Adam moments. Only meaningful with
    cfg.optimize_opacity (gs2d_tpu/train/densify.py:283-300)."""
    p = state.params
    params = p.replace(opacity=torch.minimum(
        p.opacity, torch.full_like(p.opacity, _f32(value))))
    opt = state.opt
    return TrainState(params=params, opt=dataclasses.replace(
        opt, m=opt.m.replace(opacity=torch.zeros_like(opt.m.opacity)),
        v=opt.v.replace(opacity=torch.zeros_like(opt.v.opacity))))


def l2_grad_mag(params: GaussianParams, ref: torch.Tensor,
                cfg: SplatConfig) -> torch.Tensor:
    """(N,) |dL/d pos| of the reference's L2 objective 0.5 * sum((C -
    ref)^2) at ``params`` against the (H, W, 3) target ``ref``, through
    ``production_render`` (the layout's forward kernel and its analytic
    backward): the signal of the CLI's modular densify route. gs2d_tpu
    takes it from its scan renderer's gradient, which the port does not
    have; the two differ only at the anisotropy tolerance (~1e-3)."""
    leaves = {f: getattr(params, f).detach() for f in FIELDS}
    leaves["pos"] = leaves["pos"].requires_grad_()
    color, _ = rf.production_render(GaussianParams(**leaves), cfg)
    d = color - ref
    (g_pos,) = torch.autograd.grad(0.5 * torch.sum(d * d), [leaves["pos"]])
    return grad_mag(g_pos)


def _retune(params: GaussianParams, cfg: SplatConfig) -> SplatConfig:
    """(Re-)derive the binning capacity statics from the population."""
    if rf.use_flat(cfg):
        return rf.tune_flat_config(params, cfg)
    return tl.tune_tile_capacity(params, cfg)


def _retune_batched(params: GaussianParams, cfg: SplatConfig) -> SplatConfig:
    """Statics shared by a batch: each image's tuned, the max over images
    (gs2d_tpu's ``retune`` in fit_adaptive_batched, densify.py:211-227)."""
    tuned = [_retune(GaussianParams(**{f: getattr(params, f)[i]
                                       for f in FIELDS}), cfg)
             for i in range(params.pos.shape[0])]
    keep = ("flat_capacity", "flat_max_chunks") if rf.use_flat(cfg) \
        else ("max_splats_per_tile",)
    return cfg.replace(**{f: max(getattr(t, f) for t in tuned)
                          for f in keep + ("max_tiles_per_splat",)})


def fit_adaptive(
    ref,
    cfg: SplatConfig,
    iterations: int,
    densify_every: int,
    device,
    state: TrainState | None = None,
    dcfg: DensifyConfig = DensifyConfig(),
    scan_chunk: int = 0,
    log_every: int = 0,
    log_fn=print,
    reorder_every: int = 0,
    opacity_reset_every: int = 0,
    opacity_reset_value: float = 0.3,
    iter_offset: int = 0,
):
    """Adaptive-density fitting on the fused L2 step (gs2d_tpu's
    ``fit_adaptive``, densify.py:303-417).

    The train step sums |dL/d pos| over each window of ``densify_every``
    steps on the device (``with_grad_mag``: eagerly into one (N,) tensor,
    or, with ``scan_chunk`` > 1, inside the captured step's accumulator,
    which carries from block to block of a window, so the scanned fit
    equals the eager one bit for bit; as in ``fit``, ``scan_chunk`` is
    ignored, with its message, for flat capacities above SPLIT_STEP_ROWS,
    so nothing of that size is captured). Between windows, on the same
    tensors: ``densify_and_prune`` (seed: the steps done in this call), the
    opacity reset when the window crossed a multiple of
    ``opacity_reset_every`` (with cfg.optimize_opacity), and the Morton
    reorder at multiples of ``reorder_every``. A window that dropped pairs
    to a capacity cap is reported, the final one included, and re-tunes
    the capacities before the next window; each cfg keeps one scanned
    fitter, so a fit captures its step once per cfg. Iterations are
    logged (``log_every``) and reported as ``iter_offset`` + the steps
    done. Returns (state, history): the logged steps' records (iteration,
    MSE, PSNR, n_dropped, seconds; scanned: rebinned) and one
    ``{"event": "densify", ...}`` record a densify with the live count and
    the window's dropped pairs."""
    if densify_every < 1:
        raise ValueError(f"densify_every must be >= 1 (got {densify_every})")
    from gs2d_tpu_torch.train.reorder import reorder_state

    device = torch.device(device)
    if state is None:
        state = init_train_state(cfg, device)
    if (rf.use_flat(cfg) and cfg.flat_capacity is None) or (
            not rf.use_flat(cfg) and cfg.max_splats_per_tile is None):
        cfg = _retune(state.params, cfg)
    refp = rd.pad_ref_chw(ref, cfg, device)
    scanned = bool(scan_chunk and scan_chunk > 1)
    fitters = {}  # cfg -> its step (eager) or scanned fitter (one capture)
    history = []
    t0 = time.perf_counter()

    def log_step(it, mse, psnr, n_dropped, rebinned=None):
        if not log_every or (it % log_every and it != iterations - 1):
            return
        rec = {"iter": it + iter_offset, "mse": float(mse),
               "psnr": float(psnr), "n_dropped": int(n_dropped),
               "elapsed_s": time.perf_counter() - t0}
        if rebinned is not None:
            rec["rebinned"] = int(rebinned)
        history.append(rec)
        if log_fn:
            log_fn(f"{rec['iter']} itr, mse {rec['mse']:.4f}, psnr "
                   f"{rec['psnr']:.2f} dB")

    done = 0
    while done < iterations:
        window = min(densify_every, iterations - done)
        # fit's rule: a capacity above SPLIT_STEP_ROWS is never captured.
        scan = scanned and not _needs_split(cfg)
        if cfg not in fitters:
            if scanned and not scan and log_fn:
                log_fn("scan_chunk ignored: flat capacity exceeds the "
                       "single-program memory budget (split steps)")
            fitters[cfg] = make_fit_scan_fused(cfg, True) if scan \
                else make_train_step_fused(cfg, True)
        fit_k = fitters[cfg]
        drops = torch.zeros((), dtype=torch.int64, device=device)
        if scan:
            accum, w_done = None, 0
            while w_done < window:
                n = min(scan_chunk, window - w_done)
                graph = fit_k.graph
                state, auxes = fit_k(state, refp, n, grad_mag_sum=accum)
                if fit_k.graph is not graph and log_fn:
                    c = fit_k.graph.capture
                    log_fn(f"captured the train step as a CUDA graph in "
                           f"{c.capture_s:.3f}s (warm-up step "
                           f"{c.warmup_s:.3f}s)")
                accum = auxes.pos_grad_mag
                drops = drops + auxes.n_dropped.sum()
                if log_every:
                    block = {f: getattr(auxes, f).cpu() for f in STEP_FIELDS}
                    for j in range(n):
                        log_step(done + w_done + j, block["mse"][j],
                                 block["psnr"][j], block["n_dropped"][j],
                                 block["rebinned"][j])
                w_done += n
        else:
            accum = torch.zeros((cfg.n_splats,), dtype=torch.float32,
                                device=device)
            for j in range(window):
                state, aux = fit_k(state, refp)
                accum = accum + aux.pos_grad_mag
                drops = drops + aux.n_dropped
                log_step(done + j, aux.mse, aux.psnr, aux.n_dropped)
        prev = done
        done += window
        window_drops = int(drops)
        if done >= iterations:
            # gs2d_tpu reads the drops only before a densify, so an overflow
            # in the final window went unreported there.
            if window_drops > 0 and log_fn:
                log_fn(f"WARNING: binning capacity overflow: {window_drops} "
                       f"splat-tile pairs dropped in the final window, "
                       f"ending at {done + iter_offset}")
            break
        state = densify_and_prune(state, accum, cfg, dcfg, seed=done)
        # Fire when the window crossed a reset boundary, so any
        # opacity_reset_every works, not only multiples of densify_every.
        if opacity_reset_every and cfg.optimize_opacity and \
                done // opacity_reset_every > prev // opacity_reset_every:
            state = opacity_reset(state, cfg, opacity_reset_value)
        if reorder_every and done % reorder_every == 0:
            state = reorder_state(state, cfg)
        live = int(n_live(state.params))
        history.append({"event": "densify", "at": done + iter_offset,
                        "n_live": live, "window_drops": window_drops})
        if log_fn:
            log_fn(f"densify/prune at iter {done + iter_offset}: {live} of "
                   f"{cfg.n_splats} splats live")
        if window_drops > 0:
            # Densify concentrates clones and splits into the fullest tiles:
            # re-derive the capacities from the new population.
            if log_fn:
                log_fn(f"WARNING: binning capacity overflow: {window_drops} "
                       f"splat-tile pairs dropped in the window ending at "
                       f"{done + iter_offset}; re-tuning capacities")
            cfg = _retune(state.params, cfg)
            refp = rd.pad_ref_chw(ref, cfg, device)
    return state, history


def fit_adaptive_batched(
    refs,
    cfg: SplatConfig,
    iterations: int,
    densify_every: int,
    device,
    state: TrainState | None = None,
    dcfg: DensifyConfig = DensifyConfig(),
    scan_chunk: int = 50,
    log_every: int = 0,
    log_fn=print,
    opacity_reset_every: int = 0,
    opacity_reset_value: float = 0.3,
):
    """Adaptive density on several images at once (gs2d_tpu's
    ``fit_adaptive_batched``, densify.py:169-282; BASELINE.json configs[4]
    on one card): B equal-sized targets ``refs``, each with its own
    population in a batched (B, N, ...) state (``init_batched_state`` when
    None), fitted in blocks of ``scan_chunk`` steps (at least 1) by
    ``make_fit_scan_batched`` with the densify signal, which continues
    each image's sum from block to block so that every window sums in step
    order; the blocks log and check through ``loop.run_batched``. Between
    windows: ``densify_and_prune_batched`` (seed: the steps done), the
    opacity reset when the window crossed a multiple of
    ``opacity_reset_every`` (with cfg.optimize_opacity). The binning
    statics are shared, so tuning takes the max over images; a window that
    dropped pairs is reported, the final one included (gs2d_tpu skips it),
    and re-tunes before the next. Each cfg keeps one fitter, so one
    capture. ``densify_every`` < 1 is refused. Image i equals
    ``fit_adaptive`` on image i with the same statics, bit for bit.

    Returns (state, history, cfg): ``run_batched``'s records a logged
    step, a ``{"event": "densify", ...}`` record a densify (the live count
    of each image, the window's dropped pairs), one ``{"event": "end",
    ...}`` record with the final window's dropped pairs, and the cfg of
    the last window (its statics re-tuned where a window overflowed)."""
    if densify_every < 1:
        raise ValueError(f"densify_every must be >= 1 (got {densify_every})")
    device = torch.device(device)
    b = len(refs)
    if state is None:
        state = init_batched_state(cfg, b, device)
    if (rf.use_flat(cfg) and cfg.flat_capacity is None) or (
            not rf.use_flat(cfg) and cfg.max_splats_per_tile is None):
        cfg = _retune_batched(state.params, cfg)

    def pad_refs(cfg):
        return torch.stack([rd.pad_ref_chw(r, cfg, device) for r in refs])

    refsp = pad_refs(cfg)
    fitters = {}  # cfg -> its batched fitter (one capture)
    history = []
    t0 = time.perf_counter()
    done = 0
    while done < iterations:
        window = min(densify_every, iterations - done)
        if cfg not in fitters:
            fitters[cfg] = make_fit_scan_batched(cfg, True)
        state, accum, drops = run_batched(
            fitters[cfg], state, refsp, done, window, max(1, scan_chunk),
            iterations, history, t0, log_every=log_every, log_fn=log_fn)
        prev = done
        done += window
        if done >= iterations:
            history.append({"event": "end", "at": done,
                            "window_drops": drops})
            if drops > 0 and log_fn:
                log_fn(f"WARNING: binning capacity overflow: {drops} "
                       f"splat-tile pairs dropped in the final window, "
                       f"ending at {done}")
            break
        state = densify_and_prune_batched(state, accum, cfg, dcfg, seed=done)
        if opacity_reset_every and cfg.optimize_opacity and \
                done // opacity_reset_every > prev // opacity_reset_every:
            state = opacity_reset(state, cfg, opacity_reset_value)
        live = [int(n_live(state_index(state, i).params)) for i in range(b)]
        history.append({"event": "densify", "at": done, "n_live": live,
                        "window_drops": drops})
        if log_fn:
            log_fn(f"densify/prune at iter {done}: "
                   f"{', '.join(map(str, live))} of {cfg.n_splats} splats "
                   "live")
        if drops > 0:
            if log_fn:
                log_fn(f"WARNING: binning capacity overflow: {drops} "
                       f"splat-tile pairs dropped in the window ending at "
                       f"{done}; re-tuning capacities")
            cfg = _retune_batched(state.params, cfg)
            refsp = pad_refs(cfg)
    return state, history, cfg
