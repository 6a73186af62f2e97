"""The fitting loop (the counterpart of ``gs2d_tpu/train/loop.py``, resident
and flat layouts): one train step = binning + the layout's L2 kernels +
moments_to_grads + Adam + metrics, driven by a host loop.

PyTorch runs eagerly, so the JAX package's ``jit``/``lax.scan`` have no
counterpart here: steps run in a Python loop and stay queued on the device
between log points (CUDA graphs over the step are a later change). The
reference's NaN abort (main.cpp:752-785) is an ``all_finite`` flag per step
that ``fit`` checks where it logs, raising ``FloatingPointError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_flat as rf
from gs2d_tpu_torch.ops import render_resident as rr
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.params import FIELDS, GaussianParams, init_params
from gs2d_tpu_torch.train.adam import AdamState, adam_update, init_adam_state
from gs2d_tpu_torch.train.metrics import mse_255, psnr_from_mse


@dataclasses.dataclass
class TrainState:
    """Splats, Adam moments, bias powers and step count."""

    params: GaussianParams
    opt: AdamState


def init_train_state(cfg: SplatConfig, device) -> TrainState:
    params = init_params(cfg, device)
    return TrainState(params=params, opt=init_adam_state(params))


class StepAux(NamedTuple):
    mse: torch.Tensor         # 0-255-scale MSE of the pre-update render
    psnr: torch.Tensor
    all_finite: torch.Tensor  # NaN tripwire flag
    n_dropped: torch.Tensor   # splat-tile pairs lost to capacity caps


# Flat capacity above which gs2d_tpu splits the train step into separately
# compiled programs (gs2d_tpu/train/loop.py:519): the 1080p/1M workloads.
SPLIT_STEP_ROWS = 6 * 1024 * 1024


def make_train_step_fused(cfg: SplatConfig):
    """Single-device train step through the layout's L2 kernels: the
    resident and flat branches of gs2d_tpu's ``_fused_step_body``, binning
    every step. Returns ``step(state, ref_chw) -> (state, StepAux)``; the
    target must be pre-padded with ``render.pad_ref_chw``. Raises for a cfg
    that gs2d_tpu would run on another layout, and for flat capacities of
    the split step."""
    if cfg.rebin_margin != 0:
        raise NotImplementedError(
            "lazy rebinning (rebin_margin) is not ported yet (ROADMAP.md)")
    flat = rd.resolve_binning(cfg) == "flat"
    if flat and (cfg.flat_capacity or 0) > SPLIT_STEP_ROWS:
        raise NotImplementedError(
            f"flat capacity {cfg.flat_capacity} > SPLIT_STEP_ROWS "
            f"({SPLIT_STEP_ROWS}): the split step of the 1080p/1M workloads "
            "is not ported yet (ROADMAP.md queue 1 item 8)")
    k = None if flat else rd._max_per_tile(cfg)

    def one_step(state: TrainState, ref_chw: torch.Tensor):
        if flat:
            color, grads, n_dropped = rf.l2_step_flat(state.params, ref_chw,
                                                      cfg)
        else:
            color, grads, n_dropped = rr.l2_step_resident(
                state.params, ref_chw, cfg, k)
        params, opt = adam_update(state.params, grads, state.opt, cfg)
        finite = torch.stack([torch.isfinite(getattr(params, f)).all()
                              for f in FIELDS]).all()
        ref_crop = ref_chw[0].permute(1, 2, 0)[: cfg.height, : cfg.width]
        mse = mse_255(color, ref_crop)
        return TrainState(params=params, opt=opt), StepAux(
            mse=mse, psnr=psnr_from_mse(mse), all_finite=finite,
            n_dropped=n_dropped)

    return one_step


def fit(
    ref,
    cfg: SplatConfig,
    iterations: int,
    device,
    state: Optional[TrainState] = None,
    log_every: int = 0,
    log_fn=print,
    scan_chunk: int = 0,
    ssim_lambda: float = 0.0,
):
    """The host loop of a fit (main.cpp:334-851 minus the GUI).

    ``ref`` is the (H, W, 3) target. Unset binning statics are tuned from
    the population first, as gs2d_tpu's fit does: the flat capacity
    (render_flat.tune_flat_config) for the flat layout, the per-tile
    capacity (tiles.tune_tile_capacity) for the resident one.
    ``scan_chunk`` > 1 and ``ssim_lambda`` are later slices and raise.
    Returns
    (state, history), history being the logged steps' dicts."""
    if scan_chunk and scan_chunk > 1:
        raise NotImplementedError(
            "scan_chunk > 1 has no counterpart yet (CUDA graphs over the "
            "step loop, ROADMAP.md)")
    if ssim_lambda:
        raise NotImplementedError("the SSIM objective is not ported yet "
                                  "(ROADMAP.md queue 1 item 7)")
    device = torch.device(device)
    if state is None:
        state = init_train_state(cfg, device)
    if rf.use_flat(cfg):
        if cfg.flat_capacity is None or cfg.flat_max_chunks is None:
            cfg = rf.tune_flat_config(state.params, cfg)
    elif cfg.max_splats_per_tile is None:
        cfg = tl.tune_tile_capacity(state.params, cfg)
    step_fn = make_train_step_fused(cfg)
    ref_chw = rd.pad_ref_chw(ref, cfg, device)

    history = []
    t0 = time.perf_counter()
    warned_drop = False

    def check(aux, it):
        nonlocal warned_drop
        if not bool(aux.all_finite):
            raise FloatingPointError(
                f"non-finite splat parameters at iteration {it} "
                "(reference aborts here, main.cpp:752-785)")
        dropped = int(aux.n_dropped)
        if not warned_drop and dropped > 0:
            warned_drop = True
            if log_fn:
                log_fn(f"WARNING: binning capacity overflow at iteration "
                       f"{it}: {dropped} splat-tile pairs dropped; raise "
                       "max_splats_per_tile / max_tiles_per_splat")

    aux = None
    for it in range(iterations):
        state, aux = step_fn(state, ref_chw)
        if log_every and (it % log_every == 0 or it == iterations - 1):
            check(aux, it)
            mse = float(aux.mse)
            rec = {"iter": it, "mse": mse, "psnr": float(aux.psnr),
                   "elapsed_s": time.perf_counter() - t0}
            history.append(rec)
            if log_fn:
                log_fn(f"{it} itr, mse {mse:.4f}, psnr {rec['psnr']:.2f} dB")
    if aux is not None:
        check(aux, iterations - 1)
    return state, history
