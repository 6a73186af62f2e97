"""The fitting loop (the counterpart of ``gs2d_tpu/train/loop.py``, resident,
flat, dense and window layouts): one train step = binning + the layout's
L2 kernels + moments_to_grads + Adam + metrics, driven by a host loop. The
SSIM objective, and ``fit_with_recovery``, take the modular step instead:
the differentiable render (forward kernel, backward kernel under
autograd's cotangent), the loss head, ``torch.autograd.grad``, then the
same Adam and metrics.

PyTorch runs eagerly, so the JAX package's ``jit``/``lax.scan`` have no
counterpart here: steps run in a Python loop and stay queued on the device
between log points (CUDA graphs over the step are a later change). The
reference's NaN abort (main.cpp:752-785) is an ``all_finite`` flag per step
that ``fit`` checks where it logs and before each checkpoint, raising
``FloatingPointError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_dense as rdn
from gs2d_tpu_torch.ops import render_flat as rf
from gs2d_tpu_torch.ops import render_resident as rr
from gs2d_tpu_torch.ops import render_window as rw
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.params import FIELDS, GaussianParams, init_params
from gs2d_tpu_torch.train.adam import AdamState, adam_update, init_adam_state
from gs2d_tpu_torch.train.metrics import mse_255, psnr_from_mse
from gs2d_tpu_torch.train.ssim import conv_flags, mixed_loss


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


def _tail(state: TrainState, grads: GaussianParams, color, ref,
          n_dropped, cfg: SplatConfig):
    """Adam, the NaN tripwire flag and the metrics of the pre-update render
    ``color`` against the (H, W, 3) target ``ref``."""
    params, opt = adam_update(state.params, grads, state.opt, cfg)
    finite = torch.stack([torch.isfinite(getattr(params, f)).all()
                          for f in FIELDS]).all()
    mse = mse_255(color, ref)
    return TrainState(params=params, opt=opt), StepAux(
        mse=mse, psnr=psnr_from_mse(mse), all_finite=finite,
        n_dropped=n_dropped)


def make_train_step_fused(cfg: SplatConfig):
    """Single-device train step through the layout's L2 kernels: the
    resident, flat, dense and window branches of gs2d_tpu's
    ``_fused_step_body``,
    binning every step. Returns ``step(state, ref_chw) -> (state,
    StepAux)``; the target must be pre-padded with ``render.pad_ref_chw``.
    Raises for a layout not ported yet and for flat capacities of the split
    step."""
    if cfg.rebin_margin != 0:
        raise NotImplementedError(
            "lazy rebinning (rebin_margin) is not ported yet (ROADMAP.md)")
    layout = rd.resolve_binning(cfg)
    if layout == "flat" and (cfg.flat_capacity or 0) > SPLIT_STEP_ROWS:
        raise NotImplementedError(
            f"flat capacity {cfg.flat_capacity} > SPLIT_STEP_ROWS "
            f"({SPLIT_STEP_ROWS}): the split step of the 1080p/1M workloads "
            "is not ported yet (ROADMAP.md queue 1 item 8)")
    k = rd._max_per_tile(cfg)

    def one_step(state: TrainState, ref_chw: torch.Tensor):
        if layout == "flat":
            color, grads, n_dropped = rf.l2_step_flat(state.params, ref_chw,
                                                      cfg)
        elif layout == "resident":
            color, grads, n_dropped = rr.l2_step_resident(
                state.params, ref_chw, cfg, k)
        elif layout == "window":
            color, grads, n_dropped = rw.l2_step_window(
                state.params, ref_chw, cfg, k)
        else:
            color, grads, n_dropped = rdn.l2_step_dense(
                state.params, ref_chw, cfg, k)
        ref_crop = ref_chw[0].permute(1, 2, 0)[: cfg.height, : cfg.width]
        return _tail(state, grads, color, ref_crop, n_dropped, cfg)

    return one_step


def make_train_step(cfg: SplatConfig, ssim_lambda: float = 0.0):
    """The modular train step (gs2d_tpu's ``make_train_step`` over
    ``production_render``): leaf copies of the parameters, the loss head
    over the differentiable render, ``torch.autograd.grad`` (the backward
    kernel runs there), then Adam and the metrics. The head is the
    (1-lam)*L2 + lam*(1-SSIM) mix, or for ``ssim_lambda`` = 0 the
    reference's 0.5 * sum((C - ref)^2), whose cotangent is C - ref
    (main.cpp:616); plain L2 fits usually train through
    ``make_train_step_fused``. The loss and its gradient run under
    ``ssim.conv_flags()``. Returns ``step(state, ref) -> (state, StepAux)``
    for the unpadded (H, W, 3) target ``ref``; unlike gs2d_tpu's modular
    step it reports the binning's n_dropped."""

    def one_step(state: TrainState, ref: torch.Tensor):
        leaves = [getattr(state.params, f).detach().requires_grad_()
                  for f in FIELDS]
        with conv_flags():
            color, n_dropped = rf.production_render(
                GaussianParams(**dict(zip(FIELDS, leaves))), cfg)
            if ssim_lambda:
                loss = mixed_loss(color, ref, ssim_lambda)
            else:
                d = color - ref
                loss = 0.5 * torch.sum(d * d)
            g = torch.autograd.grad(loss, leaves)
        grads = GaussianParams(**dict(zip(FIELDS, g)))
        return _tail(state, grads, color.detach(), ref, n_dropped, cfg)

    return one_step


def fit(
    ref,
    cfg: SplatConfig,
    iterations: int,
    device,
    state: Optional[TrainState] = None,
    log_every: int = 0,
    log_fn=print,
    checkpoint_every: int = 0,
    checkpoint_fn=None,
    raise_on_nonfinite: bool = True,
    use_fused: bool = True,
    scan_chunk: int = 0,
    ssim_lambda: float = 0.0,
    iter_offset: int = 0,
):
    """The host loop of a fit (main.cpp:334-851 minus the GUI).

    ``ref`` is the (H, W, 3) target. Unset binning statics are tuned from
    the population first, as gs2d_tpu's fit does: the flat capacity
    (render_flat.tune_flat_config) for the flat layout, the per-tile
    capacity (tiles.tune_tile_capacity) for the others, then the window
    width (render_window.tune_window) for the window layout. ``iter_offset``
    shifts the logged iteration numbers (callers fitting in blocks pass the
    global start). ``use_fused`` picks the fused L2 step
    (make_train_step_fused; gs2d_tpu's production path, and the default
    here, where gs2d_tpu's default is its scan renderer, which the port does
    not have); without it, or with ``ssim_lambda`` > 0 (the fused kernels
    hard-code the L2 cotangent), the fit takes the modular step
    (make_train_step) and, as gs2d_tpu does, tunes no per-tile capacity and
    zeroes ``rebin_margin``; the flat statics are still tuned, since its
    render needs them. ``checkpoint_fn(state, it)`` is called after every
    ``checkpoint_every``-th step with the block-relative count of steps
    done, if the state is finite; a non-finite state raises
    ``FloatingPointError`` there instead, or with ``raise_on_nonfinite`` =
    False is logged and not saved. ``raise_on_nonfinite`` = False leaves
    the NaN tripwire to the caller (StepAux.all_finite). ``scan_chunk`` > 1 is a later slice and
    raises. Returns (state, history), history being the logged steps' dicts
    (iteration, MSE, PSNR, the step's n_dropped, seconds)."""
    if scan_chunk and scan_chunk > 1:
        raise NotImplementedError(
            "scan_chunk > 1 has no counterpart yet (CUDA graphs over the "
            "step loop, ROADMAP.md)")
    device = torch.device(device)
    if state is None:
        state = init_train_state(cfg, device)
    if ssim_lambda:
        use_fused = False
    if not use_fused and cfg.rebin_margin != 0:
        cfg = cfg.replace(rebin_margin=0.0)  # the modular path rebins eagerly
    if rf.use_flat(cfg):
        if cfg.flat_capacity is None or cfg.flat_max_chunks is None:
            cfg = rf.tune_flat_config(state.params, cfg)
    elif cfg.max_splats_per_tile is None and use_fused:
        cfg = tl.tune_tile_capacity(state.params, cfg)
    if (use_fused and rd.resolve_binning(cfg) == "window"
            and cfg.window_width is None):
        cfg = rw.tune_window(state.params, cfg)
    if use_fused:
        step_fn = make_train_step_fused(cfg)
        ref_in = rd.pad_ref_chw(ref, cfg, device)
    else:
        step_fn = make_train_step(cfg, ssim_lambda)
        ref_in = torch.as_tensor(ref, dtype=torch.float32, device=device)

    history = []
    t0 = time.perf_counter()
    warned_drop = False

    def check(aux, it):
        nonlocal warned_drop
        if raise_on_nonfinite and not bool(aux.all_finite):
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
        state, aux = step_fn(state, ref_in)
        if log_every and (it % log_every == 0 or it == iterations - 1):
            check(aux, it + iter_offset)
            mse = float(aux.mse)
            rec = {"iter": it + iter_offset, "mse": mse,
                   "psnr": float(aux.psnr), "n_dropped": int(aux.n_dropped),
                   "elapsed_s": time.perf_counter() - t0}
            history.append(rec)
            if log_fn:
                log_fn(f"{it + iter_offset} itr, mse {mse:.4f}, psnr "
                       f"{rec['psnr']:.2f} dB")
        if checkpoint_every and checkpoint_fn \
                and (it + 1) % checkpoint_every == 0:
            # One sync per checkpoint: a non-finite state is never saved, so
            # fit_with_recovery never restores one.
            if bool(aux.all_finite):
                checkpoint_fn(state, it + 1)
            elif raise_on_nonfinite:
                raise FloatingPointError(
                    f"non-finite splat parameters at iteration "
                    f"{it + iter_offset}: checkpoint {it + 1} not saved")
            elif log_fn:
                log_fn(f"WARNING: non-finite splat parameters at iteration "
                       f"{it + iter_offset}: checkpoint {it + 1} not saved")
    if aux is not None:
        check(aux, iterations - 1 + iter_offset)
    return state, history


def fit_with_recovery(
    ref,
    cfg: SplatConfig,
    iterations: int,
    checkpointer,
    device,
    checkpoint_every: int = 100,
    max_recoveries: int = 3,
    lr_backoff: float = 0.5,
    log_every: int = 0,
    log_fn=print,
):
    """Failure-tolerant fitting: the reference hard-aborts on non-finite
    parameters (main.cpp:752-785); here the NaN tripwire triggers a restore
    from the latest checkpoint with the learning rate backed off (a
    divergent step replayed identically would fault identically), up to
    ``max_recoveries`` times. It starts from the checkpointer's latest
    checkpoint if there is one and, as in gs2d_tpu, trains through the
    modular step (the differentiable render's forward and backward kernels
    under an L2 head), not the fused one.

    Returns (state, history, n_recoveries)."""
    device = torch.device(device)
    step0, state = checkpointer.restore_latest(init_train_state(cfg, device))
    done = step0 or 0
    recoveries = 0
    history = []

    def ckpt(s, it):
        checkpointer.save(done + it, s, cfg)

    while done < iterations:
        try:
            state, hist = fit(
                ref, cfg, iterations - done, device, state=state,
                log_every=log_every, log_fn=log_fn,
                checkpoint_every=checkpoint_every, checkpoint_fn=ckpt,
                use_fused=False)
            for rec in hist:
                rec["iter"] += done
            history.extend(hist)
            done = iterations
        except FloatingPointError:
            recoveries += 1
            if recoveries > max_recoveries:
                raise
            cfg = cfg.replace(learning_rate=cfg.learning_rate * lr_backoff)
            step0, state = checkpointer.restore_latest(
                init_train_state(cfg, device))
            done = step0 or 0
            if log_fn:
                log_fn(f"non-finite parameters: restored checkpoint "
                       f"{done}, lr backed off to {cfg.learning_rate}")
    checkpointer.save(iterations, state, cfg)
    return state, history, recoveries
