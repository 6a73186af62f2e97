"""The fitting loop (the counterpart of ``gs2d_tpu/train/loop.py``, resident,
flat, dense and window layouts): one train step = binning + the layout's
L2 kernels + moments_to_grads + Adam + metrics. The SSIM objective, and
``fit_with_recovery``, take the modular step instead: the differentiable
render (forward kernel, backward kernel under autograd's cotangent), the
loss head, ``torch.autograd.grad``, then the same Adam and metrics.

``fit`` drives the steps from a Python loop, or, with ``scan_chunk`` > 1,
in blocks of steps without the host (``_fit_scanned`` over
``make_fit_scan_fused`` / ``make_fit_scan``, the counterparts of gs2d_tpu's
``lax.scan`` fitters): on the card a block replays one step captured as a
CUDA graph (``train/graphs.py``), on the CPU the same step body runs in a
Python loop. With ``cfg.rebin_margin`` > 0 the scanned resident and flat
steps rebin lazily: they keep a margined binning and rebuild it only on
steps where the exact tripwire ``tiles.pairs_covered_by`` finds a pair
outside it, a choice made on the device. The reference's NaN abort
(main.cpp:752-785) is an ``all_finite`` flag per step that ``fit`` checks
where it logs (each block, when scanned) and before each checkpoint,
raising ``FloatingPointError``.

Flat capacities above ``SPLIT_STEP_ROWS`` (the 1080p/1M and 4K/4M fits)
run the same step as every other capacity. gs2d_tpu splits it there into
two programs, binning then kernels and Adam, so that the binner's sort
temporaries and the kernels' M-row buffers never share one XLA allocation
plan; here every temporary of the binner is freed before kernel 11
allocates, so the split has no counterpart. What stays of it is gs2d_tpu's
rule that such a step is never captured: ``fit`` and ``fit_adaptive``
ignore ``scan_chunk`` for it and the batched fitters refuse it.
Several images fit at once through ``make_batched_train_step_fused`` and
``make_fit_scan_batched``, gs2d_tpu's ``lax.map`` over a batched (B, N,
...) state: the images run one after another through the one-image step
(on the card, one captured step loaded with each image in turn).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_dense as rdn
from gs2d_tpu_torch.ops import render_flat as rf
from gs2d_tpu_torch.ops import render_resident as rr
from gs2d_tpu_torch.ops import render_window as rw
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.ops import tiles_flat as tlf
from gs2d_tpu_torch.params import FIELDS, GaussianParams, init_params
from gs2d_tpu_torch.train import graphs
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


def state_leaves(state: TrainState) -> list:
    """The 21 tensors of a TrainState in gs2d_tpu's pytree order: params,
    Adam's m and v (FIELDS order each), beta1t, beta2t, step."""
    opt = state.opt
    return ([getattr(p, f) for p in (state.params, opt.m, opt.v)
             for f in FIELDS] + [opt.beta1t, opt.beta2t, opt.step])


def state_from_leaves(leaves) -> TrainState:
    """The inverse of ``state_leaves``."""
    n = len(FIELDS)
    params, m, v = (GaussianParams(**dict(zip(FIELDS, leaves[i * n:
                                                             (i + 1) * n])))
                    for i in range(3))
    beta1t, beta2t, step = leaves[3 * n:]
    return TrainState(params=params, opt=AdamState(
        m=m, v=v, beta1t=beta1t, beta2t=beta2t, step=step))


def state_from_numpy(leaves, device) -> TrainState:
    """gs2d_tpu's TrainState as numpy (``[np.asarray(x) for x in
    jax.tree.leaves(state)]``, its 21 leaves in pytree order) as the port's,
    for one image (N, ...) or a batch (B, N, ...) alike."""
    return state_from_leaves([
        torch.from_numpy(np.array(x)).to(device) for x in leaves])


def state_index(state: TrainState, i: int) -> TrainState:
    """Image ``i`` of a batched (B, N, ...) state, as views."""
    return state_from_leaves([t[i] for t in state_leaves(state)])


def stack_states(states) -> TrainState:
    """The batched (B, N, ...) state of one-image states (fresh memory)."""
    return state_from_leaves([torch.stack(ts) for ts in
                              zip(*map(state_leaves, states))])


def init_batched_state(cfg: SplatConfig, batch: int, device) -> TrainState:
    """The one-image init, once per image (gs2d_tpu's, parallel/sharded.py:
    78-87): every leaf (B, N, ...), each image in its own memory, never an
    expanded view (Adam updates the leaves in place)."""
    return stack_states([init_train_state(cfg, device)] * batch)


class StepAux(NamedTuple):
    mse: torch.Tensor         # 0-255-scale MSE of the pre-update render
    psnr: torch.Tensor
    all_finite: torch.Tensor  # NaN tripwire flag
    n_dropped: torch.Tensor   # splat-tile pairs lost to capacity caps
    # (N,) |dL/d pos| of this step, the densify signal (a scanned fitter's
    # aux holds its sum instead); 0 when the step was built without it.
    pos_grad_mag: torch.Tensor = 0
    # 1 when the step rebuilt the cached binning (lazy rebinning); 0 on
    # cache hits and on the steps that keep no cache.
    rebinned: torch.Tensor = 0


# The fields a scanned fitter keeps for every step of a block.
STEP_FIELDS = tuple(f for f in StepAux._fields if f != "pos_grad_mag")


# Flat capacity above which gs2d_tpu splits the train step into separately
# compiled programs (gs2d_tpu/train/loop.py:519): the 1080p/1M workloads.
SPLIT_STEP_ROWS = 6 * 1024 * 1024


def _fma_rn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """float32 fma(y, y, x*x): y*y + x*x with one rounding. PyTorch has no
    fused multiply-add on every device, so: the sum in float64 (y*y is
    exact there), its rounding error by TwoSum, the float64 sum rounded
    to odd, then to float32, which rounds as the fused sum does."""
    c = (x * x).double()
    yy = y.double() * y.double()
    s = yy + c
    b = s - yy
    err = (yy - (s - b)) + (c - b)
    bits = s.view(torch.int64)
    odd = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    bits = bits + (odd * torch.sign(err)).to(torch.int64)
    return bits.view(torch.float64).to(torch.float32)


def _sqrt_rn(a: torch.Tensor) -> torch.Tensor:
    """The float32 square root rounded to nearest. PyTorch's CPU sqrt can
    miss it by an ulp, so the float64 root rounded to float32 is moved to
    the neighbour whose rounding interval holds sqrt(a): the midpoints
    have 25 bits, so their squares are exact in float64 (and no root of a
    float32 falls on a midpoint)."""
    r = torch.sqrt(a.double()).to(torch.float32)
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    dn = torch.nextafter(r, torch.zeros_like(r))
    hi = (r.double() + up.double()) * 0.5
    lo = (r.double() + dn.double()) * 0.5
    ad = a.double()
    return torch.where(hi * hi < ad, up, torch.where(lo * lo > ad, dn, r))


def grad_mag(g_pos: torch.Tensor) -> torch.Tensor:
    """(N,) |dL/d pos| from the (N, 2) position gradient (x, y): gs2d_tpu's
    ``jnp.linalg.norm(grads.pos, axis=-1)``, which XLA compiles on the CPU
    to sqrt(fma(y, y, x*x)); bit for bit that on the CPU and the card
    (tests/test_torch_densify.py), since the densify ranking depends on
    these bits. (XLA's CPU flushes subnormal squares, below 1e-19, to
    zero; this keeps them.)"""
    return _sqrt_rn(_fma_rn(g_pos[:, 0], g_pos[:, 1]))


def _tail(state: TrainState, grads: GaussianParams, color, ref,
          n_dropped, cfg: SplatConfig, rebinned=0, with_grad_mag=False):
    """Adam, the NaN tripwire flag and the metrics of the pre-update render
    ``color`` against the (H, W, 3) target ``ref``; ``with_grad_mag`` adds
    the densify signal ``grad_mag(grads.pos)``."""
    gmag = grad_mag(grads.pos) if with_grad_mag else 0
    params, opt = adam_update(state.params, grads, state.opt, cfg)
    finite = torch.stack([torch.isfinite(getattr(params, f)).all()
                          for f in FIELDS]).all()
    mse = mse_255(color, ref)
    return TrainState(params=params, opt=opt), StepAux(
        mse=mse, psnr=psnr_from_mse(mse), all_finite=finite,
        n_dropped=n_dropped, pos_grad_mag=gmag, rebinned=rebinned)


def _needs_split(cfg: SplatConfig) -> bool:
    return rf.use_flat(cfg) and (cfg.flat_capacity or 0) > SPLIT_STEP_ROWS


def make_train_step_fused(cfg: SplatConfig, with_grad_mag: bool = False):
    """Single-device train step through the layout's L2 kernels: the
    resident, flat, dense and window branches of gs2d_tpu's
    ``_fused_step_body``, binning every step (at margin 0 whatever
    cfg.rebin_margin says: only the scanned fit keeps a lazy cache).
    Returns ``step(state, ref_chw) -> (state, StepAux)``; the target must
    be pre-padded with ``render.pad_ref_chw``. ``with_grad_mag`` adds the
    (N,) densify signal |dL/d pos| to the aux. The same step serves flat
    capacities above SPLIT_STEP_ROWS, where gs2d_tpu splits it (see the
    module docstring)."""
    return _fused_step_body(cfg, with_grad_mag)


def _fused_step_body(cfg: SplatConfig, with_grad_mag: bool = False):
    """gs2d_tpu's ``_fused_step_body``: ``one_step(state, ref_chw)`` (its
    aux with the densify signal where ``with_grad_mag``), and
    for the resident and flat layouts under cfg.rebin_margin > 0 the lazy
    cache as ``one_step.make_bin_cache(params) -> cache`` and
    ``one_step.cached(state, ref_chw, cache, rebin) -> (state, aux)``.

    A cache is a list of tensors: the margined binning's ids, (flat: start,)
    count and n_dropped, then the six parameter tensors it was built from
    (the snapshot the tripwire measures drift against). ``cached`` calls
    ``rebin(pred, params)`` once with the 0-d bool "some exact pair escaped
    the cache, or the cache dropped pairs"; after the call the cache list
    holds ``make_bin_cache(params)`` where pred held and is unchanged
    elsewhere (the Python loop rebins if pred, the CUDA graph under a
    conditional node). The resident table, or the flat rows, are gathered
    from the live params every step."""
    layout = rd.resolve_binning(cfg)
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
        return _tail(state, grads, color, ref_crop, n_dropped, cfg,
                     with_grad_mag=with_grad_mag)

    if not (cfg.rebin_margin > 0 and layout in ("flat", "resident")):
        return one_step
    flat = layout == "flat"
    n_bin = 4 if flat else 3  # binning tensors before the snapshot

    def make_bin_cache(params: GaussianParams) -> list:
        if flat:
            b = tlf.bin_splats_flat(
                params, cfg, cfg.flat_capacity, kc=cfg.flat_chunk,
                max_chunks=cfg.flat_max_chunks, ids_only=True,
                margin=cfg.rebin_margin)
            head = [b.ids, b.start, b.count, b.n_dropped]
        else:
            b = tl.bin_splats(params, cfg, k, ids_only=True,
                              margin=cfg.rebin_margin)
            head = [b.ids, b.count, b.n_dropped]
        return head + [getattr(params, f) for f in FIELDS]

    def cached(state: TrainState, ref_chw: torch.Tensor, cache: list,
               rebin):
        snap = GaussianParams(**dict(zip(FIELDS, cache[n_bin:])))
        covered = tl.pairs_covered_by(state.params, snap, cfg,
                                      cfg.rebin_margin) \
            & (cache[n_bin - 1] == 0)
        rebin(~covered, state.params)
        if flat:
            ids, start, count, n_dropped = cache[:n_bin]
            binning = tlf.FlatBinning(
                ids=ids, rows=tlf.pregather_rows(ids, state.params, cfg),
                start=start, count=count, n_dropped=n_dropped)
            color, grads = rf.l2_render_and_grads_flat(
                binning, ref_chw, cfg.n_splats, cfg, cfg.flat_chunk,
                cfg.flat_max_chunks, state.params)
        else:
            ids, count, n_dropped = cache[:n_bin]
            binning = tl.TileBinning(ids=ids, count=count,
                                     n_dropped=n_dropped)
            color, grads = rr.l2_render_and_grads_resident(
                binning, rr.resident_table(state.params, cfg), ref_chw,
                cfg.n_splats, cfg)
        ref_crop = ref_chw[0].permute(1, 2, 0)[: cfg.height, : cfg.width]
        return _tail(state, grads, color, ref_crop, n_dropped, cfg,
                     rebinned=(~covered).to(torch.int32),
                     with_grad_mag=with_grad_mag)

    one_step.make_bin_cache = make_bin_cache
    one_step.cached = cached
    return one_step


def _cache_of_leaves(make_cache, leaves):
    return make_cache(state_from_leaves(leaves).params)


def _scan_step(one_step, cached, leaves, ref, caches, rebin):
    """ScanFitter's step body on the state's leaves (graphs.StepGraph's
    form): ``one_step``, or ``cached`` on the one lazy cache."""
    state = state_from_leaves(leaves)
    if cached is None:
        new, aux = one_step(state, ref)
    else:
        new, aux = cached(state, ref, caches[0],
                          lambda pred, params: rebin(0, pred))
    return state_leaves(new), aux


class ScanFitter:
    """``fit_k(state, ref, n_iters) -> (state, StepAux of (n_iters,)
    tensors)``: ``n_iters`` steps of ``one_step`` (or of the lazy ``cached``
    step, binned afresh from the incoming params at the start of each call,
    as each gs2d_tpu scan starts), through a ``graphs.BlockRunner``: CUDA
    states replay one captured step (captured at the first call and again
    when a call asks for more steps than its aux buffers hold; ``graph`` is
    the latest, ``captures`` counts them); CPU states run the same step body
    in a Python loop. With ``with_grad_mag`` the steps' (N,) densify
    signals are summed, as gs2d_tpu sums them in the scan carry, and the
    aux's ``pos_grad_mag`` is that sum: from zero, or continuing the sum
    ``grad_mag_sum`` a caller passes (the blocks of one densify window), so
    that blocks sum in the order of single steps."""

    def __init__(self, one_step, cached=None, make_cache=None,
                 with_grad_mag: bool = False):
        self.with_grad_mag = with_grad_mag
        self.runner = graphs.BlockRunner(
            functools.partial(_scan_step, one_step, cached),
            [] if make_cache is None else
            [functools.partial(_cache_of_leaves, make_cache)],
            STEP_FIELDS, "pos_grad_mag" if with_grad_mag else None)

    @property
    def graph(self):
        return self.runner.graph

    @property
    def captures(self) -> int:
        return self.runner.captures

    def __call__(self, state: TrainState, ref: torch.Tensor, n_iters: int,
                 grad_mag_sum: Optional[torch.Tensor] = None):
        new, aux, total = self.runner(state_leaves(state), ref, n_iters,
                                      grad_mag_sum)
        if self.with_grad_mag:
            aux["pos_grad_mag"] = total
        return state_from_leaves(new), StepAux(**aux)


def make_fit_scan_fused(cfg: SplatConfig, with_grad_mag: bool = False):
    """gs2d_tpu's ``make_fit_scan_fused``: ``fit_k(state, ref_chw, n_iters)
    -> (state, StepAux of (n_iters,) tensors)`` over the fused L2 step, with
    the lazy cache where cfg.rebin_margin > 0 on the resident and flat
    layouts (see ``ScanFitter``). ``ref_chw`` is padded
    (``render.pad_ref_chw``). With ``with_grad_mag`` the aux's
    ``pos_grad_mag`` is the (N,) sum of the block's densify signals. Its
    callers keep capacities above SPLIT_STEP_ROWS out of it."""
    one_step = _fused_step_body(cfg, with_grad_mag)
    return ScanFitter(one_step, getattr(one_step, "cached", None),
                      getattr(one_step, "make_bin_cache", None),
                      with_grad_mag)


def make_fit_scan(cfg: SplatConfig, ssim_lambda: float = 0.0):
    """gs2d_tpu's ``make_fit_scan``: ``fit_k(state, ref, n_iters)`` over the
    modular step (``make_train_step``; ``ref`` the unpadded (H, W, 3)
    target)."""
    return ScanFitter(make_train_step(cfg, ssim_lambda))


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
    the population first, as gs2d_tpu's fit does: ``cfg.rebin_margin`` < 0
    picks the margin (tiles.tune_rebin_margin), then the flat capacity
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
    render needs them. ``scan_chunk`` > 1 runs the iterations in blocks of
    that many steps without the host (``_fit_scanned``: history and
    checkpoints at block granularity, lazy rebinning under a margin); it
    is ignored, with a message, for flat capacities above SPLIT_STEP_ROWS
    (gs2d_tpu's split step). ``checkpoint_fn(state, it)`` is called after every
    ``checkpoint_every``-th step with the block-relative count of steps
    done, if the state is finite; a non-finite state raises
    ``FloatingPointError`` there instead, or with ``raise_on_nonfinite`` =
    False is logged and not saved. ``raise_on_nonfinite`` = False leaves
    the NaN tripwire to the caller (StepAux.all_finite). Returns (state,
    history), history being the logged steps' dicts (iteration, MSE, PSNR,
    the step's n_dropped, seconds; scanned fits add ``rebinned``)."""
    device = torch.device(device)
    if state is None:
        state = init_train_state(cfg, device)
    if ssim_lambda:
        use_fused = False
    if not use_fused and cfg.rebin_margin != 0:
        cfg = cfg.replace(rebin_margin=0.0)  # the modular path rebins eagerly
    if cfg.rebin_margin < 0:
        # -1 = auto: the slack from the measured pair inflation, before the
        # capacities are sized for it.
        cfg = tl.tune_rebin_margin(state.params, cfg)
    if rf.use_flat(cfg):
        if cfg.flat_capacity is None or cfg.flat_max_chunks is None:
            cfg = rf.tune_flat_config(state.params, cfg)
    elif cfg.max_splats_per_tile is None and use_fused:
        cfg = tl.tune_tile_capacity(state.params, cfg)
    if (use_fused and rd.resolve_binning(cfg) == "window"
            and cfg.window_width is None):
        cfg = rw.tune_window(state.params, cfg)
    if use_fused:
        ref_in = rd.pad_ref_chw(ref, cfg, device)
    else:
        ref_in = torch.as_tensor(ref, dtype=torch.float32, device=device)
    if use_fused and scan_chunk and scan_chunk > 1 and _needs_split(cfg):
        # gs2d_tpu's rule: at these step times dispatch overhead is noise.
        if log_fn:
            log_fn("scan_chunk ignored: flat capacity exceeds the "
                   "single-program memory budget (split steps)")
        scan_chunk = 0
    if scan_chunk and scan_chunk > 1:
        return _fit_scanned(
            ref_in, cfg, iterations, state, scan_chunk, use_fused=use_fused,
            ssim_lambda=ssim_lambda, log_every=log_every, log_fn=log_fn,
            checkpoint_every=checkpoint_every, checkpoint_fn=checkpoint_fn,
            raise_on_nonfinite=raise_on_nonfinite, iter_offset=iter_offset)
    step_fn = make_train_step_fused(cfg) if use_fused \
        else make_train_step(cfg, ssim_lambda)

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
            _checkpoint(state, bool(aux.all_finite), it + 1, it + iter_offset,
                        checkpoint_fn, raise_on_nonfinite, log_fn)
    if aux is not None:
        check(aux, iterations - 1 + iter_offset)
    return state, history


def _checkpoint(state, finite: bool, done: int, it: int, checkpoint_fn,
                raise_on_nonfinite: bool, log_fn) -> None:
    """Save ``state`` after ``done`` steps of this call unless it is not
    finite: a non-finite state is never saved, so fit_with_recovery never
    restores one (one sync per checkpoint)."""
    if finite:
        checkpoint_fn(state, done)
    elif raise_on_nonfinite:
        raise FloatingPointError(
            f"non-finite splat parameters at iteration {it}: checkpoint "
            f"{done} not saved")
    elif log_fn:
        log_fn(f"WARNING: non-finite splat parameters at iteration {it}: "
               f"checkpoint {done} not saved")


class BlockLog:
    """The host bookkeeping of a fit's blocks of steps, shared by the
    one-image, batched and mesh block loops (gs2d_tpu's, message for
    message). A block is the steps' aux read to the host, one row a step:
    ``mse`` and ``psnr`` ((n,) for one image, (n, B) for several; or the
    logged steps' rows alone, as the mesh gathers them), ``n_dropped``,
    ``all_finite`` and, when scanned, ``rebinned`` (n,). History records
    (and log lines) are appended to ``history``, one a step at a multiple
    of ``log_every`` and the last of ``iterations``, with global iteration
    numbers (``iter_offset``) and the block's end time."""

    def __init__(self, history: list, iterations: int, log_every: int,
                 log_fn, t0: float, iter_offset: int = 0):
        self.history, self.iterations = history, iterations
        self.log_every, self.log_fn = log_every, log_fn
        self.t0, self.iter_offset = t0, iter_offset
        self.warned_drop = self.warned_rebin = False

    def logged(self, at: int, n: int) -> list:
        """The logged steps of the n-step block from step ``at``."""
        if not self.log_every:
            return []
        return [at + j for j in range(n)
                if (at + j) % self.log_every == 0
                or at + j == self.iterations - 1]

    def check_finite(self, finite: torch.Tensor, at: int) -> None:
        """The reference's abort (main.cpp:752-785) at the block's first
        step whose parameters are not finite (``finite`` (n,) bool)."""
        if not bool(finite.all()):
            bad = int(torch.argmin(finite.to(torch.int32)))
            raise FloatingPointError(
                f"non-finite splat parameters at iteration "
                f"{at + bad + self.iter_offset} "
                "(reference aborts here, main.cpp:752-785)")

    def warn_drop(self, dropped: torch.Tensor, at: int) -> None:
        """The once-only overflow warning at the block's first step that
        dropped pairs (``dropped`` (n,))."""
        if self.warned_drop or not bool((dropped > 0).any()):
            return
        self.warned_drop = True
        first = int(torch.argmax((dropped > 0).to(torch.int32)))
        if self.log_fn:
            block = " in this block" if dropped.numel() > 1 else ""
            self.log_fn(f"WARNING: binning capacity overflow at iteration "
                        f"{at + first + self.iter_offset}: "
                        f"{int(dropped.sum())} splat-tile pairs dropped"
                        f"{block}; raise max_splats_per_tile / "
                        "max_tiles_per_splat")

    def warn_rebin(self, rebinned: torch.Tensor, rebin_margin: float) -> None:
        """The once-only warning that a block of 8 or more steps rebinned
        on every step: the tripwire never validates (a footprint outgrew
        the slot grid, or the margined binning drops pairs), which costs
        more than rebin_margin=0. Never wrong, so a warning, as in
        gs2d_tpu."""
        n = rebinned.numel()
        if self.warned_rebin or rebin_margin <= 0 or n < 8 \
                or int(rebinned.sum()) != n:
            return
        self.warned_rebin = True
        if self.log_fn:
            self.log_fn("WARNING: lazy rebinning rebinned on every step of "
                        f"this {n}-step block (cache never validates); "
                        "re-tune binning (tune_flat_config / "
                        "tune_tile_capacity) or set rebin_margin=0")

    def record(self, block: dict, at: int, logged: list) -> None:
        """The records of the ``logged`` steps of the block from ``at``."""
        elapsed = time.perf_counter() - self.t0
        n = block["n_dropped"].numel()
        for k, it in enumerate(logged):
            j = it - at
            row = j if block["mse"].shape[0] == n else k
            mse, psnr = block["mse"][row], block["psnr"][row]
            rec = {"iter": it + self.iter_offset, "mse": mse.tolist(),
                   "psnr": psnr.tolist(),
                   "n_dropped": int(block["n_dropped"][j])}
            if block.get("rebinned") is not None:
                rec["rebinned"] = int(block["rebinned"][j])
            rec["elapsed_s"] = elapsed
            self.history.append(rec)
            if not self.log_fn:
                continue
            if mse.dim() == 0:
                self.log_fn(f"{rec['iter']} itr, mse {rec['mse']:.4f}, psnr "
                            f"{rec['psnr']:.2f} dB")
            else:
                self.log_fn(f"{rec['iter']} itr, mse "
                            + " ".join(f"{x:.4f}" for x in rec["mse"]))


def _fit_scanned(ref, cfg: SplatConfig, iterations: int, state: TrainState,
                 scan_chunk: int, *, use_fused: bool, ssim_lambda: float,
                 log_every: int, log_fn, checkpoint_every: int,
                 checkpoint_fn, raise_on_nonfinite: bool,
                 iter_offset: int = 0):
    """fit()'s body for scan_chunk > 1 (gs2d_tpu's ``_fit_scanned``): blocks
    of ``scan_chunk`` steps (the last one shorter where the chunk does not
    divide ``iterations``), each one call of the scanned fitter. ``ref`` is
    padded (fused) or not (modular). The block's aux is read once after
    it, so history records (global iteration numbers) carry the block's
    end time; the non-finite abort names the block's first bad iteration;
    checkpoints fall where ``done % checkpoint_every == 0`` at a block end.
    The first block logs what capturing the step cost on the card."""
    fit_k = make_fit_scan_fused(cfg) if use_fused \
        else make_fit_scan(cfg, ssim_lambda)
    history = []
    blog = BlockLog(history, iterations, log_every, log_fn,
                    time.perf_counter(), iter_offset)
    done = 0
    while done < iterations:
        n = min(scan_chunk, iterations - done)
        graph = fit_k.graph
        state, auxes = fit_k(state, ref, n)
        if fit_k.graph is not graph and log_fn:
            c = fit_k.graph.capture
            log_fn(f"captured the train step as a CUDA graph in "
                   f"{c.capture_s:.3f}s (warm-up step {c.warmup_s:.3f}s)")
        block = {f: getattr(auxes, f).cpu() for f in STEP_FIELDS}
        finite = block["all_finite"]
        if raise_on_nonfinite:
            blog.check_finite(finite, done)
        blog.warn_drop(block["n_dropped"], done)
        blog.warn_rebin(block["rebinned"], cfg.rebin_margin)
        blog.record(block, done, blog.logged(done, n))
        done += n
        if checkpoint_every and checkpoint_fn \
                and done % checkpoint_every == 0:
            _checkpoint(state, bool(finite[-1]), done,
                        done - 1 + iter_offset, checkpoint_fn,
                        raise_on_nonfinite, log_fn)
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


# --- several images: gs2d_tpu's lax.map over the batch -----------------------

def _refuse_split(cfg: SplatConfig) -> None:
    if _needs_split(cfg):
        raise ValueError(
            f"flat capacity {cfg.flat_capacity} exceeds the single-program "
            f"budget (SPLIT_STEP_ROWS={SPLIT_STEP_ROWS}); batch fitting at "
            "this scale should run the images separately")


def _batched_aux(auxes, with_grad_mag: bool = False) -> StepAux:
    """One StepAux of per-image ones (each field (...) -> (..., B)):
    ``all_finite`` one flag over every image, broadcast; ``n_dropped``
    summed; ``rebinned`` the max; ``pos_grad_mag`` stacked (B, N)."""
    field = lambda f: torch.stack([torch.as_tensor(getattr(a, f))
                                   for a in auxes], dim=-1)
    mse = field("mse")
    return StepAux(
        mse=mse, psnr=field("psnr"),
        all_finite=field("all_finite").all(dim=-1, keepdim=True).expand(
            mse.shape),
        n_dropped=field("n_dropped").sum(dim=-1).to(torch.int32),
        pos_grad_mag=(torch.stack([a.pos_grad_mag for a in auxes])
                      if with_grad_mag else 0),
        rebinned=field("rebinned").amax(dim=-1).to(torch.int32))


def make_batched_train_step_fused(cfg: SplatConfig):
    """gs2d_tpu's ``make_batched_train_step_fused`` (loop.py:675-725): the
    fused step body of one image run over the images in turn (its
    ``lax.map``), on a batched (B, N, ...) state (``parallel.sharded.
    init_batched_state``) and (B, 1, 3, Hp, Wp) padded targets. Each image
    owns its own population; the binning statics are shared (flat: tuned
    on the shared init; an image that outgrows them reports n_dropped).
    Every layout is supported. Returns ``step(state, refs_chw) -> (state,
    StepAux)`` with ``mse`` and ``psnr`` of shape (B,), ``all_finite`` one
    flag over every image broadcast to (B,), ``n_dropped`` summed. Image i
    equals the one-image step on image i bit for bit. Raises for flat
    capacities above SPLIT_STEP_ROWS, as gs2d_tpu does."""
    _refuse_split(cfg)
    one_step = _fused_step_body(cfg)

    def step(state: TrainState, refs_chw: torch.Tensor):
        outs = [one_step(state_index(state, i), refs_chw[i])
                for i in range(refs_chw.shape[0])]
        return stack_states([o[0] for o in outs]), _batched_aux(
            [o[1] for o in outs])

    return step


class BatchedScanFitter:
    """``fit_k(state, refs_chw, n_iters, grad_mag_sum=None) -> (state,
    StepAux)``: ``n_iters`` steps of every image of a batched state, one
    image after another through one ``ScanFitter`` (``fitter``): on the
    card one captured step, into whose static buffers each image's leaves,
    target and freshly binned lazy cache are loaded before its replays, so
    one capture serves every image and nothing of one image's block
    outlives it. The aux: ``mse`` and ``psnr`` (n_iters, B), ``all_finite``
    (n_iters, B), ``n_dropped`` (n_iters,) summed over the images,
    ``rebinned`` (n_iters,) their max, and with ``with_grad_mag``
    ``pos_grad_mag`` (B, N), each image's sum continuing its row of
    ``grad_mag_sum``."""

    def __init__(self, fitter: ScanFitter):
        self.fitter = fitter

    @property
    def graph(self):
        return self.fitter.graph

    @property
    def captures(self) -> int:
        return self.fitter.captures

    def __call__(self, state: TrainState, refs_chw: torch.Tensor,
                 n_iters: int, grad_mag_sum: Optional[torch.Tensor] = None):
        outs = [self.fitter(state_index(state, i), refs_chw[i], n_iters,
                            None if grad_mag_sum is None
                            else grad_mag_sum[i])
                for i in range(refs_chw.shape[0])]
        return stack_states([o[0] for o in outs]), _batched_aux(
            [o[1] for o in outs], self.fitter.with_grad_mag)


def make_fit_scan_batched(cfg: SplatConfig, with_grad_mag: bool = False):
    """gs2d_tpu's ``make_fit_scan_batched`` (loop.py:728-792): blocks of
    the fused step over a batch of images (``BatchedScanFitter``), with a
    lazy cache per image where cfg.rebin_margin > 0, binned afresh from
    each image's params at the start of every call as gs2d_tpu's scan
    does. gs2d_tpu runs the images one after another too; a batch axis in
    the kernels' grid is not built. Raises for flat capacities above
    SPLIT_STEP_ROWS."""
    _refuse_split(cfg)
    return BatchedScanFitter(make_fit_scan_fused(cfg, with_grad_mag))


class _BatchedEagerBlocks:
    """The batched eager step behind ``BatchedScanFitter``'s call (no
    graph, no signal): ``n_iters`` steps, their auxes stacked (n_iters,
    ...) for the caller to read once."""

    graph = None

    def __init__(self, cfg: SplatConfig):
        self.step = make_batched_train_step_fused(cfg)

    def __call__(self, state: TrainState, refs_chw: torch.Tensor,
                 n_iters: int, grad_mag_sum=None):
        auxes = []
        for _ in range(n_iters):
            state, aux = self.step(state, refs_chw)
            auxes.append(aux)
        return state, StepAux(**{
            f: torch.stack([torch.as_tensor(getattr(a, f)) for a in auxes])
            for f in STEP_FIELDS}, pos_grad_mag=0)


def run_batched(fit_k, state: TrainState, refs_chw: torch.Tensor, first: int,
                n: int, chunk: int, iterations: int, history: list,
                t0: float, grad_mag_sum=None, log_every: int = 0,
                log_fn=print):
    """Steps ``first`` .. ``first + n - 1`` of a batched fit of
    ``iterations`` steps, in blocks of ``chunk`` through ``fit_k`` (a
    ``BatchedScanFitter``, whose signal sum carries from block to block
    in ``grad_mag_sum``). Each block logs the capture it made, raises
    ``FloatingPointError`` at its first non-finite step (the reference's
    abort, main.cpp:752-785), and appends to ``history`` (and prints) a
    record for each step at a multiple of ``log_every`` and the last: the
    images' MSEs and PSNRs, the pairs dropped over the images,
    ``rebinned`` and the seconds since ``t0``. Returns (state,
    grad_mag_sum, the pairs dropped in these steps)."""
    blog = BlockLog(history, iterations, log_every, log_fn, t0)
    drops, done = 0, 0
    while done < n:
        k = min(chunk, n - done)
        graph = fit_k.graph
        state, auxes = fit_k(state, refs_chw, k, grad_mag_sum=grad_mag_sum)
        if fit_k.graph is not graph and log_fn:
            c = fit_k.graph.capture
            log_fn(f"captured the train step as a CUDA graph in "
                   f"{c.capture_s:.3f}s (warm-up step {c.warmup_s:.3f}s)")
        if torch.is_tensor(auxes.pos_grad_mag):  # a fitter with the signal
            grad_mag_sum = auxes.pos_grad_mag
        block = {f: getattr(auxes, f).cpu() for f in STEP_FIELDS}
        at = first + done
        blog.check_finite(block["all_finite"].reshape(k, -1).all(dim=-1), at)
        drops += int(block["n_dropped"].sum())
        blog.record(block, at, blog.logged(at, k))
        done += k
    return state, grad_mag_sum, drops


def fit_batched(refs, cfg: SplatConfig, iterations: int, device,
                state: Optional[TrainState] = None, scan_chunk: int = 0,
                log_every: int = 0, log_fn=print):
    """Several images at once without density control (the fit of
    gs2d_tpu's ``cli._fit_batch`` without ``--densify-every``,
    cli.py:108-205): B equal-sized (H, W, 3) targets ``refs``, one
    population each (``init_batched_state`` when None), at cfg's binning
    statics, which must be set (tuned on the shared init). With
    ``scan_chunk`` > 1, blocks of that many steps through
    ``make_fit_scan_batched`` (one capture); else the batched eager step,
    read once every ``log_every`` steps (50 without logging). Logs and
    checks through ``run_batched``; an overflow is reported once, at the
    end. Returns (state, history): ``run_batched``'s records and one
    ``{"event": "end", ...}`` record with the pairs dropped over the fit
    (``window_drops``: the fit is one window)."""
    device = torch.device(device)
    if state is None:
        state = init_batched_state(cfg, len(refs), device)
    refs_chw = torch.stack([rd.pad_ref_chw(r, cfg, device) for r in refs])
    scanned = scan_chunk > 1
    fit_k = make_fit_scan_batched(cfg) if scanned \
        else _BatchedEagerBlocks(cfg)
    history = []
    state, _, drops = run_batched(
        fit_k, state, refs_chw, 0, iterations,
        scan_chunk if scanned else (log_every or 50), iterations, history,
        time.perf_counter(), log_every=log_every, log_fn=log_fn)
    if drops and log_fn:
        log_fn(f"WARNING: binning capacity overflow: {drops} splat-tile "
               "pairs dropped over the fit; raise max_splats_per_tile / "
               "max_tiles_per_splat")
    history.append({"event": "end", "at": iterations, "window_drops": drops})
    return state, history
