"""Flat-layout rasterizer (the counterpart of
``gs2d_tpu/ops/render_pallas_flat.py``): the layout gs2d_tpu picks above
4096 splats.

Each tile's pregathered (tile, splat) pair rows form a run of whole kc-row
blocks in one flat (M, N_FIELDS) array (``ops/tiles_flat.py``). The kernels
run one warp per 8 x 32 pixel patch over a tile's run, walking only the rows
whose splat covers a pixel of the patch, up to the patch's saturation
(``csrc/patch_walk.cuh``, shared with the resident kernels 1 and 2;
``render_resident.listed_cover_mask`` is that cull in plain PyTorch); the
backward writes one 9-moment row per flat row and adds each splat's rows
over the tiles of its tile box, in tile order, onto the splat axis.

Two kernels, each behind a wrapper that dispatches on the tensors' device:

- ``forward_flat`` (kernel 10, the forward composite) and
- ``backward_flat`` (kernel 11, the backward replay from a carry-in prefix
  for any upstream cotangent, plus the segment sum)

launch the CUDA kernels of ``csrc/render_flat.cu`` for CUDA tensors
(raising if the launch fails) and run the plain PyTorch twins beside them
(``_fwd_flat_plain`` / ``_bwd_flat_plain``) for CPU tensors. Each wrapper
adds one to ``launches[<name>]`` where it launches its kernel, and nowhere
else. Kernel 10 runs after a pass that marks the rows with a non-finite
field (``launches["fwd_flat_mask"]``; ``_nonfinite_mask_plain`` is its
twin), so a warp past its saturation exit reads the mask instead of culling
the rest of its run. ``l2_step_flat`` is the fused train step's flat branch
and ``render_flat`` the final render.

``production_render`` is gs2d_tpu's differentiable render over the three
production layouts (resident, flat, dense): a ``torch.autograd.Function``
whose forward and backward are the layout's kernels, for objectives that
autograd differentiates on top of the image (train/ssim.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_dense as rdn
from gs2d_tpu_torch.ops import render_resident as rr
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.ops import tiles_flat as tlf
from gs2d_tpu_torch.ops._build import check, library, on_card, stream
from gs2d_tpu_torch.params import FIELDS, GaussianParams
from gs2d_tpu_torch.utils.profiling import span

# Kernel launch counts since the last reset_launch_counts().
launches = {"fwd_flat": 0, "fwd_flat_mask": 0, "bwd_flat": 0}

# Tile shapes the CUDA kernels take: what tiles.tune_tile_height returns.
CUDA_TILE_W = 128
CUDA_TILE_HS = (32, 64)


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def use_flat(cfg: SplatConfig) -> bool:
    """True iff ``cfg`` resolves to the flat layout."""
    return rd.resolve_binning(cfg) == "flat"


def tune_flat_config(p: GaussianParams, cfg: SplatConfig,
                     margin: float = 1.5, n_bands: int = 1) -> SplatConfig:
    """Fill cfg.flat_capacity / flat_max_chunks from the measured tile
    counts of ``p`` (gs2d_tpu.ops.render_pallas_flat.tune_flat_config).
    Under lazy rebinning (cfg.rebin_margin > 0) it first sizes the
    tripwire's slot grid (max_tiles_per_splat, which the flat expansion
    itself does not cap: tiles.pairs_covered_by rebins on every step once a
    splat outgrows it) and measures the margined footprints."""
    if cfg.rebin_margin > 0:
        cfg = tl.tune_max_tiles_per_splat(p, cfg)
    m, mc = tlf.tune_flat_capacity(p, cfg, kc=cfg.flat_chunk, margin=margin,
                                   n_bands=n_bands,
                                   bin_margin=cfg.rebin_margin)
    return cfg.replace(flat_capacity=m, flat_max_chunks=mc)


def _statics(cfg: SplatConfig):
    if cfg.flat_capacity is None or cfg.flat_max_chunks is None:
        raise ValueError("flat binning statics unset; call "
                         "tune_flat_config(params, cfg)")
    return cfg.flat_capacity, cfg.flat_chunk, cfg.flat_max_chunks


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the card-side reference in chip_smoke).
# ---------------------------------------------------------------------------

def _flat_walk(rows, start, count, cfg: SplatConfig, kc: int,
               max_chunks: int, step, carry, get_t):
    """Walk every tile's run in lockstep: step k hands ``step`` the flat
    row index (n_tiles,) of each tile's k-th pair (the trash index M past a
    tile's count) and those rows, gathered. Saturation checks at every
    chunk start, and every SAT_CHECK_EVERY steps at N >= SAT_WALK_THRESHOLD,
    stop the walk once every tile is saturated (render.saturating_loop)."""
    m = rows.shape[0]
    count = count.clamp(max=max_chunks * kc)
    rows_ext = torch.cat([rows, tl.pad_row(rows.device)[None]])
    check_every = min(kc, rd.SAT_CHECK_EVERY) if rd._sat_walk(cfg) else kc

    def one(k, c):
        idx = torch.where(k < count, start + k, m).long()
        return step(idx, rows_ext[idx], c)

    n_steps = int(count.max()) if count.numel() else 0
    return rd.saturating_loop(n_steps, one, carry, get_t,
                              cfg.min_throughput, check_every)


def _fwd_flat_plain(rows, start, count, cfg: SplatConfig, kc: int,
                    max_chunks: int, band_row0: int = 0, band_rows=None):
    """Plain twin of kernel 10: (color (3, Hp, Wp), T (Hp, Wp)), or the
    band's rows of them."""
    yy, xx, fy, fx, inside = rd.tile_coords(cfg, rows.device, band_row0,
                                            band_rows)
    zero = torch.zeros_like(fx)

    def step(idx, r, carry):
        return rd._fwd_one(r, fx, fy, xx, yy, inside, cfg, carry)

    cr, cg, cb, T = _flat_walk(rows, start, count, cfg, kc, max_chunks, step,
                               (zero, zero, zero, inside.to(torch.float32)),
                               lambda c: c[3])
    return (rd.from_tiles(torch.stack([cr, cg, cb]), cfg),
            rd.from_tiles(T[None], cfg)[0])


def _nonfinite_mask_plain(rows) -> torch.Tensor:
    """Plain twin of the mask pass before kernel 10: (ceil(M / 32),) int32
    words whose bit j of word w is set iff row 32 w + j of the (M,
    N_FIELDS) rows has a non-finite field among FIELD_PX..FIELD_OP (the
    cull's test, FIELD_H included); bits past M are clear."""
    m = rows.shape[0]
    words = -(-m // 32)
    bad = torch.zeros(words * 32, dtype=torch.int64, device=rows.device)
    fields = rows[:, tl.FIELD_PX: tl.FIELD_OP + 1]
    bad[:m] = (~torch.isfinite(fields).all(dim=1)).to(torch.int64)
    bit = torch.arange(32, dtype=torch.int64, device=rows.device)
    w = (bad.reshape(words, 32) << bit).sum(dim=1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _bwd_flat_plain(rows, ids, start, count, fin, gc, cin, tin,
                    n_splats: int, cfg: SplatConfig, kc: int,
                    max_chunks: int, band_row0: int = 0, band_rows=None):
    """Plain twin of kernel 11 and the segment sum: (per-pair moments
    (M, 9), splat moments (9, n)). ``fin``, ``gc`` and ``cin`` are
    (3, Hp, Wp), ``tin`` (Hp, Wp), or the band's rows of them."""
    yy, xx, fy, fx, inside = rd.tile_coords(cfg, rows.device, band_row0,
                                            band_rows)
    gc_rgb, gf, ga = rd.cotangent_tiles(fin, gc, cin, cfg)
    m = rows.shape[0]
    moments = torch.zeros((m + 1, rd.N_MOMENTS), dtype=torch.float32,
                          device=rows.device)

    def step(idx, r, carry):
        carry, col = rd._bwd_splat_step(r, fx, fy, xx, yy, inside, cfg, carry,
                                        gf, gc_rgb)
        moments[idx] = col  # unique rows, but the trash row M
        return carry

    _flat_walk(rows, start, count, cfg, kc, max_chunks, step,
               (ga, rd.to_tiles(tin[None], cfg)[0]), lambda c: c[1])
    moments = moments[:m]
    return moments, rd.segment_sum_plain(ids, start, count, moments,
                                         n_splats)


# ---------------------------------------------------------------------------
# CUDA launches.
# ---------------------------------------------------------------------------

def _check_inputs(cfg: SplatConfig, rows, start, count, kc: int, gy: int,
                  *planes):
    """Raise on what the kernels do not take, for a launch over ``gy``
    tile rows; returns the library."""
    if cfg.tile_w != CUDA_TILE_W or cfg.tile_h not in CUDA_TILE_HS:
        raise ValueError(
            f"tile {cfg.tile_h}x{cfg.tile_w} unsupported by the flat CUDA "
            f"kernels (tile_w {CUDA_TILE_W}, tile_h in {CUDA_TILE_HS})")
    n_tiles = cfg.n_tiles_x * gy
    if rows.ndim != 2 or rows.shape[1] != tl.N_FIELDS \
            or rows.shape[0] % kc:
        raise ValueError(f"rows: need (M, {tl.N_FIELDS}) with M a multiple "
                         f"of kc {kc}, got {tuple(rows.shape)}")
    want = [("rows", rows, torch.float32, None),
            ("start", start, torch.int32, (n_tiles,)),
            ("count", count, torch.int32, (n_tiles,))]
    want += [(name, t, torch.float32, shape) for name, t, shape in planes]
    for name, t, dtype, shape in want:
        if t.dtype != dtype or not t.is_contiguous() \
                or t.device != rows.device:
            raise ValueError(f"{name}: need contiguous {dtype} on "
                             f"{rows.device}, got {t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    return library()


def _mask_words(rows) -> torch.Tensor:
    """Scratch for the mask pass over ``rows``: one int32 word per 32
    rows, every word written by the pass."""
    return torch.empty((-(-rows.shape[0] // 32),), dtype=torch.int32,
                       device=rows.device)


def _nonfinite_mask_cuda(rows) -> torch.Tensor:
    """The mask pass alone (the one ``_fwd_flat_cuda`` runs before kernel
    10): _nonfinite_mask_plain's words."""
    lib = library()
    if rows.ndim != 2 or rows.shape[1] != tl.N_FIELDS \
            or rows.dtype != torch.float32 or not rows.is_contiguous():
        raise ValueError(f"rows: need contiguous float32 (M, "
                         f"{tl.N_FIELDS}), got {tuple(rows.shape)}")
    mask = _mask_words(rows)
    check(lib.gs2d_flat_nonfinite_mask(rows.data_ptr(), mask.data_ptr(),
                                       rows.shape[0], stream(rows)),
          "fwd_flat_mask kernel launch")
    launches["fwd_flat_mask"] += 1
    return mask


def _fwd_flat_cuda(rows, start, count, cfg: SplatConfig, kc: int,
                   max_chunks: int, walked=None, band_row0: int = 0,
                   band_rows=None, exits=None):
    """Kernel 10, after the mask pass; ``walked`` (patches, 2) int32 gets
    each warp patch's survivors and survivors walked
    (render_resident._walked_ptr), for which the kernel culls every run
    whole and runs no mask pass. ``exits`` (patches,) int32 gets each
    patch's exit slot: the slots of its run up to the survivor after which
    no pixel of it keeps T >= min_throughput (0 where none did from the
    start, the run's length where it never saturates). Under band
    arguments (render.py) the planes are the band's rows."""
    gy, row_off = rd.band_grid(cfg, band_row0, band_rows)
    lib = _check_inputs(cfg, rows, start, count, kc, gy)
    dev = rows.device
    hp, wp = gy * cfg.tile_h, cfg.padded_width
    color = torch.empty((3, hp, wp), dtype=torch.float32, device=dev)
    trans = torch.empty((hp, wp), dtype=torch.float32, device=dev)
    walked_ptr = rr._walked_ptr(walked, cfg, dev, gy)
    if exits is not None:
        shape = (cfg.n_tiles_x * gy
                 * rr.patches_per_tile(cfg, rr.patch_rows()),)
        if (tuple(exits.shape) != shape or exits.dtype != torch.int32
                or not exits.is_contiguous() or exits.device != dev):
            raise ValueError(f"exits: need contiguous int32 {shape} on "
                             f"{dev}")
    mask = _mask_words(rows) if walked is None else None
    with span("gs2d.fwd_flat"):
        err = lib.gs2d_fwd_flat(
            rows.data_ptr(), start.data_ptr(), count.data_ptr(),
            color.data_ptr(), trans.data_ptr(), walked_ptr,
            0 if mask is None else mask.data_ptr(),
            0 if exits is None else exits.data_ptr(), rows.shape[0],
            cfg.height, cfg.width, cfg.tile_h, cfg.tile_w, cfg.n_tiles_x, gy,
            row_off, kc, max_chunks, cfg.cutoff_sq, cfg.min_throughput,
            int(cfg.use_exp_approx), stream(rows))
    check(err, "fwd_flat kernel launch")
    launches["fwd_flat"] += 1
    if mask is not None:
        launches["fwd_flat_mask"] += 1
    return color, trans


def partial_shape(cfg: SplatConfig, m_rows: int) -> Tuple[int, ...]:
    """Kernel 11's per-patch moment partials: (patches per tile, M, 9),
    patch (pass, warp) at pass * warps per pass + warp. Its scratch is
    uninitialised: the patch sum reads only the entries of listed rows,
    which the replay writes (a culled or saturated row's exact zero
    included)."""
    return (rr.patches_per_tile(cfg, rr.patch_rows()), m_rows, rd.N_MOMENTS)


def _bwd_flat_cuda(rows, ids, start, count, fin, gc, cin, tin,
                   n_splats: int, cfg: SplatConfig, kc: int,
                   max_chunks: int, band_row0: int = 0, band_rows=None, *,
                   fields, partial=None, walked=None, boxes=None):
    """Kernel 11: the plain twin's arguments plus ``fields``, the
    (N_FIELDS, n) packed fields of the splats (tiles.packed_fields), from
    which the splat sum takes each splat's tile box (band-local rows under
    a band). ``partial`` replaces the uninitialised scratch (a test's
    NaN-filled buffer); ``walked`` as in _fwd_flat_cuda; ``boxes`` (n, 4)
    int32 gets each splat's box (tx0, tx1, ty0, ty1; empty as ty0 >
    ty1)."""
    gy, row_off = rd.band_grid(cfg, band_row0, band_rows)
    hp, wp = gy * cfg.tile_h, cfg.padded_width
    lib = _check_inputs(cfg, rows, start, count, kc, gy,
                        ("fin", fin, (3, hp, wp)),
                        ("gc", gc, (3, hp, wp)), ("cin", cin, (3, hp, wp)),
                        ("tin", tin, (hp, wp)),
                        ("fields", fields, (tl.N_FIELDS, n_splats)))
    if ids.dtype != torch.int32 or tuple(ids.shape) != (rows.shape[0],) \
            or not ids.is_contiguous() or ids.device != rows.device:
        raise ValueError("ids: need contiguous int32 (M,) beside rows")
    dev = rows.device
    m_rows = rows.shape[0]
    shape = partial_shape(cfg, m_rows)
    if partial is None:
        partial = torch.empty(shape, dtype=torch.float32, device=dev)
    elif (tuple(partial.shape) != shape or partial.dtype != torch.float32
          or not partial.is_contiguous() or partial.device != dev):
        raise ValueError(f"partial: need contiguous float32 {shape} on "
                         f"{dev}")
    if boxes is not None and (
            tuple(boxes.shape) != (n_splats, 4) or boxes.dtype != torch.int32
            or not boxes.is_contiguous() or boxes.device != dev):
        raise ValueError(f"boxes: need contiguous int32 ({n_splats}, 4) on "
                         f"{dev}")
    # Every row of both outputs is written by the kernels.
    moments = torch.empty((m_rows, rd.N_MOMENTS), dtype=torch.float32,
                          device=dev)
    grads9 = torch.empty((rd.N_MOMENTS, n_splats), dtype=torch.float32,
                         device=dev)
    err = lib.gs2d_bwd_flat(
        rows.data_ptr(), ids.data_ptr(), start.data_ptr(), count.data_ptr(),
        fin.data_ptr(), gc.data_ptr(), cin.data_ptr(), tin.data_ptr(),
        fields.data_ptr(), partial.data_ptr(), moments.data_ptr(),
        grads9.data_ptr(), rr._walked_ptr(walked, cfg, dev, gy),
        0 if boxes is None else boxes.data_ptr(), n_splats, m_rows,
        cfg.height, cfg.width, cfg.tile_h, cfg.tile_w, cfg.n_tiles_x, gy,
        row_off, kc, max_chunks, cfg.cutoff_sq, cfg.min_throughput,
        cfg.splat_bounds, int(cfg.use_exp_approx), stream(rows))
    check(err, "bwd_flat kernel launch")
    launches["bwd_flat"] += 1
    return moments, grads9


# ---------------------------------------------------------------------------
# Wrappers (same contracts as the JAX package's).
# ---------------------------------------------------------------------------

def _forward_chw(binning: tlf.FlatBinning, cfg: SplatConfig, kc: int,
                 max_chunks: int, band_row0: int = 0, band_rows=None):
    args = (binning.rows, binning.start, binning.count, cfg, kc, max_chunks)
    band = dict(band_row0=band_row0, band_rows=band_rows)
    if on_card(binning.rows):
        return _fwd_flat_cuda(*args, **band)  # the launch is gs2d.fwd_flat
    with span("gs2d.fwd_flat"):
        return _fwd_flat_plain(*args, **band)


def _backward_chw(binning: tlf.FlatBinning, fin, gc, cin, tin,
                  n_splats: int, cfg: SplatConfig, kc: int, max_chunks: int,
                  params: GaussianParams, band_row0: int = 0,
                  band_rows=None) -> GaussianParams:
    fields = tl.packed_fields(params, cfg.splat_bounds)
    args = (binning.rows, binning.ids, binning.start, binning.count, fin, gc,
            cin, tin, n_splats, cfg, kc, max_chunks, band_row0, band_rows)
    if on_card(binning.rows):
        _, grads9 = _bwd_flat_cuda(*args, fields=fields)
    else:
        _, grads9 = _bwd_flat_plain(*args)
    return rd.moments_to_grads(rd.unpack_moments(grads9, n_splats), fields)


def forward_flat(binning: tlf.FlatBinning, cfg: SplatConfig, kc: int,
                 max_chunks: int, band_row0: int = 0,
                 band_rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 10: the raw padded (color (Hp, Wp, 3), T (Hp, Wp)) of a flat
    binning built with chunk ``kc`` and chunk cap ``max_chunks``; under
    band arguments (render.py) the band's rows."""
    color, trans = _forward_chw(binning, cfg, kc, max_chunks, band_row0,
                                band_rows)
    return color.permute(1, 2, 0), trans


def backward_flat(binning: tlf.FlatBinning, final_color: torch.Tensor,
                  g_color: torch.Tensor, n_splats: int, cfg: SplatConfig,
                  kc: int, max_chunks: int, params: GaussianParams,
                  carry_in=None, band_row0: int = 0,
                  band_rows=None) -> GaussianParams:
    """Kernel 11: analytic gradients from a flat binning and an upstream
    cotangent. ``final_color`` and ``g_color`` are padded (Hp, Wp, 3);
    ``carry_in`` is the (C (Hp, Wp, 3), T (Hp, Wp)) prefix entering this
    population (identity when None); under band arguments all of them are
    the band's rows."""
    band = dict(band_row0=band_row0, band_rows=band_rows)
    # The flat images are padded whole or banded: carry_planes' banded form
    # over the whole grid when there is no band.
    fin, gc, cin, tin = rd.carry_planes(
        final_color, g_color, carry_in, cfg, band_row0=band_row0,
        band_rows=cfg.n_tiles_y if band_rows is None else band_rows)
    return _backward_chw(binning, fin, gc, cin, tin, n_splats, cfg, kc,
                         max_chunks, params, **band)


def l2_render_and_grads_flat(binning: tlf.FlatBinning, ref_chw: torch.Tensor,
                             n_splats: int, cfg: SplatConfig, kc: int,
                             max_chunks: int, params: GaussianParams,
                             band_row0: int = 0, band_rows=None):
    """Flat-layout L2 train path: forward, cotangent gC = C - ref (zero on
    padding), backward, segment sum. ``ref_chw`` is the padded
    (1, 3, Hp, Wp) target; returns (color (H, W, 3), parameter grads).
    Under band arguments the binning and ``ref_chw`` are the band's and the
    colour is the raw padded band (band_rows * tile_h, Wp, 3)."""
    band = dict(band_row0=band_row0, band_rows=band_rows)
    color, _ = _forward_chw(binning, cfg, kc, max_chunks, **band)
    gc = color - ref_chw[0]
    cin, tin = rd.identity_carry(cfg, color.device, **band)
    grads = _backward_chw(binning, color, gc, cin, tin, n_splats, cfg, kc,
                          max_chunks, params, **band)
    color = color.permute(1, 2, 0)
    if band_rows is None:
        color = color[: cfg.height, : cfg.width]
    return color, grads


def l2_step_flat(params: GaussianParams, ref_chw: torch.Tensor,
                 cfg: SplatConfig):
    """One flat-layout L2 evaluation with cfg's statics: binning, kernel
    10, the cotangent, kernel 11. Returns (color (H, W, 3), grads,
    n_dropped)."""
    m_cap, kc, max_chunks = _statics(cfg)
    binning = tlf.bin_splats_flat(params, cfg, m_cap, kc=kc,
                                  max_chunks=max_chunks)
    color, grads = l2_render_and_grads_flat(binning, ref_chw, params.n, cfg,
                                            kc, max_chunks, params)
    return color, grads, binning.n_dropped


def render_flat(params: GaussianParams, cfg: SplatConfig):
    """Forward render of a population through kernel 10 (the flat branch of
    gs2d_tpu's production_render): (color (H, W, 3), n_dropped)."""
    with span("gs2d.render"):
        if params.n != cfg.n_splats:
            raise ValueError(f"params hold {params.n} splats, cfg says "
                             f"{cfg.n_splats}")
        m_cap, kc, max_chunks = _statics(cfg)
        binning = tlf.bin_splats_flat(params, cfg, m_cap, kc=kc,
                                      max_chunks=max_chunks)
        color, _ = forward_flat(binning, cfg, kc, max_chunks)
        return color[: cfg.height, : cfg.width], binning.n_dropped


# ---------------------------------------------------------------------------
# The differentiable render over the production layouts.
# ---------------------------------------------------------------------------

class _ProductionRender(torch.autograd.Function):
    """gs2d_tpu.ops.render_pallas_flat.production_render's custom VJP:
    the forward bins and renders through the layout's forward kernel and
    keeps the binning; the backward runs the layout's backward kernel under
    the upstream cotangent. The six parameter tensors are separate inputs
    (autograd tracks tensors); ``cfg`` is not differentiated."""

    @staticmethod
    def forward(ctx, pos, sx, sy, rot, color, opacity, cfg: SplatConfig):
        params = GaussianParams(pos=pos, sx=sx, sy=sy, rot=rot, color=color,
                                opacity=opacity)
        if params.n != cfg.n_splats:
            raise ValueError(f"params hold {params.n} splats, cfg says "
                             f"{cfg.n_splats}")
        layout = rd.resolve_binning(cfg)
        if layout == "flat":
            m_cap, kc, max_chunks = _statics(cfg)
            binning = tlf.bin_splats_flat(params, cfg, m_cap, kc=kc,
                                          max_chunks=max_chunks)
            fin, _ = _forward_chw(binning, cfg, kc, max_chunks)
            ctx.keep = (binning, fin)
            out = fin.permute(1, 2, 0)[: cfg.height, : cfg.width]
        elif layout == "resident":
            binning = tl.bin_splats(params, cfg, rd._max_per_tile(cfg),
                                    ids_only=True)
            table = rr.resident_table(params, cfg)
            out, _ = rr.forward_resident(binning, table, params.n, cfg)
            ctx.keep = (binning, table)
        else:
            binning = tl.bin_splats(params, cfg, rd._max_per_tile(cfg))
            out, _ = rdn.forward_tiled(binning, cfg)
            ctx.keep = (binning,)
        ctx.layout, ctx.cfg = layout, cfg
        ctx.save_for_backward(pos, sx, sy, rot, color, opacity, out)
        ctx.mark_non_differentiable(binning.n_dropped)
        return out, binning.n_dropped

    @staticmethod
    def backward(ctx, g_color, _):
        *leaves, out = ctx.saved_tensors
        params = GaussianParams(**dict(zip(FIELDS, leaves)))
        cfg, n = ctx.cfg, params.n
        g_color = g_color.contiguous()
        if ctx.layout == "flat":
            binning, fin = ctx.keep
            gc = rd.pad_ref_chw(g_color, cfg)[0]
            cin, tin = rd.identity_carry(cfg, fin.device)
            grads = _backward_chw(binning, fin, gc, cin, tin, n, cfg,
                                  cfg.flat_chunk, cfg.flat_max_chunks, params)
        elif ctx.layout == "resident":
            binning, table = ctx.keep
            grads = rr.backward_resident(binning, table, out, g_color, n, cfg)
        else:
            (binning,) = ctx.keep
            grads = rdn.backward_tiled(binning, out, g_color, n, cfg, params)
        return (*(getattr(grads, f) for f in FIELDS), None)


def production_render(params: GaussianParams, cfg: SplatConfig):
    """Differentiable render on the layout ``cfg`` resolves to, with the
    kernels' analytic backward under any upstream cotangent (the flat
    layout needs cfg.flat_capacity / flat_max_chunks set:
    tune_flat_config). Returns (color (H, W, 3), n_dropped), n_dropped the
    binning's overflow count (not differentiable)."""
    return _ProductionRender.apply(*(getattr(params, f) for f in FIELDS),
                                   cfg)
