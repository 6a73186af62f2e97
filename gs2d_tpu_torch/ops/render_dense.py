"""Dense-layout rasterizer (the counterpart of the kernel half of
``gs2d_tpu/ops/render_pallas.py``): the layout of gs2d_tpu's sharded paths,
of ``--binning dense``, and of ``--binning auto`` for small populations
whose resident table does not fit.

The dense binning (``tiles.bin_splats`` without ``ids_only``) pregathers
each tile's index-ordered list into (n_tiles, K, N_FIELDS) ``tile_params``,
padded slots holding the benign pad row. The three kernels run the
resident kernels' warp patches over the tile_params (kernel 1's step,
kernel 2's forward and kernel 3's replay); the L2 step and the replay write
one 9-moment partial per (tile, slot, pass, warp), which a tile-order patch
sum adds onto the splat axis without atomics, so runs repeat bit for bit.
They walk the same pairs in the same order with the same sums as the
one-block-per-tile chunk walk (the references ``_fwd_chunk_cuda`` and
``_bwd_chunk_cuda``), so they equal it bit for bit, and a dense fit the
resident fit.

Three kernels, each behind a wrapper that dispatches on the tensors'
device:

- ``l2_render_and_grads`` / ``l2_render_and_grads_chunked`` (Pallas kernels
  4 and 5, the fused L2 train step),
- ``forward_tiled`` (kernels 6 and 7, the forward composite) and
- ``backward_tiled`` (kernels 8 and 9, the backward replay from a carry-in
  prefix under any upstream cotangent)

launch the CUDA kernels of ``csrc/render_dense.cu`` for CUDA tensors
(raising if the launch fails) and run the plain PyTorch twins beside them
(``_l2_dense_plain`` / ``_fwd_dense_plain`` / ``_bwd_dense_plain``) for CPU
tensors. Each Pallas pair differs only in how a TPU fits a list longer
than 256 into SMEM; one CUDA kernel serves both members. Each wrapper adds
one to ``launches[<name>]`` where it launches its kernel, and nowhere else.

``_fwd_chunk_cuda`` and ``_bwd_chunk_cuda`` launch the forward and the
backward that kernels 6/7 and 8/9 had before their warp patches, kept
unchanged (``csrc/render_dense.cu`` gs2d_fwd_chunk, gs2d_bwd_chunk) as the
in-call reference of the warp-patch kernels in ``chip_smoke.py`` and the
card tests. They port no TPU kernel and no fit path reaches them; they
count under ``launches["fwd_chunk"]`` and ``launches["bwd_chunk"]``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_resident as rr
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.ops._build import check, library, on_card, stream
from gs2d_tpu_torch.params import GaussianParams
from gs2d_tpu_torch.utils.profiling import span

# Kernel launch counts since the last reset_launch_counts().
launches = {"l2_dense": 0, "fwd_dense": 0, "bwd_dense": 0, "fwd_chunk": 0,
            "bwd_chunk": 0}

# Tile shapes the CUDA kernels take: what tiles.tune_tile_height returns.
CUDA_TILE_W = 128
CUDA_TILE_HS = (32, 64)
# The TPU chunk: the L2 entry point's dispatch, and the rows the chunk
# references stage into shared memory per round.
CHUNK = 256


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _fields_of(params: GaussianParams, cfg: SplatConfig) -> torch.Tensor:
    """The (N_FIELDS, n) packed per-splat scalars for moments_to_grads: the
    expression that built the binning's tile_params."""
    return tl.packed_fields(params, cfg.splat_bounds)


def _segment9(ids, count, partial, n_splats: int) -> torch.Tensor:
    """(9, n) splat-axis sums of (n_tiles, K, 9) per-(tile, slot) partials,
    each splat's partials added in tile order (padded ids -1 dropped)."""
    n_tiles, k, _ = partial.shape
    start = torch.arange(n_tiles, device=count.device) * k
    return rd.segment_sum_plain(ids.reshape(-1), start, count,
                                partial.reshape(n_tiles * k, rd.N_MOMENTS),
                                n_splats)


def _segment_grads(binning: tl.TileBinning, partial: torch.Tensor,
                   n_splats: int) -> GaussianParams:
    """Moments on the splat axis from (n_tiles, K, 9) partials: the
    deterministic tile-order form of gs2d_tpu's scatter-add."""
    return rd.unpack_moments(
        _segment9(binning.ids, binning.count, partial, n_splats), n_splats)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the card-side reference in chip_smoke).
# ---------------------------------------------------------------------------

def _dense_walk(tile_params, count, cfg: SplatConfig, step, carry, get_t):
    """Walk every tile's list in lockstep (slot k of all tiles at once; the
    pad rows past a tile's count cover no pixel), stopping where the CUDA
    kernels' exact saturation exits may: at chunk starts, and every
    SAT_CHECK_EVERY slots at N >= SAT_WALK_THRESHOLD."""
    kc = min(CHUNK, tile_params.shape[1])
    check_every = min(kc, rd.SAT_CHECK_EVERY) if rd._sat_walk(cfg) else kc
    n_steps = int(count.max()) if count.numel() else 0
    return rd.saturating_loop(
        n_steps, lambda k, c: step(k, tile_params[:, k], c), carry, get_t,
        cfg.min_throughput, check_every)


def _fwd_dense_plain(tile_params, count, cfg: SplatConfig,
                     band_row0: int = 0, band_rows=None):
    """Plain twin of kernels 6/7: (color (3, Hp, Wp), T (Hp, Wp)), or the
    band's rows of them."""
    yy, xx, fy, fx, inside = rd.tile_coords(cfg, tile_params.device,
                                            band_row0, band_rows)
    zero = torch.zeros_like(fx)

    def step(k, r, carry):
        return rd._fwd_one(r, fx, fy, xx, yy, inside, cfg, carry)

    cr, cg, cb, T = _dense_walk(tile_params, count, cfg, step,
                                (zero, zero, zero, inside.to(torch.float32)),
                                lambda c: c[3])
    return (rd.from_tiles(torch.stack([cr, cg, cb]), cfg),
            rd.from_tiles(T[None], cfg)[0])


def _bwd_dense_plain(tile_params, ids, count, fin, gc, cin, tin,
                     n_splats: int, cfg: SplatConfig, band_row0: int = 0,
                     band_rows=None):
    """Plain twin of kernels 8/9 (and of the chunk reference) and the
    segment sum: (per-(tile, slot) partials (n_tiles, K, 9), splat moments
    (9, n)). ``fin``, ``gc`` and ``cin`` are (3, Hp, Wp), ``tin``
    (Hp, Wp), or the band's rows of them."""
    yy, xx, fy, fx, inside = rd.tile_coords(cfg, tile_params.device,
                                            band_row0, band_rows)
    gc_rgb, gf, ga = rd.cotangent_tiles(fin, gc, cin, cfg)
    n_tiles, k = ids.shape
    partial = torch.zeros((n_tiles, k, rd.N_MOMENTS),
                          dtype=tile_params.dtype, device=tile_params.device)

    def step(slot, r, carry):
        carry, col = rd._bwd_splat_step(r, fx, fy, xx, yy, inside, cfg, carry,
                                        gf, gc_rgb)
        partial[:, slot] = col
        return carry

    _dense_walk(tile_params, count, cfg, step,
                (ga, rd.to_tiles(tin[None], cfg)[0]), lambda c: c[1])
    return partial, _segment9(ids, count, partial, n_splats)


def _l2_dense_plain(tile_params, ids, count, ref_chw, n_splats: int,
                    cfg: SplatConfig, band_row0: int = 0, band_rows=None):
    """Plain twin of kernels 4/5: (color (3, Hp, Wp), partials
    (n_tiles, K, 9), splat moments (9, n)). ``ref_chw`` is the padded
    (1, 3, Hp, Wp) target, or the band's (1, 3, rows, Wp)."""
    band = dict(band_row0=band_row0, band_rows=band_rows)
    color, _ = _fwd_dense_plain(tile_params, count, cfg, **band)
    cin, tin = rd.identity_carry(cfg, color.device, **band)
    partial, grads9 = _bwd_dense_plain(tile_params, ids, count, color,
                                       color - ref_chw[0], cin, tin,
                                       n_splats, cfg, **band)
    return color, partial, grads9


# ---------------------------------------------------------------------------
# CUDA launches.
# ---------------------------------------------------------------------------

def _check_inputs(cfg: SplatConfig, tile_params, count, ids=None,
                  planes=(), gy: int = None):
    """Raise on what the kernels do not take; returns (library, K, kc).
    ``planes`` are (name, tensor) float32 images, (3, Hp, Wp) or (Hp, Wp)
    by their rank, of a launch over ``gy`` tile rows (the grid's when
    None)."""
    if cfg.tile_w != CUDA_TILE_W or cfg.tile_h not in CUDA_TILE_HS:
        raise ValueError(
            f"tile {cfg.tile_h}x{cfg.tile_w} unsupported by the dense CUDA "
            f"kernels (tile_w {CUDA_TILE_W}, tile_h in {CUDA_TILE_HS})")
    gy = gy or cfg.n_tiles_y
    n_tiles = cfg.n_tiles_x * gy
    hp, wp = gy * cfg.tile_h, cfg.padded_width
    k = tile_params.shape[1]
    want = [("tile_params", tile_params, torch.float32,
             (n_tiles, k, tl.N_FIELDS)),
            ("count", count, torch.int32, (n_tiles,))]
    if ids is not None:
        want.append(("ids", ids, torch.int32, (n_tiles, k)))
    want += [(name, t, torch.float32, (3, hp, wp)[3 - t.ndim:])
             for name, t in planes]
    for name, t, dtype, shape in want:
        if t.dtype != dtype or not t.is_contiguous() \
                or t.device != tile_params.device:
            raise ValueError(f"{name}: need contiguous {dtype} on "
                             f"{tile_params.device}, got {t.dtype} on "
                             f"{t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    return library(), k, min(CHUNK, k)


def _statics(cfg: SplatConfig, k: int, kc: int):
    """The chunk references' launch constants after the pointers and
    n_splats."""
    return (cfg.height, cfg.width, cfg.tile_h, cfg.tile_w, cfg.n_tiles_x,
            cfg.n_tiles_y, k, kc, int(rd._sat_walk(cfg)), cfg.cutoff_sq,
            cfg.min_throughput, int(cfg.use_exp_approx))


def _patch_statics(cfg: SplatConfig, k: int):
    """The warp-patch kernels' launch constants after the pointers and
    n_splats (kernel 13's, which takes no band)."""
    return (cfg.height, cfg.width, cfg.tile_h, cfg.tile_w, cfg.n_tiles_x,
            cfg.n_tiles_y, k, cfg.cutoff_sq, cfg.min_throughput,
            int(cfg.use_exp_approx))


def _band_statics(cfg: SplatConfig, k: int, gy: int, row_off: int):
    """The banded warp-patch kernels' (4/5, 6/7, 8/9) launch constants
    after the pointers and n_splats: ``gy`` tile rows from image row
    ``row_off``."""
    return (cfg.height, cfg.width, cfg.tile_h, cfg.tile_w, cfg.n_tiles_x,
            gy, row_off, k, cfg.cutoff_sq, cfg.min_throughput,
            int(cfg.use_exp_approx))


def _fwd_dense_cuda(tile_params, count, cfg: SplatConfig, walked=None,
                    band_row0: int = 0, band_rows=None):
    """Kernels 6/7 on warp patches: (color (3, Hp, Wp), T (Hp, Wp)), or
    the band's rows of them; ``walked`` gets each patch's survivors and
    the survivors walked (render_resident._walked_ptr)."""
    gy, row_off = rd.band_grid(cfg, band_row0, band_rows)
    lib, k, _ = _check_inputs(cfg, tile_params, count, gy=gy)
    color, trans = _fwd_planes(cfg, tile_params.device, gy)
    err = lib.gs2d_fwd_dense(
        tile_params.data_ptr(), count.data_ptr(), color.data_ptr(),
        trans.data_ptr(),
        rr._walked_ptr(walked, cfg, tile_params.device, gy),
        *_band_statics(cfg, k, gy, row_off), stream(tile_params))
    check(err, "fwd_dense kernel launch")
    launches["fwd_dense"] += 1
    return color, trans


def _fwd_chunk_cuda(tile_params, count, cfg: SplatConfig):
    """The forward reference (gs2d_fwd_chunk, the chunk walk 6/7 had before
    their warp patches): (color (3, Hp, Wp), T (Hp, Wp)). For chip_smoke.py
    and the card tests only."""
    lib, k, kc = _check_inputs(cfg, tile_params, count)
    color, trans = _fwd_planes(cfg, tile_params.device)
    err = lib.gs2d_fwd_chunk(
        tile_params.data_ptr(), count.data_ptr(), color.data_ptr(),
        trans.data_ptr(), *_statics(cfg, k, kc), stream(tile_params))
    check(err, "fwd_chunk kernel launch")
    launches["fwd_chunk"] += 1
    return color, trans


def _fwd_planes(cfg: SplatConfig, dev, gy: int = None):
    """The forward's outputs of ``gy`` tile rows (the grid's when None),
    uninitialised: (3, Hp, Wp) and (Hp, Wp)."""
    hp, wp = (gy or cfg.n_tiles_y) * cfg.tile_h, cfg.padded_width
    return (torch.empty((3, hp, wp), dtype=torch.float32, device=dev),
            torch.empty((hp, wp), dtype=torch.float32, device=dev))


def _bwd_dense_cuda(tile_params, ids, count, fin, gc, cin, tin,
                    n_splats: int, cfg: SplatConfig, partial=None,
                    walked=None, band_row0: int = 0, band_rows=None):
    """Kernels 8/9 on warp patches and the patch sum: (per-patch partials
    (n_tiles, K, patches per tile, 9), moments (9, n)); ``partial``,
    ``walked`` and the band as in _l2_dense_cuda (``walked`` gets each
    patch's survivors and the survivors its replay walked)."""
    gy, row_off = rd.band_grid(cfg, band_row0, band_rows)
    lib, k, _ = _check_inputs(
        cfg, tile_params, count, ids,
        (("fin", fin), ("gc", gc), ("cin", cin), ("tin", tin)), gy)
    dev = tile_params.device
    partial = rr.patch_scratch(partial, cfg, k, dev, gy=gy)
    grads9 = torch.empty((rd.N_MOMENTS, n_splats), dtype=torch.float32,
                         device=dev)
    err = lib.gs2d_bwd_dense(
        tile_params.data_ptr(), ids.data_ptr(), count.data_ptr(),
        fin.data_ptr(), gc.data_ptr(), cin.data_ptr(), tin.data_ptr(),
        partial.data_ptr(), grads9.data_ptr(),
        rr._walked_ptr(walked, cfg, dev, gy), n_splats,
        *_band_statics(cfg, k, gy, row_off), stream(tile_params))
    check(err, "bwd_dense kernel launch")
    launches["bwd_dense"] += 1
    return partial, grads9


def _bwd_chunk_cuda(tile_params, ids, count, fin, gc, cin, tin,
                    n_splats: int, cfg: SplatConfig):
    """The chunk reference (gs2d_bwd_chunk) and the segment sum:
    (per-(tile, slot) partials (n_tiles, K, 9), moments (9, n)), what
    _bwd_dense_plain returns. For chip_smoke.py and the card tests only."""
    lib, k, kc = _check_inputs(
        cfg, tile_params, count, ids,
        (("fin", fin), ("gc", gc), ("cin", cin), ("tin", tin)))
    dev = tile_params.device
    partial = torch.zeros((ids.shape[0], k, rd.N_MOMENTS),
                          dtype=torch.float32, device=dev)
    grads9 = torch.empty((rd.N_MOMENTS, n_splats), dtype=torch.float32,
                         device=dev)
    err = lib.gs2d_bwd_chunk(
        tile_params.data_ptr(), ids.data_ptr(), count.data_ptr(),
        fin.data_ptr(), gc.data_ptr(), cin.data_ptr(), tin.data_ptr(),
        partial.data_ptr(), grads9.data_ptr(), n_splats,
        *_statics(cfg, k, kc), stream(tile_params))
    check(err, "bwd_chunk kernel launch")
    launches["bwd_chunk"] += 1
    return partial, grads9


def _l2_dense_cuda(tile_params, ids, count, ref_chw, n_splats: int,
                   cfg: SplatConfig, partial=None, walked=None,
                   band_row0: int = 0, band_rows=None):
    """Kernels 4/5 on warp patches: (color (3, Hp, Wp), per-patch partials
    (n_tiles, K, patches per tile, 9), moments (9, n));
    render_resident.patch_slot_sums gives the partials per (tile, slot) as
    the plain twin returns them. ``partial`` replaces the uninitialised
    scratch (the kernel writes every entry its sum reads); ``walked`` gets
    each patch's survivor counts (render_resident._walked_ptr). Under band
    arguments ``ref_chw`` and the colour are the band's rows."""
    ref = ref_chw[0]
    gy, row_off = rd.band_grid(cfg, band_row0, band_rows)
    lib, k, _ = _check_inputs(cfg, tile_params, count, ids,
                              (("ref_chw", ref),), gy)
    dev = tile_params.device
    partial = rr.patch_scratch(partial, cfg, k, dev, gy=gy)
    color = torch.empty_like(ref)
    grads9 = torch.empty((rd.N_MOMENTS, n_splats), dtype=torch.float32,
                         device=dev)
    err = lib.gs2d_l2_dense(
        tile_params.data_ptr(), ids.data_ptr(), count.data_ptr(),
        ref.data_ptr(), color.data_ptr(), partial.data_ptr(),
        grads9.data_ptr(), rr._walked_ptr(walked, cfg, dev, gy), n_splats,
        *_band_statics(cfg, k, gy, row_off), stream(tile_params))
    check(err, "l2_dense kernel launch")
    launches["l2_dense"] += 1
    return color, partial, grads9


# ---------------------------------------------------------------------------
# Wrappers (same contracts as the JAX package's).
# ---------------------------------------------------------------------------

def _tile_params(binning: tl.TileBinning) -> torch.Tensor:
    if binning.tile_params is None:
        raise ValueError("the dense kernels need the pregathered "
                         "tile_params: bin_splats without ids_only")
    return binning.tile_params


def forward_tiled(binning: tl.TileBinning, cfg: SplatConfig,
                  crop: bool = True, band_row0: int = 0,
                  band_rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernels 6/7: (color (H, W, 3), T (H, W)) of a dense binning, or the
    padded (Hp, Wp) planes with ``crop=False`` or under band arguments
    (render.py; the band's (band_rows * tile_h, Wp) planes)."""
    tp = _tile_params(binning)
    fn = _fwd_dense_cuda if on_card(tp) else _fwd_dense_plain
    color, trans = fn(tp, binning.count, cfg, band_row0=band_row0,
                      band_rows=band_rows)
    color = color.permute(1, 2, 0)
    if crop and band_rows is None:
        return (color[: cfg.height, : cfg.width],
                trans[: cfg.height, : cfg.width])
    return color, trans


def backward_tiled(binning: tl.TileBinning, final_color: torch.Tensor,
                   g_color: torch.Tensor, n_splats: int, cfg: SplatConfig,
                   params: GaussianParams, carry_in=None,
                   band_row0: int = 0, band_rows=None) -> GaussianParams:
    """Kernels 8/9: analytic parameter gradients from a dense binning and
    an upstream cotangent. ``final_color`` and ``g_color`` are (H, W, 3);
    ``carry_in`` is the (C (H, W, 3), T (H, W)) prefix entering this
    population (identity when None); ``params`` supplies the packed fields
    moments_to_grads combines the moments with. Under band arguments the
    images are the band's, padded (render.carry_planes)."""
    tp = _tile_params(binning)
    band = dict(band_row0=band_row0, band_rows=band_rows)
    planes = rd.carry_planes(final_color, g_color, carry_in, cfg, **band)
    fn = _bwd_dense_cuda if on_card(tp) else _bwd_dense_plain
    _, grads9 = fn(tp, binning.ids, binning.count, *planes, n_splats, cfg,
                   **band)
    return rd.moments_to_grads(rd.unpack_moments(grads9, n_splats),
                               _fields_of(params, cfg))


def _l2_chw(binning: tl.TileBinning, ref_chw, n_splats: int,
            cfg: SplatConfig, params: GaussianParams, band_row0: int = 0,
            band_rows=None):
    tp = _tile_params(binning)
    fn = _l2_dense_cuda if on_card(tp) else _l2_dense_plain
    color, _, grads9 = fn(tp, binning.ids, binning.count, ref_chw, n_splats,
                          cfg, band_row0=band_row0, band_rows=band_rows)
    grads = rd.moments_to_grads(rd.unpack_moments(grads9, n_splats),
                                _fields_of(params, cfg))
    color = color.permute(1, 2, 0)
    if band_rows is None:
        color = color[: cfg.height, : cfg.width]
    return color, grads


def l2_render_and_grads(binning: tl.TileBinning, ref_chw: torch.Tensor,
                        n_splats: int, cfg: SplatConfig,
                        params: GaussianParams, band_row0: int = 0,
                        band_rows=None):
    """Fused L2 train path on a dense binning (kernel 4; K > 256 with K a
    multiple of 256 dispatches to the chunked function, as in gs2d_tpu).
    ``ref_chw`` is the padded (1, 3, Hp, Wp) target; returns (color
    (H, W, 3), parameter gradients). Under band arguments (render.py) the
    binning and ``ref_chw`` are the band's and the colour is the raw padded
    band (band_rows * tile_h, Wp, 3)."""
    k = binning.ids.shape[1]
    if k > CHUNK and k % CHUNK == 0:
        return l2_render_and_grads_chunked(binning, ref_chw, n_splats, cfg,
                                           params, chunk=CHUNK,
                                           band_row0=band_row0,
                                           band_rows=band_rows)
    return _l2_chw(binning, ref_chw, n_splats, cfg, params, band_row0,
                   band_rows)


def l2_render_and_grads_chunked(binning: tl.TileBinning,
                                ref_chw: torch.Tensor, n_splats: int,
                                cfg: SplatConfig, params: GaussianParams,
                                chunk: int = CHUNK, band_row0: int = 0,
                                band_rows=None):
    """The same for lists in chunks of ``chunk`` (kernel 5): the CUDA
    kernel walks any list in chunks, so only the capacity check differs."""
    k = binning.ids.shape[1]
    kc = min(chunk, k)
    if k % kc:
        raise ValueError(f"per-tile capacity {k} must divide by chunk {kc}")
    return _l2_chw(binning, ref_chw, n_splats, cfg, params, band_row0,
                   band_rows)


def l2_step_dense(params: GaussianParams, ref_chw: torch.Tensor,
                  cfg: SplatConfig, max_per_tile: int):
    """One dense-layout L2 evaluation: binning with the pregather + the
    fused kernel. Returns (color (H, W, 3), grads, n_dropped)."""
    binning = tl.bin_splats(params, cfg, max_per_tile)
    color, grads = l2_render_and_grads(binning, ref_chw, params.n, cfg,
                                       params)
    return color, grads, binning.n_dropped


def render(params: GaussianParams, cfg: SplatConfig) -> torch.Tensor:
    """gs2d_tpu.ops.render_pallas.render: the (H, W, 3) render of a
    population through the dense binning at cfg's per-tile capacity
    (render._max_per_tile) and kernels 6/7, differentiable through kernels
    8/9 (the dense branch of render_flat.production_render)."""
    from gs2d_tpu_torch.ops.render_flat import production_render

    return production_render(params, cfg.replace(binning="dense"))[0]


def render_dense(params: GaussianParams, cfg: SplatConfig,
                 max_per_tile: int):
    """Forward render of a population through kernels 6/7 (the dense
    branch of gs2d_tpu's production_render): (color (H, W, 3),
    n_dropped)."""
    with span("gs2d.render"):
        binning = tl.bin_splats(params, cfg, max_per_tile)
        color, _ = forward_tiled(binning, cfg)
        return color, binning.n_dropped
