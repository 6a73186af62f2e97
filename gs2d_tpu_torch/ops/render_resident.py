"""Resident-table rasterizer (the counterpart of
``gs2d_tpu/ops/render_pallas_resident.py``).

Binning yields only per-tile id lists; each kernel reads the listed splats'
scalars from one packed (N+1, N_FIELDS) table whose last row is a benign pad
row (opacity 0, h = -1: it covers no pixel), so padded slots (id -1,
remapped to N) are numerical no-ops.

Three kernels, each behind a wrapper that dispatches on the tensors'
device:

- ``l2_render_and_grads_resident`` (kernel 1, the fused L2 train step),
- ``forward_resident`` (kernel 2, the forward composite) and
- ``backward_resident`` (kernel 3, the backward replay from a carry-in
  prefix under any upstream cotangent: the VJP of the differentiable
  render)

launch the CUDA kernels of ``csrc/render_resident.cu`` for CUDA tensors
(raising if the launch fails) and run the plain PyTorch twin beside them
(``_l2_resident_plain`` / ``_fwd_resident_plain`` / ``_bwd_resident_plain``)
for CPU tensors. Each wrapper adds one to ``launches[<name>]`` where it
launches its kernel, and nowhere else.

The three kernels run one warp per patch of 8 rows x 32 columns (the pixels
warp w of a one-block-per-tile pass owned), four patches a block, and each
warp walks only the slots whose splat covers a pixel of its
patch (or has a non-finite field): ``listed_cover_mask`` is that cull in
plain PyTorch, for the tests and ``chip_smoke.py``. The cull and the warp's
saturation exit skip only exact zeros, so the twins compute the kernels'
function unchanged. Nothing is staged in shared memory, so no kernel bounds
K.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.ops._build import check, library, on_card, stream
from gs2d_tpu_torch.ops.numerics import trunc_to_int
from gs2d_tpu_torch.params import GaussianParams
from gs2d_tpu_torch.utils.profiling import span

# Kernel launch counts since the last reset_launch_counts().
launches = {"l2_resident": 0, "fwd_resident": 0, "bwd_resident": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def resident_table(params: GaussianParams, cfg: SplatConfig) -> torch.Tensor:
    """((N+1) * N_FIELDS,) packed parameter rows plus the benign pad row."""
    rows = tl.packed_fields(params, cfg.splat_bounds).T
    return torch.cat([rows, tl.pad_row(rows.device)[None]]).reshape(-1)


def _table_fields(table: torch.Tensor, n_splats: int) -> torch.Tensor:
    """(N_FIELDS, n) combination coefficients for moments_to_grads,
    recovered from the packed table (bitwise the kernel's values)."""
    return table.reshape(-1, tl.N_FIELDS)[:n_splats].T


def _remap_ids(binning: tl.TileBinning, n_splats: int) -> torch.Tensor:
    """ids with -1 remapped to the benign table row N."""
    return torch.where(binning.ids >= 0, binning.ids,
                       n_splats).to(torch.int32).contiguous()


def _n_pad(n_splats: int) -> int:
    return -(-n_splats // 128) * 128


def patches_per_tile(cfg: SplatConfig, rows: int) -> int:
    """Warp patches of the resident kernels in a tile, each ``rows`` (the
    library's gs2d_rows_per_thread) x 32 pixels. Patch j is row group
    j // (tile_w / 32) and column group j % (tile_w / 32), which is warp w
    of pass p at j = p * (warps per pass) + w: the moments' sum order."""
    return (cfg.tile_h // rows) * (cfg.tile_w // 32)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the card-side reference in chip_smoke).
# ---------------------------------------------------------------------------

def _composite(table, ids_s, count, cfg: SplatConfig, coords):
    """Front-to-back composite of every tile's list: (cr, cg, cb, T) planes,
    each (n_tiles, tile_h, tile_w). Slots past a tile's count hold the pad
    row, which covers no pixel, so one loop over the longest list serves all
    tiles."""
    yy, xx, fy, fx, inside = coords
    rows = table.reshape(-1, tl.N_FIELDS)
    zero = torch.zeros_like(fx)
    carry = (zero, zero, zero, inside.to(torch.float32))
    for k in range(int(count.max()) if count.numel() else 0):
        carry = rd._fwd_one(rows[ids_s[:, k].long()], fx, fy, xx, yy, inside,
                            cfg, carry)
    return carry


def _fwd_resident_plain(table, ids_s, count, cfg: SplatConfig,
                        band_row0: int = 0, band_rows=None):
    """Plain twin of kernel 2: (color (1, 3, Hp, Wp), T (1, Hp, Wp)), or
    the band's rows of them."""
    coords = rd.tile_coords(cfg, table.device, band_row0, band_rows)
    cr, cg, cb, T = _composite(table, ids_s, count, cfg, coords)
    color = rd.from_tiles(torch.stack([cr, cg, cb]), cfg)[None]
    return color, rd.from_tiles(T[None], cfg)


def _tile_order_sum(partial, ids, n_pad: int):
    """(n_pad + 1, 9) splat-axis sums of (n_tiles, n_k, 9) per-(tile, slot)
    partials at (n_tiles, n_k) ids, row n_pad collecting what is dropped:
    one index_add_ per tile, in tile order. A tile's ids are distinct but
    for the pad row N and the dropped row, whose adds are exact zeros or
    discarded, so every splat's sum is taken in tile order on any device
    (one index_add_ over all rows adds in a varying order on CUDA)."""
    acc = torch.zeros((n_pad + 1, 9), dtype=torch.float32,
                      device=partial.device)
    for t in range(partial.shape[0]):
        acc.index_add_(0, ids[t], partial[t])
    return acc


def _replay_partials(table, ids_s, count, cfg: SplatConfig, coords, gc_rgb,
                     gf, comp):
    """The backward replay of every tile's list from the carry ``comp`` =
    (ga, T) under the cotangent planes: the (n_tiles, max count, 9)
    per-(tile, slot) partials of the one-block-per-tile walk (padded slots
    carry exactly zero)."""
    yy, xx, fy, fx, inside = coords
    rows = table.reshape(-1, tl.N_FIELDS)
    n_k = int(count.max()) if count.numel() else 0
    cols = []
    for k in range(n_k):
        comp, col = rd._bwd_splat_step(rows[ids_s[:, k].long()], fx, fy, xx,
                                       yy, inside, cfg, comp, gf, gc_rgb)
        cols.append(col)
    if not cols:
        return torch.zeros((ids_s.shape[0], 0, rd.N_MOMENTS),
                           dtype=torch.float32, device=table.device)
    return torch.stack(cols, dim=1)


def _sum_partials(partial, ids_s, n_splats: int, drop=None):
    """Moments (16, n_pad) of (n_tiles, n_k, 9) per-(tile, slot) partials:
    added onto the splat axis in tile order, padded slots landing on the
    dropped row N. Slots where the (n_tiles, K) mask ``drop`` is set add
    nothing (the window layout's escaped pairs)."""
    n_k = partial.shape[1]
    n_pad = _n_pad(n_splats)
    grads16 = torch.zeros((rd.N_GRAD_FIELDS, n_pad), dtype=torch.float32,
                          device=partial.device)
    if n_k:
        ids = ids_s[:, :n_k].long()
        if drop is not None:
            ids = torch.where(drop[:, :n_k], n_pad, ids)
        grads16[:9] = _tile_order_sum(partial, ids, n_pad)[:n_pad].T
    return grads16


def _replay_plain(table, ids_s, count, n_splats: int, cfg: SplatConfig,
                  coords, gc_rgb, gf, comp):
    """The backward replay's moments (16, n_pad): _replay_partials summed by
    _sum_partials."""
    return _sum_partials(_replay_partials(table, ids_s, count, cfg, coords,
                                          gc_rgb, gf, comp), ids_s, n_splats)


def _l2_resident_partials(table, ids_s, count, ref_chw, cfg: SplatConfig,
                          band_row0: int = 0, band_rows=None):
    """Kernel 1's function up to the splat-axis sum, in plain PyTorch:
    (color (1, 3, Hp, Wp), per-(tile, slot) partials (n_tiles, max count,
    9)) of the one-block-per-tile walk; the band's under band arguments
    (``ref_chw`` then the band's (1, 3, rows, Wp))."""
    coords = rd.tile_coords(cfg, table.device, band_row0, band_rows)
    fin_r, fin_g, fin_b, _ = _composite(table, ids_s, count, cfg, coords)
    ref_t = rd.to_tiles(ref_chw[0], cfg)
    gc = (fin_r - ref_t[0], fin_g - ref_t[1], fin_b - ref_t[2])
    gf = gc[0] * fin_r + gc[1] * fin_g + gc[2] * fin_b
    comp = (torch.zeros_like(gf), coords[4].to(torch.float32))
    partial = _replay_partials(table, ids_s, count, cfg, coords, gc, gf,
                               comp)
    color = rd.from_tiles(torch.stack([fin_r, fin_g, fin_b]), cfg)[None]
    return color, partial


def _l2_resident_plain(table, ids_s, count, ref_chw, n_splats: int,
                       cfg: SplatConfig, drop=None, band_row0: int = 0,
                       band_rows=None):
    """Plain twin of kernel 1: (color (1, 3, Hp, Wp), moments (16, n_pad));
    ``drop`` as in _sum_partials, the band as in _l2_resident_partials."""
    color, partial = _l2_resident_partials(table, ids_s, count, ref_chw, cfg,
                                           band_row0, band_rows)
    return color, _sum_partials(partial, ids_s, n_splats, drop)


def patch_cover_mask(table, ids_s, count, cfg: SplatConfig, rows: int):
    """The cull of kernels 1, 2, 3 and 12 in plain PyTorch:
    listed_cover_mask of the table rows the tiles' id lists name."""
    return listed_cover_mask(table.reshape(-1, tl.N_FIELDS)[ids_s.long()],
                             count, cfg, rows)


def listed_cover_mask(fields, count, cfg: SplatConfig, rows: int):
    """The cull of the warp-patch kernels (1-5, 8-12) in plain PyTorch,
    from each tile's listed rows ``fields`` (n_tiles, K, N_FIELDS): the
    resident table through the ids, the dense tile_params, or a flat
    binning's runs (scripts/roofline.py::flat_listed_rows). Returns
    (n_tiles, patches per tile, K) bool (patches as in patches_per_tile,
    ``rows`` high), set where
    slot k < count[t] of tile t lists a splat that covers a pixel of the
    warp's patch (some row inside the image and the splat's row walk whose
    render._row_interval meets the patch's columns inside the image:
    _splat_terms' cover, decided per row) or has a non-finite field (px, py,
    a, b, d, h, cr, cg, cb, op). Used by the tests and chip_smoke.py, never
    on the main path."""
    ncg = cfg.tile_w // 32
    n_tiles, k = fields.shape[:2]
    dev = fields.device
    f = lambda i: fields[:, None, :, i]                        # (T, 1, K)
    t = torch.arange(n_tiles, device=dev)
    ty = torch.div(t, cfg.n_tiles_x, rounding_mode="floor")
    tx = t - ty * cfg.n_tiles_x
    yy = (ty[:, None] * cfg.tile_h
          + torch.arange(cfg.tile_h, device=dev))[:, :, None]  # (T, th, 1)
    py, h = f(tl.FIELD_PY), f(tl.FIELD_H)
    row_ok = ((yy >= trunc_to_int(py - h)) & (yy <= trunc_to_int(py + h))
              & (yy < cfg.height))
    q_ok, beg_x, end_x = rd._row_interval(
        f(tl.FIELD_PX), f(tl.FIELD_A), f(tl.FIELD_B), f(tl.FIELD_D),
        yy.to(torch.float32) + 0.5 - py, cfg)
    x0 = (tx[:, None] * cfg.tile_w
          + 32 * torch.arange(ncg, device=dev))[:, None, None, :]
    x_hi = torch.clamp(x0 + 31, max=cfg.width - 1)
    meets = (torch.maximum(beg_x.long()[..., None], x0)
             <= torch.minimum(end_x.long()[..., None], x_hi))
    hit = (row_ok & q_ok)[..., None] & meets                   # (T, th, K, c)
    hit = hit.reshape(n_tiles, cfg.tile_h // rows, rows, k, ncg).any(dim=2)
    hit = hit.permute(0, 1, 3, 2).reshape(n_tiles, -1, k)
    bad = ~torch.isfinite(fields[..., : tl.FIELD_OP + 1]).all(dim=-1)
    listed = torch.arange(k, device=dev)[None] < count[:, None].to(dev)
    return (hit | bad[:, None]) & listed[:, None]


def _bwd_resident_plain(table, ids_s, count, fin, gc, cin, tin,
                        n_splats: int, cfg: SplatConfig, band_row0: int = 0,
                        band_rows=None):
    """Plain twin of kernel 3: moments (16, n_pad). ``fin``, ``gc`` and
    ``cin`` are (3, Hp, Wp), ``tin`` (Hp, Wp), or the band's rows of
    them."""
    coords = rd.tile_coords(cfg, table.device, band_row0, band_rows)
    gc_rgb, gf, ga = rd.cotangent_tiles(fin, gc, cin, cfg)
    comp = (ga, rd.to_tiles(tin[None], cfg)[0])
    return _replay_plain(table, ids_s, count, n_splats, cfg, coords, gc_rgb,
                         gf, comp)


# ---------------------------------------------------------------------------
# CUDA launches.
# ---------------------------------------------------------------------------

def _pass_rows(lib, cfg: SplatConfig) -> int:
    """Pixel rows of one pass of a tile (walk_args' sub_h)."""
    return min(cfg.tile_h, lib.gs2d_max_threads() * lib.gs2d_rows_per_thread()
               // cfg.tile_w)


def _check_inputs(cfg: SplatConfig, table, ids_s, count, k: int,
                  gy: int = None):
    """Raise on what the kernels do not take: the tile shape (tile_w a
    multiple of 32; tiles taller than one pass of max_threads x rows pixels
    are walked in passes of sub_h rows that must divide the tile) and the
    tensors of a launch over ``gy`` tile rows (the grid's when None).
    Returns the library."""
    lib = library()
    rows, max_threads = lib.gs2d_rows_per_thread(), lib.gs2d_max_threads()
    sub_h = _pass_rows(lib, cfg)
    if cfg.tile_w % 32 or sub_h <= 0 or sub_h % rows or cfg.tile_h % sub_h:
        raise ValueError(
            f"tile {cfg.tile_h}x{cfg.tile_w} unsupported by the CUDA kernels "
            f"(tile_w a multiple of 32; passes of min(tile_h, "
            f"{max_threads * rows} // tile_w) rows, a multiple of {rows} "
            "that divides tile_h)")
    n_tiles = cfg.n_tiles_x * (gy or cfg.n_tiles_y)
    for name, t, dtype, shape in (
            ("table", table, torch.float32, None),
            ("ids", ids_s, torch.int32, (n_tiles, k)),
            ("count", count, torch.int32, (n_tiles,))):
        if t.dtype != dtype or not t.is_contiguous() or not t.is_cuda:
            raise ValueError(f"{name}: need contiguous CUDA {dtype}, got "
                             f"{t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if table.device != ids_s.device or table.device != count.device:
        raise ValueError("table, ids and count must share one device")
    return lib


def _check_l2_inputs(cfg: SplatConfig, table, ids_s, count, ref_chw,
                     n_splats: int, gy: int = None):
    """_check_inputs for the fused L2 kernels (1 and 12), with the target
    and the table's row count. Returns the library."""
    lib = _check_inputs(cfg, table, ids_s, count, ids_s.shape[1], gy)
    hp, wp = (gy or cfg.n_tiles_y) * cfg.tile_h, cfg.padded_width
    if (ref_chw.shape != (1, 3, hp, wp) or ref_chw.dtype != torch.float32
            or not ref_chw.is_contiguous() or ref_chw.device != table.device):
        raise ValueError(f"ref_chw: need contiguous float32 (1, 3, {hp}, "
                         f"{wp}) on {table.device}")
    if table.numel() != (n_splats + 1) * tl.N_FIELDS:
        raise ValueError("table does not hold n_splats + 1 rows")
    return lib


def patch_rows() -> int:
    """Pixel rows of a warp patch (the library's)."""
    return library().gs2d_rows_per_thread()


def patch_passes(cfg: SplatConfig) -> int:
    """Passes of a tile in the patch partials' (pass, warp) order: the
    library's pass height is min(tile_h, max_threads * rows // tile_w)."""
    return cfg.tile_h // _pass_rows(library(), cfg)


def patch_slot_sums(partial, count, n_pass: int):
    """(n_tiles, K, 9) per-(tile, slot) sums of the warp-patch kernels'
    (n_tiles, K, patches per tile, 9) partials (kernels 1, 3, 4/5, 8/9),
    formed as patch_sum_kernel forms them (per pass a = 0 and the warps in
    index order, out = 0 and the passes in order), 0 past each tile's count
    (the kernels never write there). The slot partials of the
    one-block-per-tile chunk walk, bit for bit; for chip_smoke.py and the
    tests, never on the main path."""
    n_tiles, k, n_patch, n_mom = partial.shape
    parts = partial.reshape(n_tiles, k, n_pass, n_patch // n_pass, n_mom)
    out = torch.zeros((n_tiles, k, n_mom), dtype=partial.dtype,
                      device=partial.device)
    for ps in range(n_pass):
        a = torch.zeros_like(out)
        for w in range(parts.shape[3]):
            a = a + parts[:, :, ps, w]
        out = out + a
    listed = torch.arange(k, device=partial.device)[None] < count[:, None]
    return torch.where(listed[..., None], out, torch.zeros_like(out))


def patch_partial_shape(cfg: SplatConfig, k: int,
                        width: int = rd.N_MOMENTS,
                        gy: int = None) -> Tuple[int, ...]:
    """The per-patch partials of kernels 1, 3, 4/5, 8/9 and 12 (``width``
    9) and 13 (10 sums): (n_tiles, K, patches per tile, width), n_tiles
    those of ``gy`` tile rows (the grid's when None). Their scratch is
    uninitialised: a kernel writes every entry its sum reads (a culled or
    saturated slot's exact zero included)."""
    return (cfg.n_tiles_x * (gy or cfg.n_tiles_y), k,
            patches_per_tile(cfg, patch_rows()), width)


def patch_scratch(partial, cfg: SplatConfig, k: int, dev,
                  width: int = rd.N_MOMENTS, gy: int = None):
    """The partial scratch of a warp-patch launch: ``partial`` when given
    (a test's NaN-filled buffer), checked, else torch.empty."""
    shape = patch_partial_shape(cfg, k, width, gy)
    if partial is None:
        return torch.empty(shape, dtype=torch.float32, device=dev)
    if (tuple(partial.shape) != shape or partial.dtype != torch.float32
            or not partial.is_contiguous() or partial.device != dev):
        raise ValueError(f"partial: need contiguous float32 {shape} on "
                         f"{dev}")
    return partial


def _walked_ptr(walked, cfg: SplatConfig, dev, gy: int = None) -> int:
    """The optional (patches, 2) int32 count of survivors and walked
    survivors per patch (chip_smoke.py's) of a launch over ``gy`` tile
    rows, as a pointer (0 when None)."""
    if walked is None:
        return 0
    shape = (cfg.n_tiles_x * (gy or cfg.n_tiles_y)
             * patches_per_tile(cfg, patch_rows()), 2)
    if (tuple(walked.shape) != shape or walked.dtype != torch.int32
            or not walked.is_contiguous() or walked.device != dev):
        raise ValueError(f"walked: need contiguous int32 {shape} on {dev}")
    return walked.data_ptr()


def _l2_patches(table, ids_s, count, ref_chw, n_splats: int,
                cfg: SplatConfig, partial=None, walked=None, window=None,
                band_row0: int = 0, band_rows=None):
    """Kernel 1's launch, or with ``window`` = (bases, width) kernel 12's
    (the same patch kernel, the patch sum over each tile's window; no
    band): returns (color (1, 3, Hp, Wp), moments (16, n_pad)), or the
    band's rows of the colour. ``partial`` replaces the uninitialised
    scratch (a test's NaN-filled buffer); ``walked`` gets each patch's
    survivor counts."""
    k = ids_s.shape[1]
    gy, row_off = rd.band_grid(cfg, band_row0, band_rows)
    lib = _check_l2_inputs(cfg, table, ids_s, count, ref_chw, n_splats, gy)
    dev = table.device
    partial = patch_scratch(partial, cfg, k, dev, gy=gy)
    color = torch.empty((1, 3, gy * cfg.tile_h, cfg.padded_width),
                        dtype=torch.float32, device=dev)
    grads16 = torch.zeros((rd.N_GRAD_FIELDS, _n_pad(n_splats)),
                          dtype=torch.float32, device=dev)
    head = (table.data_ptr(), ids_s.data_ptr(), count.data_ptr())
    tail = (ref_chw.data_ptr(), color.data_ptr(), partial.data_ptr(),
            grads16.data_ptr(), _walked_ptr(walked, cfg, dev, gy), n_splats,
            _n_pad(n_splats))
    grid = (cfg.height, cfg.width, cfg.tile_h, cfg.tile_w, cfg.n_tiles_x, gy)
    statics = (k, cfg.cutoff_sq, cfg.min_throughput,
               int(cfg.use_exp_approx), stream(table))
    if window is None:
        err = lib.gs2d_l2_resident(*head, *tail, *grid, row_off, *statics)
        check(err, "l2_resident kernel launch")
    else:
        if band_rows is not None:
            raise ValueError("the window kernel takes no band")
        bases, width = window
        err = lib.gs2d_l2_window(*head, bases.data_ptr(), *tail, width,
                                 *grid, *statics)
        check(err, "l2_window kernel launch")
    return color, grads16


def _l2_resident_cuda(table, ids_s, count, ref_chw, n_splats: int,
                      cfg: SplatConfig, partial=None, walked=None,
                      band_row0: int = 0, band_rows=None):
    """Kernel 1; ``partial``, ``walked`` and the band as in _l2_patches."""
    out = _l2_patches(table, ids_s, count, ref_chw, n_splats, cfg, partial,
                      walked, band_row0=band_row0, band_rows=band_rows)
    launches["l2_resident"] += 1
    return out


def _fwd_resident_cuda(table, ids_s, count, cfg: SplatConfig, walked=None,
                       band_row0: int = 0, band_rows=None):
    """Kernel 2; ``walked`` and the band as in _l2_resident_cuda."""
    k = ids_s.shape[1]
    gy, row_off = rd.band_grid(cfg, band_row0, band_rows)
    lib = _check_inputs(cfg, table, ids_s, count, k, gy)
    dev = table.device
    hp, wp = gy * cfg.tile_h, cfg.padded_width
    color = torch.empty((1, 3, hp, wp), dtype=torch.float32, device=dev)
    trans = torch.empty((1, hp, wp), dtype=torch.float32, device=dev)
    err = lib.gs2d_fwd_resident(
        table.data_ptr(), ids_s.data_ptr(), count.data_ptr(),
        color.data_ptr(), trans.data_ptr(),
        _walked_ptr(walked, cfg, dev, gy), cfg.height, cfg.width,
        cfg.tile_h, cfg.tile_w, cfg.n_tiles_x, gy, row_off, k,
        cfg.cutoff_sq, cfg.min_throughput, int(cfg.use_exp_approx),
        stream(table))
    check(err, "fwd_resident kernel launch")
    launches["fwd_resident"] += 1
    return color, trans


def _bwd_resident_cuda(table, ids_s, count, fin, gc, cin, tin,
                       n_splats: int, cfg: SplatConfig, partial=None,
                       walked=None, band_row0: int = 0, band_rows=None):
    """Kernel 3 and the patch sum: moments (16, n_pad). ``partial``,
    ``walked`` and the band as in _l2_patches (``walked`` gets each
    patch's survivors and the survivors its replay walked)."""
    k = ids_s.shape[1]
    gy, row_off = rd.band_grid(cfg, band_row0, band_rows)
    lib = _check_inputs(cfg, table, ids_s, count, k, gy)
    hp, wp = gy * cfg.tile_h, cfg.padded_width
    for name, t, shape in (("fin", fin, (3, hp, wp)), ("gc", gc, (3, hp, wp)),
                           ("cin", cin, (3, hp, wp)), ("tin", tin, (hp, wp))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != table.device):
            raise ValueError(f"{name}: need contiguous float32 {shape} on "
                             f"{table.device}")
    if table.numel() != (n_splats + 1) * tl.N_FIELDS:
        raise ValueError("table does not hold n_splats + 1 rows")
    dev = table.device
    n_pad = _n_pad(n_splats)
    partial = patch_scratch(partial, cfg, k, dev, gy=gy)
    grads16 = torch.zeros((rd.N_GRAD_FIELDS, n_pad), dtype=torch.float32,
                          device=dev)
    err = lib.gs2d_bwd_resident(
        table.data_ptr(), ids_s.data_ptr(), count.data_ptr(), fin.data_ptr(),
        gc.data_ptr(), cin.data_ptr(), tin.data_ptr(), partial.data_ptr(),
        grads16.data_ptr(), _walked_ptr(walked, cfg, dev, gy), n_splats,
        n_pad, cfg.height, cfg.width, cfg.tile_h, cfg.tile_w, cfg.n_tiles_x,
        gy, row_off, k, cfg.cutoff_sq, cfg.min_throughput,
        int(cfg.use_exp_approx), stream(table))
    check(err, "bwd_resident kernel launch")
    launches["bwd_resident"] += 1
    return grads16


# ---------------------------------------------------------------------------
# Wrappers (same contracts as the JAX package's).
# ---------------------------------------------------------------------------

def l2_render_and_grads_resident(
    binning: tl.TileBinning,
    table: torch.Tensor,
    ref_chw: torch.Tensor,
    n_splats: int,
    cfg: SplatConfig,
    band_row0: int = 0,
    band_rows=None,
) -> Tuple[torch.Tensor, GaussianParams]:
    """Fused L2 train step on the resident table (kernel 1): returns
    (color (H, W, 3), parameter gradients). ``ref_chw`` is the padded
    (1, 3, Hp, Wp) target (render.pad_ref_chw); ``table`` is
    resident_table(params, cfg). Under band arguments (render.py) the
    binning and ``ref_chw`` are the band's and the colour is the raw padded
    band (band_rows * tile_h, Wp, 3), as gs2d_tpu returns it."""
    ids_s = _remap_ids(binning, n_splats)
    band = dict(band_row0=band_row0, band_rows=band_rows)
    if on_card(table):
        color, grads16 = _l2_resident_cuda(table, ids_s, binning.count,
                                           ref_chw, n_splats, cfg, **band)
    else:
        color, grads16 = _l2_resident_plain(table, ids_s, binning.count,
                                            ref_chw, n_splats, cfg, **band)
    grads = rd.moments_to_grads(rd.unpack_moments(grads16, n_splats),
                                _table_fields(table, n_splats))
    color = color[0].permute(1, 2, 0)
    if band_rows is None:
        color = color[: cfg.height, : cfg.width]
    return color, grads


def forward_resident(
    binning: tl.TileBinning,
    table: torch.Tensor,
    n_splats: int,
    cfg: SplatConfig,
    crop: bool = True,
    band_row0: int = 0,
    band_rows=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resident forward pass (kernel 2): (color (H, W, 3), T (H, W)),
    or the padded (Hp, Wp) planes with ``crop=False`` or under band
    arguments (the band's (band_rows * tile_h, Wp) planes)."""
    ids_s = _remap_ids(binning, n_splats)
    band = dict(band_row0=band_row0, band_rows=band_rows)
    fn = _fwd_resident_cuda if on_card(table) else _fwd_resident_plain
    color, trans = fn(table, ids_s, binning.count, cfg, **band)
    color = color[0].permute(1, 2, 0)
    trans = trans[0]
    if crop and band_rows is None:
        return (color[: cfg.height, : cfg.width],
                trans[: cfg.height, : cfg.width])
    return color, trans


def backward_resident(
    binning: tl.TileBinning,
    table: torch.Tensor,
    final_color: torch.Tensor,
    g_color: torch.Tensor,
    n_splats: int,
    cfg: SplatConfig,
    carry_in=None,
    band_row0: int = 0,
    band_rows=None,
) -> GaussianParams:
    """Resident backward pass (kernel 3): parameter gradients of a render
    under the upstream cotangent ``g_color``. ``final_color`` and
    ``g_color`` are (H, W, 3); ``carry_in`` is the (C (H, W, 3), T (H, W))
    prefix entering this population (identity when None). Under band
    arguments all of them are the band's, padded (render.carry_planes)."""
    ids_s = _remap_ids(binning, n_splats)
    band = dict(band_row0=band_row0, band_rows=band_rows)
    planes = rd.carry_planes(final_color, g_color, carry_in, cfg, **band)
    fn = _bwd_resident_cuda if on_card(table) else _bwd_resident_plain
    grads16 = fn(table, ids_s, binning.count, *planes, n_splats, cfg,
                 **band)
    return rd.moments_to_grads(rd.unpack_moments(grads16, n_splats),
                               _table_fields(table, n_splats))


def render_resident(params: GaussianParams, cfg: SplatConfig,
                    max_per_tile: int):
    """Forward render of a population through kernel 2 (the resident branch
    of gs2d_tpu's production_render): (color (H, W, 3), n_dropped)."""
    with span("gs2d.render"):
        binning = tl.bin_splats(params, cfg, max_per_tile, ids_only=True)
        color, _ = forward_resident(binning, resident_table(params, cfg),
                                    params.n, cfg)
        return color, binning.n_dropped


def l2_step_resident(params: GaussianParams, ref_chw: torch.Tensor,
                     cfg: SplatConfig, max_per_tile: int):
    """One resident-path L2 evaluation: ids-only binning + kernel 1.

    Returns (color (H, W, 3), grads, n_dropped)."""
    binning = tl.bin_splats(params, cfg, max_per_tile, ids_only=True)
    table = resident_table(params, cfg)
    color, grads = l2_render_and_grads_resident(
        binning, table, ref_chw, params.n, cfg)
    return color, grads, binning.n_dropped
