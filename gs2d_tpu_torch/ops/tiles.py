"""Tile binning: map each screen tile to its index-ordered splat list (the
counterpart of ``gs2d_tpu/ops/tiles.py``).

The screen is cut into (tile_h x tile_w)-pixel tiles and each tile gathers
the splats whose conservative bounding box (Form.pdf section 12) intersects
it and whose exact ellipse can touch it, preserving splat *index order* (the
compositing order contract, Form.pdf p2).

Binning is sort-based plain PyTorch, as the JAX package left it to XLA: one
key per (splat, slot) of a dense (N, max_tiles_per_splat) expansion, packed
as ``tile_id * N + splat_id`` in int64, so a single sort yields per-tile runs
already in splat order (the JAX package's int32 keys needed a
segment-stitching loop that the wider key makes unnecessary); run bounds
come from ``searchsorted``, so nothing synchronizes with the device.
Capacity overflow is counted in ``n_dropped``, never silently dropped.

Lazy rebinning bins with ``margin`` pixels of footprint slack, a superset of
the exact pairs that stays valid while every splat drifts less than the
margin; ``pairs_covered_by`` is the exact test of that. Opacity-adaptive
culling (``cfg.opacity_cull_alpha > 0``) shrinks each splat's binned
footprint to where its alpha can reach the threshold (a per-splat
Mahalanobis cutoff ``k2``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import geometry
from gs2d_tpu_torch.ops.numerics import log_f32, trunc_to_int
from gs2d_tpu_torch.params import GaussianParams
from gs2d_tpu_torch.utils.hardware import warn_if_untuned

# Field order in the packed per-splat parameter rows the kernels consume
# (gs2d_tpu/ops/tiles.py:36-51; the CUDA header mirrors it).
FIELD_PX = 0
FIELD_PY = 1
FIELD_A = 2      # inv_cov[0][0]
FIELD_B = 3      # inv_cov[1][0] (== [0][1])
FIELD_D = 4      # inv_cov[1][1]
FIELD_H = 5      # bbox half-height * bounds (row walk extent)
FIELD_CR = 6
FIELD_CG = 7
FIELD_CB = 8
FIELD_OP = 9
FIELD_SX = 10
FIELD_SY = 11
FIELD_COS = 12
FIELD_SIN = 13
FIELD_VALID = 14
N_FIELDS = 16


class TileBinning(NamedTuple):
    """Per-tile splat lists. The resident kernels fetch each listed splat's
    scalars from the packed table by id (ids-only binning, ``tile_params``
    None); the dense kernels read them pregathered."""

    ids: torch.Tensor        # (n_tiles, K) int32 splat ids, -1 padding
    count: torch.Tensor      # (n_tiles,) int32 live entries per tile
    n_dropped: torch.Tensor  # 0-d int32: entries lost to capacity caps
    # (n_tiles, K, N_FIELDS) float32 packed rows of the listed splats;
    # padded slots hold pad_row().
    tile_params: Optional[torch.Tensor] = None


def packed_fields(p: GaussianParams, bounds: float = 3.0) -> torch.Tensor:
    """(N_FIELDS, N) packed per-splat scalars shared by the kernels.

    ``bounds`` is the sigma cutoff of the row walk (cfg.splat_bounds)."""
    s11, s12, s22 = geometry.cov_of(p.sx, p.sy, p.rot)
    a, b, d, det = geometry.inv_cov_of(s11, s12, s22)
    h = geometry.bbox_half_height(a, det, bounds)
    f = torch.zeros((N_FIELDS, p.n), dtype=torch.float32, device=p.device)
    f[FIELD_PX] = p.pos[:, 0]
    f[FIELD_PY] = p.pos[:, 1]
    f[FIELD_A] = a
    f[FIELD_B] = b
    f[FIELD_D] = d
    f[FIELD_H] = h
    f[FIELD_CR] = p.color[:, 0]
    f[FIELD_CG] = p.color[:, 1]
    f[FIELD_CB] = p.color[:, 2]
    f[FIELD_OP] = p.opacity
    f[FIELD_SX] = p.sx
    f[FIELD_SY] = p.sy
    f[FIELD_COS] = torch.cos(p.rot)
    f[FIELD_SIN] = torch.sin(p.rot)
    f[FIELD_VALID].fill_(1.0)  # a fill kernel: no copy from the host
    return f


def pad_row(device) -> torch.Tensor:
    """The benign (N_FIELDS,) padding row: opacity 0, unit scales and
    inverse covariance (no 0/0 in any formula), h = -1 (covers no row)."""
    pad = torch.zeros((N_FIELDS,), dtype=torch.float32, device=device)
    # Fill kernels: an assigned scalar or index list would be copied from
    # the host, which a CUDA graph of the step cannot capture.
    for field in (FIELD_A, FIELD_D, FIELD_SX, FIELD_SY, FIELD_COS):
        pad[field].fill_(1.0)
    pad[FIELD_H].fill_(-1.0)
    return pad


def pregather_rows(ids: torch.Tensor, p: GaussianParams,
                   cfg: SplatConfig) -> torch.Tensor:
    """Packed per-splat scalars gathered onto ``ids`` (any shape), one
    N_FIELDS row per id; padding ids (-1) get the benign pad_row values."""
    fields_rows = packed_fields(p, cfg.splat_bounds).T
    valid = ids >= 0
    rows = fields_rows[torch.where(valid, ids, 0).long()]
    return torch.where(valid[..., None], rows, pad_row(rows.device))


def splat_tile_bbox(p: GaussianParams, cfg: SplatConfig):
    """Per-splat tile-index bbox (tx0, tx1, ty0, ty1, offscreen), clamped to
    the grid (gs2d_tpu.ops.tiles.splat_tile_bbox)."""
    return _bbox_and_quad(p, cfg)[0]


def cull_cutoff(p: GaussianParams, cfg: SplatConfig, margin: float = 0.0):
    """The opacity cull's per-splat Mahalanobis cutoff k2 (n,) of
    _bbox_and_quad, or None where cfg.opacity_cull_alpha is 0."""
    if not cfg.opacity_cull_alpha > 0.0:
        return None
    headroom = 2.0 if margin > 0 else 1.0
    return torch.minimum(
        torch.full_like(p.opacity, _f32(cfg.cutoff_sq)),
        2.0 * log_f32(torch.clamp(p.opacity, min=_f32(1e-30))
                      * _f32(headroom / cfg.opacity_cull_alpha)))


def _bbox_and_quad(p: GaussianParams, cfg: SplatConfig, margin: float = 0.0):
    """Per-splat clamped tile bbox (tx0, tx1, ty0, ty1, offscreen) plus the
    inverse-covariance quadratic (px, py, a, b, d, k2) it was derived from.

    Uses the exact covariance bbox half-extents (main.cpp:488-489) with the
    rasterizer's trunc semantics, widened by ``margin`` pixels (the
    lazy-rebinning slack). ``k2`` is the per-splat Mahalanobis cutoff: None
    (cfg.cutoff_sq) unless cfg.opacity_cull_alpha > 0, where it is
    min(cutoff_sq, 2 ln(op * headroom / alpha)), headroom 2 under a margin
    (a cached binning survives opacity growth up to 2x) and 1 otherwise;
    the half-extents shrink with sqrt(k2), and a splat with k2 <= 0 bins no
    tile. The float32 operations are gs2d_tpu.ops.tiles._bbox_and_quad's,
    in its order."""
    s11, s12, s22 = geometry.cov_of(p.sx, p.sy, p.rot)
    a, b, d, det = geometry.inv_cov_of(s11, s12, s22)
    hy = geometry.bbox_half_height(a, det, cfg.splat_bounds)
    hx = geometry.bbox_half_width(d, det, cfg.splat_bounds)
    k2 = cull_cutoff(p, cfg, margin)
    if k2 is not None:
        # The half-extents are linear in the cutoff radius sqrt(k2).
        shrink = torch.sqrt(torch.clamp(k2, min=0.0)) \
            / _f32(cfg.splat_bounds)
        hy = hy * shrink
        hx = hx * shrink
    if margin:
        hy = hy + margin
        hx = hx + margin
    px, py = p.pos[:, 0], p.pos[:, 1]
    x0 = trunc_to_int(px - hx)
    x1 = trunc_to_int(px + hx)
    y0 = trunc_to_int(py - hy)
    y1 = trunc_to_int(py + hy)

    def tile_of(v, size, n):
        # Floor division (jnp's // on negative ints), then clamp to the grid.
        return torch.div(v, size, rounding_mode="floor").clamp(0, n - 1)

    tx0 = tile_of(x0, cfg.tile_w, cfg.n_tiles_x)
    tx1 = tile_of(x1, cfg.tile_w, cfg.n_tiles_x)
    ty0 = tile_of(y0, cfg.tile_h, cfg.n_tiles_y)
    ty1 = tile_of(y1, cfg.tile_h, cfg.n_tiles_y)
    offscreen = (x1 < 0) | (x0 >= cfg.width) | (y1 < 0) | (y0 >= cfg.height)
    if k2 is not None:
        offscreen = offscreen | (k2 <= 0.0)
    return (tx0, tx1, ty0, ty1, offscreen), (px, py, a, b, d, k2)


# Fp slack of the conservative ellipse-rect test (gs2d_tpu/ops/tiles.py).
CULL_REL_MARGIN = 1e-5
CULL_ABS_MARGIN = 1e-3


def _f32(x) -> float:
    """A Python float holding exactly the float32 value of ``x``."""
    return float(np.float32(x))


def _col(v):
    """A per-splat column (None, the default k2, passes through)."""
    return None if v is None else v[:, None]


def tile_may_touch(px, py, a, b, d, tx, tyg, cfg: SplatConfig,
                   margin: float = 0.0, k2=None):
    """Conservative per-(splat, tile) test: can the splat's Mahalanobis
    ellipse reach any pixel the kernels would walk on tile (tyg, tx)?

    The exact ellipse-vs-rect minimum of gs2d_tpu.ops.tiles.tile_may_touch
    (see its docstring for the derivation), in the same float32 operation
    order. ``margin`` widens the tile rect by that many pixels on every
    side (subtracted last, as gs2d_tpu does); ``k2`` (broadcasting with the
    other inputs) replaces cfg.cutoff_sq per splat. Inputs broadcast
    elementwise; returns a bool tensor."""
    tw, th = cfg.tile_w, cfg.tile_h
    rel = _f32(CULL_REL_MARGIN)
    x_edge = (tx * tw).to(torch.float32)
    y_edge = (tyg * th).to(torch.float32)
    rx0 = x_edge - 1.0 - px
    rx1 = x_edge + float(tw) - px
    ry0 = y_edge + 0.5 - py
    ry1 = y_edge + float(th) - 0.5 - py
    if margin:
        m = _f32(margin)
        rx0, rx1, ry0, ry1 = rx0 - m, rx1 + m, ry0 - m, ry1 + m

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    def edge_vx(c):  # vx fixed at c, minimize over vy in [ry0, ry1]
        vy = clip(-b * c / d, ry0, ry1)
        t1, t2, t3 = a * c * c, 2.0 * b * c * vy, d * vy * vy
        return (t1 + t2 + t3) - rel * (t1.abs() + t2.abs() + t3.abs())

    def edge_vy(r):  # vy fixed at r, minimize over vx in [rx0, rx1]
        vx = clip(-b * r / a, rx0, rx1)
        t1, t2, t3 = a * vx * vx, 2.0 * b * vx * r, d * r * r
        return (t1 + t2 + t3) - rel * (t1.abs() + t2.abs() + t3.abs())

    qmin = torch.minimum(torch.minimum(edge_vx(rx0), edge_vx(rx1)),
                         torch.minimum(edge_vy(ry0), edge_vy(ry1)))
    center_inside = (rx0 <= 0.0) & (0.0 <= rx1) & (ry0 <= 0.0) & (0.0 <= ry1)
    healthy = (torch.isfinite(px) & torch.isfinite(py) & torch.isfinite(b)
               & (a > 0.0) & (d > 0.0)
               & torch.isfinite(a) & torch.isfinite(d))
    if k2 is None:
        # float32(k2) + float32(abs margin), rounded once in float32.
        limit = _f32(np.float32(cfg.cutoff_sq) + np.float32(CULL_ABS_MARGIN))
    else:
        limit = k2 + _f32(CULL_ABS_MARGIN)
    return (~healthy) | center_inside | (qmin <= limit)


def _band_clip(ty0, ty1, offscreen, band_row0, band_rows):
    """gs2d_tpu's band restriction of a tile bbox (tiles.py:313-317): rows
    shifted to the band of ``band_rows`` tile rows from ``band_row0`` and
    clipped to it, a splat whose bbox misses the band off screen. Returns
    (ty0, ty1, offscreen)."""
    offscreen = offscreen | (ty1 < band_row0) \
        | (ty0 > band_row0 + (band_rows - 1))
    return ((ty0 - band_row0).clamp(0, band_rows - 1),
            (ty1 - band_row0).clamp(0, band_rows - 1), offscreen)


def _slot_grid(tx0, tx1, ty0, ty1, offscreen, cap: int):
    """The (N, cap) slot grid of a bbox expansion, row-major over each
    splat's tile bbox: (tile x, tile y, live slot, untruncated count)."""
    w_t = tx1 - tx0 + 1
    count_full = torch.where(offscreen, torch.zeros_like(w_t),
                             w_t * (ty1 - ty0 + 1))
    count = count_full.clamp(max=cap)
    slot = torch.arange(cap, dtype=torch.int32, device=tx0.device)
    w1 = w_t.clamp(min=1)[:, None]
    local_y = torch.div(slot[None, :], w1, rounding_mode="floor")
    local_x = slot[None, :] - local_y * w1
    live = slot[None, :] < count[:, None]
    return tx0[:, None] + local_x, ty0[:, None] + local_y, live, count_full


def pairs_covered_by(p_now: GaussianParams, snap: GaussianParams,
                     cfg: SplatConfig, margin: float) -> torch.Tensor:
    """Is the exact current pair set still covered by the binning built
    from ``snap`` with ``margin`` px of slack? (the lazy-rebinning
    tripwire, gs2d_tpu.ops.tiles.pairs_covered_by)

    Enumerates the exact (margin 0) pairs of ``p_now`` on the
    (N, max_tiles_per_splat) slot grid and tests each live pair for
    membership in the margined footprint ``bin_splats(snap, margin=...)``
    listed: inside snap's widened tile bbox and passing snap's widened
    ellipse-rect test. Returns a 0-d bool tensor, True while the cached
    lists hold every exact pair; any current bbox truncation (count >
    max_tiles_per_splat) returns False, forcing a rebin whose n_dropped
    reports the overflow."""
    cap = cfg.max_tiles_per_splat
    (tx0, tx1, ty0, ty1, off), (px, py, a, b, d, qk2) = \
        _bbox_and_quad(p_now, cfg)
    txg, tyg, live, count_full = _slot_grid(tx0, tx1, ty0, ty1, off, cap)
    if cfg.exact_cull:
        live = live & tile_may_touch(
            px[:, None], py[:, None], a[:, None], b[:, None], d[:, None],
            txg, tyg, cfg, k2=_col(qk2))
    (mtx0, mtx1, mty0, mty1, moff), (bpx, bpy, ba, bb, bd, bk2) = \
        _bbox_and_quad(snap, cfg, margin)
    inb = (txg >= mtx0[:, None]) & (txg <= mtx1[:, None]) \
        & (tyg >= mty0[:, None]) & (tyg <= mty1[:, None]) & ~moff[:, None]
    member = inb & tile_may_touch(
        bpx[:, None], bpy[:, None], ba[:, None], bb[:, None], bd[:, None],
        txg, tyg, cfg, margin, k2=_col(bk2))
    return (~live | member).all() & (count_full <= cap).all()


def bin_splats(
    p: GaussianParams,
    cfg: SplatConfig,
    max_per_tile: int,
    max_tiles_per_splat: int | None = None,
    counts_only: bool = False,
    ids_only: bool = False,
    margin: float = 0.0,
    band_row0: int = 0,
    band_rows: int | None = None,
):
    """Build the per-tile splat lists (index order preserved within a tile).

    ``max_tiles_per_splat`` caps the expansion per splat (a splat covering
    more tiles gets its bbox truncated row-major; counted in n_dropped).
    ``band_row0`` / ``band_rows`` bin only the band of that many tile rows
    from that tile row, the unit of tile-axis sharding: tile ids are
    band-local, a splat's bbox rows are clipped to the band, and a splat
    whose bbox misses the band bins no tile (off screen, not dropped).
    ``counts_only`` returns just the *untruncated* per-tile counts
    (n_tiles,) int32, for tuning the capacity. ``ids_only`` skips the
    pregathered (n_tiles, K, N_FIELDS) ``tile_params`` of the dense layout
    (``pregather_rows`` of the ids). ``margin`` widens every footprint
    (bbox and cull rect) by that many pixels: a superset of the exact
    pairs, whose extra pairs cover no pixel, for lazy rebinning."""
    n = p.n
    dev = p.device
    cap = max_tiles_per_splat or cfg.max_tiles_per_splat
    (tx0, tx1, ty0, ty1, offscreen), (px, py, qa, qb, qd, qk2) = \
        _bbox_and_quad(p, cfg, margin)
    if band_rows is None:
        band_rows, band_row0 = cfg.n_tiles_y, 0
    else:
        ty0, ty1, offscreen = _band_clip(ty0, ty1, offscreen, band_row0,
                                         band_rows)
    n_tiles = band_rows * cfg.n_tiles_x
    txg, tyg, live, count_full = _slot_grid(tx0, tx1, ty0, ty1, offscreen,
                                            cap)
    dropped_bbox = (count_full - count_full.clamp(max=cap)).sum()
    if cfg.exact_cull:
        # Drop bbox tiles the ellipse provably cannot touch: exact removals,
        # not capacity drops, so n_dropped is unaffected. The test takes
        # image tile rows.
        live = live & tile_may_touch(
            px[:, None], py[:, None], qa[:, None], qb[:, None], qd[:, None],
            txg, tyg + band_row0, cfg, margin, k2=_col(qk2))

    # One int64 key per (splat, slot): tile in the high part, splat id in
    # the low part; dead slots get the key of the virtual tile n_tiles and
    # sort to the end.
    tile_id = (tyg * cfg.n_tiles_x + txg).to(torch.int64)
    splat_id = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    key = torch.where(live, tile_id, n_tiles) * n + splat_id
    sorted_key, _ = torch.sort(key.reshape(-1))
    sorted_tile = torch.div(sorted_key, n, rounding_mode="floor")
    tiles_iota = torch.arange(n_tiles, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(sorted_tile, tiles_iota, side="left")
    ends = torch.searchsorted(sorted_tile, tiles_iota, side="right")
    tile_count_full = (ends - starts).to(torch.int32)
    if counts_only:
        return tile_count_full
    tile_count = tile_count_full.clamp(max=max_per_tile)
    dropped_tile = (tile_count_full - tile_count).sum()

    k = torch.arange(max_per_tile, dtype=torch.int64, device=dev)
    valid = k[None, :] < tile_count[:, None]
    gidx = torch.where(valid, starts[:, None] + k[None, :], 0)
    sorted_splat = sorted_key - sorted_tile * n
    ids = torch.where(valid, sorted_splat[gidx], -1).to(torch.int32)
    return TileBinning(
        ids=ids,
        count=tile_count,
        n_dropped=(dropped_bbox + dropped_tile).to(torch.int32),
        tile_params=None if ids_only else pregather_rows(ids, p, cfg),
    )


# gs2d_tpu's tile-height policy (gs2d_tpu/ops/tiles.py:462-531), copied so
# both packages pick the same tiles; its breakpoints were measured on a TPU
# and say nothing about the card. A Hopper tile shape is a later, measured
# change (ROADMAP.md queue 2, "8x8 patches, and smaller tiles").
PRODUCTION_TILE_H = 32
DEEP_TILE_H = 64
DEEP_TILE_THRESHOLD = 2500.0  # mean (splat, tile) pairs per 32-row tile
TALL_TILE_MIN_SPAN = 1.5      # mean bbox span in 32-row tiles


def tune_tile_height(cfg: SplatConfig,
                     p: GaussianParams | None = None) -> SplatConfig:
    """32-row tiles, or 64 when the population ``p`` is deep (mean pairs per
    32-row tile above DEEP_TILE_THRESHOLD) and tall (mean vertical span
    above TALL_TILE_MIN_SPAN tiles); the float32 arithmetic of
    gs2d_tpu.ops.tiles.tune_tile_height. Callers honouring an explicit
    tile height skip it."""
    cfg32 = cfg.replace(tile_h=PRODUCTION_TILE_H)
    if p is None:
        return cfg32
    warn_if_untuned()  # the breakpoints come from a v5e sweep
    tx0, tx1, ty0, ty1, off = splat_tile_bbox(p, cfg32)
    h_t = ty1 - ty0 + 1
    live = ~off
    zero = torch.zeros_like(h_t)
    pairs = torch.where(live, (tx1 - tx0 + 1) * h_t, zero).sum()
    n_live = live.to(torch.int32).sum().clamp(min=1)
    depth = float(pairs.to(torch.float32)
                  / _f32(cfg32.n_tiles_x * cfg32.n_tiles_y))
    span = float(torch.where(live, h_t, zero).sum().to(torch.float32)
                 / n_live.to(torch.float32))
    if span > TALL_TILE_MIN_SPAN and depth > DEEP_TILE_THRESHOLD:
        return cfg.replace(tile_h=DEEP_TILE_H)
    return cfg32


def tune_max_tiles_per_splat(p: GaussianParams, cfg: SplatConfig,
                             margin: float = 2.0) -> SplatConfig:
    """Size the per-splat tile cap from the *measured* bbox coverage (the
    footprints widened by cfg.rebin_margin, which the lazy cache bins): the
    largest per-splat tile count times ``margin``, rounded up to a power of
    two (at least 4) and clamped to the whole grid."""
    tx0, tx1, ty0, ty1, offscreen = _bbox_and_quad(
        p, cfg, cfg.rebin_margin)[0]
    cover = torch.where(offscreen, torch.zeros_like(tx0),
                        (tx1 - tx0 + 1) * (ty1 - ty0 + 1))
    m = int(cover.max())
    cap = 1 << max(2, (max(1, int(m * margin)) - 1).bit_length())
    return cfg.replace(max_tiles_per_splat=min(
        cap, cfg.n_tiles_x * cfg.n_tiles_y))


def tune_rebin_margin(p: GaussianParams, cfg: SplatConfig,
                      candidates: tuple = (2.0, 1.0),
                      max_inflation: float = 0.30) -> SplatConfig:
    """Pick the lazy-rebinning slack from the measured pair inflation
    (gs2d_tpu.ops.tiles.tune_rebin_margin; the CLI's --rebin-margin -1):
    the largest candidate whose total pair count stays within
    ``max_inflation`` of the exact one, else 0 (rebin every step)."""
    base = int(bin_splats(p, cfg, 1, counts_only=True).sum())
    for m in sorted(candidates, reverse=True):
        n = int(bin_splats(p, cfg, 1, counts_only=True, margin=m).sum())
        if base == 0 or n <= base * (1.0 + max_inflation):
            return cfg.replace(rebin_margin=float(m))
    return cfg.replace(rebin_margin=0.0)


def tune_tile_capacity(p: GaussianParams, cfg: SplatConfig,
                       margin: float = 1.5, chunk: int = 256) -> SplatConfig:
    """Pick the static per-tile capacity K from the *measured* tile counts:
    max * margin, a multiple of 64 up to 256 and of ``chunk`` above. Also
    right-sizes ``max_tiles_per_splat`` from the same population. Counts
    drift during fitting; overflow surfaces in n_dropped."""
    cfg = tune_max_tiles_per_splat(p, cfg)
    counts = bin_splats(p, cfg, 1, counts_only=True, margin=cfg.rebin_margin)
    m = int(counts.max())
    k = max(64, int(m * margin))
    if k <= 256:
        k = -(-k // 64) * 64
    else:
        k = -(-k // chunk) * chunk
    return cfg.replace(max_splats_per_tile=k)
