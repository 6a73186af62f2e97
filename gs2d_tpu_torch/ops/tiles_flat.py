"""Flat segmented tile binning for large splat populations (the counterpart
of ``gs2d_tpu/ops/tiles_flat.py``).

Instead of padding every tile's list to a static capacity K, the (tile,
splat) pairs live in one flat array sorted by (tile id, splat index):

    ids   (M,)    flat splat ids; tile t owns rows [start[t], start[t]+count[t])
    rows  (M, F)  pregathered per-splat scalars (tiles.packed_fields)
    start (n_tiles,) block-aligned run starts (multiples of the chunk kc)

Each run start is aligned up to kc, so a tile's chunks are whole kc-row
blocks and no block is shared by two tiles; the flat kernels
(``ops/render_flat.py``) stage one block at a time and write one moment row
per flat row. Runs are in ascending splat index (the compositing order).

Construction is an exact-count expansion (each splat owns exactly w*h rows:
one cumsum of run starts, one row gather of the per-splat values) followed
by one stable sort on the tile id alone, so stability gives the
(tile, splat) order. Every overflow (expansion, chunk cap, capacity cap) is
counted in ``n_dropped``. ``margin`` and the opacity cull's per-splat
cutoff widen and shrink the footprints as ``tiles.bin_splats`` does, and
``band_row0`` / ``band_rows`` bin one band of tile rows (tile-axis
sharding), as there.

The expansion dispatches on the device: CUDA tensors run the kernels of
``csrc/tiles_flat.cu`` (``_expand_cuda``: a per-splat count, its cumsum, one
emission of every row), integer-equal to the plain PyTorch expansion
(``_expand_plain``) that CPU tensors run; any other device raises. The sort,
the layout and the pregather are PyTorch on both.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.ops._build import check, library, on_card, stream
from gs2d_tpu_torch.params import GaussianParams
from gs2d_tpu_torch.utils.profiling import span


class FlatBinning(NamedTuple):
    """Flat (tile, splat) pair layout; see the module docstring."""

    ids: torch.Tensor        # (M,) int32, -1 on padding rows
    rows: torch.Tensor       # (M, N_FIELDS) f32 pregathered, benign padding
    start: torch.Tensor      # (n_tiles,) int32, multiples of kc
    count: torch.Tensor      # (n_tiles,) int32 live entries per tile
    n_dropped: torch.Tensor  # 0-d int32: pairs lost to capacity caps


def flat_capacity(counts, kc: int) -> int:
    """Rows needed for the block-aligned flat layout of measured counts."""
    c = np.asarray(counts)
    return int((-(-c // kc) * kc).sum())


def tune_flat_capacity(p: GaussianParams, cfg: SplatConfig, kc: int = 256,
                       margin: float = 1.5, n_bands: int = 1,
                       bin_margin: float = 0.0) -> tuple[int, int]:
    """Measure tile counts and pick (M rows, max chunks per tile) with
    ``margin`` headroom, as gs2d_tpu.ops.tiles_flat.tune_flat_capacity.
    ``bin_margin`` measures the footprints with that many pixels of slack:
    a lazily rebinned fit bins the margined superset, so its capacity is
    sized for it. ``n_bands`` > 1 sizes one band's binning under tile-axis
    sharding: the rows of the band that needs the most. Counts drift during
    fitting; overflow surfaces in n_dropped."""
    counts = tl.bin_splats(p, cfg, 1, counts_only=True,
                           margin=bin_margin).cpu().numpy()
    if n_bands > 1:
        if cfg.n_tiles_y % n_bands:
            raise ValueError(f"{cfg.n_tiles_y} tile rows not divisible by "
                             f"{n_bands} bands")
        need = max(flat_capacity(b, kc)
                   for b in counts.reshape(n_bands, -1))
    else:
        need = flat_capacity(counts, kc)
    m = max(kc, int(need * margin))
    m = -(-m // kc) * kc
    max_chunks = max(1, -(-int(int(counts.max()) * margin) // kc))
    return m, max_chunks


# The flat rows are the dense layout's pregather applied to the flat ids.
pregather_rows = tl.pregather_rows

# Launches of the expansion's emission kernel since the last
# reset_launch_counts(), one a binning on the card. Counted as the other
# kernel modules' launches are (train/graphs.launch_counters): a replay of a
# captured step adds the launches captured in it, none of those captured
# under a conditional node (the lazy rebin's; the step's ``rebinned`` aux
# counts those).
launches = {"expand_flat": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _expand_plain(p: GaussianParams, cfg: SplatConfig, m_cap: int,
                  band_row0=0, band_rows: int | None = None,
                  margin: float = 0.0):
    """The pair expansion in plain PyTorch (the CPU path, and the card-side
    reference of _expand_cuda): (tile_e, splat_e, dropped_exp), row e of
    the m_cap holding its pair's band-local tile id and splat id, or the
    dead tile n_tiles and -1; dropped_exp the 0-d int32 count of the rows
    past m_cap."""
    dev = p.device
    i32 = torch.int32
    (tx0, tx1, ty0, ty1, offscreen), (qpx, qpy, qa, qb, qd, qk2) = \
        tl._bbox_and_quad(p, cfg, margin)
    if band_rows is None:
        band_rows, band_row0 = cfg.n_tiles_y, 0
    else:
        ty0, ty1, offscreen = tl._band_clip(ty0, ty1, offscreen,
                                            band_row0, band_rows)
    n_tiles = band_rows * cfg.n_tiles_x
    w_t = (tx1 - tx0 + 1).to(i32)
    cnt = torch.where(offscreen, 0, w_t * (ty1 - ty0 + 1)).to(i32)
    starts = (torch.cumsum(cnt, 0, dtype=i32) - cnt)  # exclusive
    total = starts[-1] + cnt[-1]
    dropped_exp = (total - m_cap).clamp(min=0)

    e = torch.arange(m_cap, dtype=i32, device=dev)
    live_e = e < total
    # Owner of expansion row e: the number of later run starts at or
    # before e (the cumsum of the run-start indicator; coincident starts
    # of empty splats telescope, so empty runs are skipped).
    owner = torch.searchsorted(starts[1:].contiguous(), e, right=True)
    bits = lambda v: v.to(torch.float32).view(i32)
    chans = [starts, w_t, ty0.to(i32), tx0.to(i32)]
    if cfg.exact_cull:
        chans += [bits(qpx), bits(qpy), bits(qa), bits(qb), bits(qd)]
        if qk2 is not None:
            chans.append(bits(qk2))
    ch = torch.stack(chans, dim=1)[owner]     # one (E, C) row gather

    rank = e - ch[:, 0]
    wb = ch[:, 1].clamp(min=1)
    ly = torch.div(rank, wb, rounding_mode="floor")
    ty_e = ch[:, 2] + ly
    tx_e = ch[:, 3] + (rank - ly * wb)
    tile_e = ty_e * cfg.n_tiles_x + tx_e
    if cfg.exact_cull:
        fc = lambda i: ch[:, i].view(torch.float32)
        live_e = live_e & tl.tile_may_touch(
            fc(4), fc(5), fc(6), fc(7), fc(8), tx_e,
            ty_e + band_row0, cfg, margin,
            k2=fc(9) if qk2 is not None else None)
    tile_e = torch.where(live_e, tile_e, n_tiles)  # dead rows last
    splat_e = torch.where(live_e, owner.to(i32), -1)
    return tile_e, splat_e, dropped_exp


def _expand_cuda(p: GaussianParams, cfg: SplatConfig, m_cap: int,
                 band_row0=0, band_rows: int | None = None,
                 margin: float = 0.0):
    """_expand_plain's integers from the kernels of csrc/tiles_flat.cu: the
    per-splat count, torch.cumsum of it, the emission of every row. Takes
    an int ``band_row0``; launches on the current stream, allocates through
    PyTorch and never synchronises, so a CUDA graph captures it. The opacity
    cull's cutoff is tiles.cull_cutoff's, in plain PyTorch."""
    if band_rows is None:
        band_rows, band_row0 = cfg.n_tiles_y, 0
    n = p.n
    if n < 1 or not 0 <= m_cap < 2**31:
        raise ValueError(f"the expansion takes 1 or more splats and m_cap "
                         f"in [0, 2^31), got {n} and {m_cap}")
    fields = [p.pos, p.sx, p.sy, p.rot]
    k2 = tl.cull_cutoff(p, cfg, margin)
    if k2 is not None:
        fields.append(k2)
    for t in fields:
        if t.dtype != torch.float32 or t.device != p.device:
            raise ValueError(f"splat fields: need float32 on {p.device}, "
                             f"got {t.dtype} on {t.device}")
    pos, sx, sy, rot, *rest = [t.contiguous() for t in fields]
    k2_ptr = rest[0].data_ptr() if rest else None
    lib = library()
    dev, i32 = p.device, torch.int32
    f32 = tl._f32
    box = (n, cfg.width, cfg.height, cfg.tile_w, cfg.tile_h, cfg.n_tiles_x,
           cfg.n_tiles_y, int(band_row0), band_rows)
    bounds = f32(cfg.splat_bounds)
    # PyTorch's CUDA division by a host scalar: a product with its float32
    # reciprocal (the opacity cull's shrink).
    inv_bounds = float(np.float32(1.0) / np.float32(bounds))
    ptrs = (pos.data_ptr(), sx.data_ptr(), sy.data_ptr(), rot.data_ptr(),
            k2_ptr)
    cnt = torch.empty((n,), dtype=i32, device=dev)
    check(lib.gs2d_expand_count(*ptrs, cnt.data_ptr(), *box, bounds,
                                inv_bounds, f32(margin), stream(cnt)),
          "expand_count kernel launch")
    incl = torch.cumsum(cnt, 0, dtype=i32)
    tile_e = torch.empty((m_cap,), dtype=i32, device=dev)
    splat_e = torch.empty((m_cap,), dtype=i32, device=dev)
    dropped_exp = torch.empty((), dtype=i32, device=dev)
    limit = f32(np.float32(cfg.cutoff_sq) + np.float32(tl.CULL_ABS_MARGIN))
    check(lib.gs2d_expand_emit(
        *ptrs, incl.data_ptr(), tile_e.data_ptr(), splat_e.data_ptr(),
        dropped_exp.data_ptr(), n, m_cap, *box[1:], int(cfg.exact_cull),
        bounds, inv_bounds, f32(margin), f32(tl.CULL_REL_MARGIN),
        f32(tl.CULL_ABS_MARGIN), limit, stream(cnt)),
        "expand_emit kernel launch")
    launches["expand_flat"] += 1
    return tile_e, splat_e, dropped_exp


def expand_trig_cuda(v: torch.Tensor):
    """(cos v, sin v) of a contiguous float32 CUDA tensor as the expansion's
    kernels compute them. Verification only, as the repo keeps its
    references: the card test holds it to torch.cos / torch.sin on every
    float32; no path calls it."""
    if v.dtype != torch.float32 or not v.is_contiguous() or not v.is_cuda:
        raise ValueError("v: need contiguous float32 on the card")
    c, s = torch.empty_like(v), torch.empty_like(v)
    check(library().gs2d_expand_trig(v.data_ptr(), c.data_ptr(),
                                     s.data_ptr(), v.numel(), stream(v)),
          "expand_trig kernel launch")
    return c, s


def bin_splats_flat(
    p: GaussianParams,
    cfg: SplatConfig,
    m_cap: int,
    kc: int = 256,
    max_chunks: int | None = None,
    band_row0=0,
    band_rows: int | None = None,
    ids_only: bool = False,
    margin: float = 0.0,
) -> FlatBinning:
    """Build the flat block-aligned (tile, splat) pair layout.

    ``m_cap`` (a multiple of kc) caps the flat rows and the expansion;
    ``max_chunks`` caps one tile's run at max_chunks*kc entries. Overflow
    of either is counted in n_dropped; the expansion is exact, with no
    per-splat tile cap. ``ids_only`` returns a (1, N_FIELDS) placeholder
    for ``rows`` (the lazy-rebinning cache pregathers them every step).
    ``margin`` widens every footprint by that many pixels, and the band
    arguments bin one band of tile rows, as in ``tiles.bin_splats``."""
    with span("gs2d.bin_flat"):
        if m_cap % kc:
            raise ValueError(f"m_cap {m_cap} must be a multiple of kc {kc}")
        if max_chunks is None:
            max_chunks = m_cap // kc
        dev = p.device
        i32 = torch.int32

        with span("gs2d.bin_flat.expand"):   # exact-count pair expansion
            expand = _expand_cuda if on_card(p.pos) else _expand_plain
            tile_e, splat_e, dropped_exp = expand(p, cfg, m_cap, band_row0,
                                                  band_rows, margin)
        if band_rows is None:
            band_rows = cfg.n_tiles_y
        n_tiles = band_rows * cfg.n_tiles_x

        with span("gs2d.bin_flat.sort"):     # one stable sort by tile id
            sorted_tile, perm = torch.sort(tile_e, stable=True)
            sorted_id = splat_e[perm]
            tiles_iota = torch.arange(n_tiles, dtype=i32, device=dev)
            run_start = torch.searchsorted(sorted_tile, tiles_iota,
                                           side="left").to(i32)
            count_all = torch.searchsorted(sorted_tile, tiles_iota,
                                           side="right").to(i32) - run_start

        with span("gs2d.bin_flat.layout"):   # block-aligned flat run layout
            count = count_all.clamp(max=max_chunks * kc)
            dropped_chunks = (count_all - count).sum()
            blocks = torch.div(count + (kc - 1), kc, rounding_mode="floor")
            start_raw = (torch.cumsum(blocks, 0, dtype=i32) - blocks) * kc
            # Tiles whose run would spill past the capacity are dropped whole
            # (counted); their start is clamped to m_cap.
            fits = start_raw + blocks * kc <= m_cap
            dropped_cap = torch.where(fits, 0, count).sum()
            count = torch.where(fits, count, 0).to(i32)
            start = start_raw.clamp(max=m_cap).to(i32)

            # Scatter the sorted rows to their block-aligned flat positions.
            tch = torch.stack([run_start, count, start], dim=1)[
                sorted_tile.clamp(max=n_tiles - 1)]
            e = torch.arange(m_cap, dtype=i32, device=dev)
            rank_t = e - tch[:, 0]
            valid = (sorted_tile < n_tiles) & (rank_t < tch[:, 1])
            dest = torch.where(valid, tch[:, 2] + rank_t, m_cap).long()
            ids = torch.full((m_cap + 1,), -1, dtype=i32, device=dev)
            ids[dest] = sorted_id      # unique destinations but the trash row
            ids = ids[:m_cap]

        with span("gs2d.bin_flat.pregather"):
            rows = (torch.zeros((1, tl.N_FIELDS), dtype=torch.float32,
                                device=dev)
                    if ids_only else pregather_rows(ids, p, cfg))
        return FlatBinning(
            ids=ids, rows=rows, start=start, count=count,
            n_dropped=(dropped_exp + dropped_chunks + dropped_cap).to(i32))
