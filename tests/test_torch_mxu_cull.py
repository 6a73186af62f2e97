"""The warp-patch walk of kernel 13 (the MXU-form L2 step) in plain PyTorch,
on the CPU.

- The patch cull on the dense rows (``render_resident.listed_cover_mask``,
  the spans of ``csrc/patch_walk.cuh::cull_slot``) equals the cover that
  ``render_mxu._alpha`` masks alpha with (``render_mxu._cover``: the trunc
  row and column interval, the image bounds), gathered over each warp's
  8 x 32 pixels, at tile heights 32 and 64; a splat with a NaN position is
  kept in every patch.
- An emulation of kernel 13's walk and reduction, per-pixel q and w terms
  from the plain twin's arithmetic, each lane's column sums over its 8 rows
  in row order, the x' monomials, the fixed warp tree, an exact +0.0
  partial for every slot a patch does not walk (culled, past the forward's
  saturation exit, T starting at 1 on padding as on the TPU), then the
  patch sum (per pass the warps in order from +0.0, then the passes in
  order), gives the colour and the per-(tile, slot) sums of the same
  emulation without skips (every listed slot at every pixel, the
  one-block-per-tile chunk walk's order) bit for bit: at the default fit's
  init at tile heights 32 and 64, on opaque splats whose patches saturate,
  and with a NaN splat, whose NaNs fall where the unskipped walk's do
  (once a pixel of a patch is not finite, the replay walks every later
  slot).

Every comparison is integer or bitwise: no tolerance.
"""

import pytest
import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.io.image import load_image
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_mxu as rm
from gs2d_tpu_torch.ops import render_resident as rr
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.params import init_params
from tests.test_torch_bwd_cull import nonfinite, patch_any, same_bits
from tests.test_torch_dense_cull import dense
from tests.test_torch_flat_cull import ROWS, patch_pixels, patch_saturated

torch.set_num_threads(1)

MINI = "assets/squirrel_cls_mini.npy"
NAN_SPLAT = 17


def mxu_cover(tp, count, cfg):
    """(n_tiles, patches, K): render_mxu._cover gathered over each warp's
    8 x 32 pixels, slots past count excluded."""
    coords = rd.tile_coords(cfg, "cpu")
    ngrp, ncg = cfg.tile_h // ROWS, cfg.tile_w // 32
    n_tiles, k = tp.shape[:2]
    out = torch.zeros((n_tiles, ngrp * ncg, k), dtype=torch.bool)
    for slot in range(k):
        cover = rm._cover(tp[:, slot], coords, cfg)
        out[..., slot] = cover.reshape(n_tiles, ngrp, ROWS, ncg, 32).any(
            dim=(2, 4)).reshape(n_tiles, ngrp * ncg)
    return out & (torch.arange(k)[None] < count[:, None])[:, None]


@pytest.mark.parametrize("tile_h", [32, 64])
@pytest.mark.parametrize("kind", ["random", "anisotropic", "opacity-1"])
def test_patch_cull_is_the_mxu_cover(kind, tile_h):
    cfg, b = dense(kind, tile_h + 13, 160, tile_h)
    mask = rr.listed_cover_mask(b.tile_params, b.count, cfg, ROWS)
    want = mxu_cover(b.tile_params, b.count, cfg)
    assert mask.shape == want.shape
    assert torch.equal(mask, want)
    steps = int(b.count.sum()) * mask.shape[1]
    assert 0 < int(mask.sum()) < steps


@pytest.mark.parametrize("tile_h", [32, 64])
def test_nan_position_is_kept_in_every_patch(tile_h):
    cfg, b = dense("random", 9, 120, tile_h)
    tp = b.tile_params.clone()
    tp[b.ids == NAN_SPLAT, tl.FIELD_PX] = float("nan")
    mask = rr.listed_cover_mask(tp, b.count, cfg, ROWS)
    slot = torch.isnan(tp[..., tl.FIELD_PX])
    assert int(slot.sum()) > 0
    assert bool(mask.permute(0, 2, 1)[slot].all())
    others = ~slot[:, None, :].expand_as(mask)
    assert torch.equal(mask[others], mxu_cover(tp, b.count, cfg)[others])


# ---- kernel 13's walk and reduction, emulated -------------------------------

def warp_sums(cols):
    """(n_tiles, patches, 10): the fixed-order warp tree (v += shfl_down(v,
    off) for off = 16 .. 1, lane 0's) over each 32-column group of the
    per-column sums ``cols`` (n_tiles, 10, row groups, tile_w)."""
    n_tiles, n_sums, ngrp, tw = cols.shape
    v = cols.reshape(n_tiles, n_sums, ngrp, tw // 32, 32)
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0].permute(0, 2, 3, 1).reshape(n_tiles, -1, n_sums)


def column_sums(q, w_c, gc, yp, opd, basis):
    """(n_tiles, 10, row groups, tile_w): each lane's sums over its 8 rows
    in row order, then the x' monomials: [s0 x'^2, s1 x', s2, s0 x', s1,
    s0, w gC x3, q / op]."""
    n_tiles, th, tw = q.shape
    g = th // ROWS
    rows = lambda x: x.reshape(n_tiles, g, ROWS, tw)
    terms = (rows(q), rows(q * yp), rows(q * basis[2]),
             rows(w_c * gc[0]), rows(w_c * gc[1]), rows(w_c * gc[2]),
             rows(q / opd))
    sums = [torch.zeros((n_tiles, g, tw)) for _ in terms]
    for r in range(ROWS):
        sums = [s + t[:, :, r] for s, t in zip(sums, terms)]
    s0, s1, s2, wr, wg, wb, so = sums
    xp = basis[3][0, 0]
    bxx = basis[0][0, 0]
    return torch.stack([s0 * bxx, s1 * xp, s2, s0 * xp, s1, s0, wr, wg, wb,
                        so], dim=1)


def mxu_emulated(tp, count, ref_chw, cfg, skips: bool):
    """Kernel 13 over every tile's list in lockstep: (colour (3, Hp, Wp),
    per-(tile, slot, patch) partials (n_tiles, K, patches, 10), walked
    (patch, slot) steps of the replay). With ``skips`` a patch walks slot k
    only where the kernel does: in phase 0 a survivor of the cull
    (listed_cover_mask) before the patch's saturation exit or a row with a
    non-finite field; in phase 1 the same slots, or every listed slot once
    a pixel of the patch holds a non-finite input or carry. A skipped step
    keeps the patch's carries and writes a +0.0 partial. Without ``skips``
    every listed slot is walked at every pixel."""
    coords = rd.tile_coords(cfg, "cpu")
    cx, cy, xp, yp = rm._tile_centres(cfg, "cpu")
    basis = (xp * xp, xp * yp, yp * yp, xp, yp)
    n_tiles, k_cap, _ = tp.shape
    n_steps = int(count.max())
    keep = rr.listed_cover_mask(tp, count, cfg, ROWS)
    bad = ~torch.isfinite(tp[..., : tl.FIELD_OP + 1]).all(dim=-1)
    listed = torch.arange(k_cap)[None] < count[:, None]
    n_patch = keep.shape[1]
    mt = cfg.min_throughput
    shape = (n_tiles, cfg.tile_h, cfg.tile_w)
    zero = torch.zeros(shape)

    def alpha_of(k):
        r = tp[:, k]
        return r, rm._alpha(r, rm._coefs(r, cx, cy), basis, coords, cfg)

    # ---- phase 0 ----------------------------------------------------------
    fin = [zero, zero, zero]
    T = torch.ones(shape)
    exited = torch.zeros((n_tiles, n_patch), dtype=torch.bool)
    walk_fwd = torch.zeros((n_tiles, n_patch, k_cap), dtype=torch.bool)
    for k in range(n_steps):
        walk = listed[:, k, None].expand(n_tiles, n_patch)
        if skips:
            walk = keep[..., k] & (~exited | bad[:, k, None])
        px = patch_pixels(walk, cfg)
        r, al = alpha_of(k)
        live = T >= mt
        w = torch.where(live, T * al, zero)
        fin = [torch.where(px, fin[ch] + w * r[:, tl.FIELD_CR + ch, None,
                                                  None], fin[ch])
               for ch in range(3)]
        T = torch.where(px & live, T * (1.0 - al), T)
        walk_fwd[..., k] = walk
        exited |= walk & patch_saturated(T, cfg)
    ref_t = rd.to_tiles(ref_chw[0], cfg)
    gc = [fin[ch] - ref_t[ch] for ch in range(3)]

    # ---- phase 1 ----------------------------------------------------------
    partial = torch.zeros((n_tiles, k_cap, n_patch, rm.N_SUMS))
    comp = [zero, zero, zero]
    T = torch.ones(shape)
    poisoned = patch_any(nonfinite(*fin, *gc), cfg)
    walked = torch.zeros_like(walk_fwd)
    for k in range(n_steps):
        walk = listed[:, k, None] & (poisoned | walk_fwd[..., k])
        if not skips:
            walk = listed[:, k, None].expand(n_tiles, n_patch)
        px = patch_pixels(walk, cfg)
        r, al = alpha_of(k)
        live = T >= mt
        mw = live.to(torch.float32)
        w = torch.where(live, T * al, zero)
        w_c = (al * T) * mw
        col = [r[:, tl.FIELD_CR + ch, None, None] for ch in range(3)]
        comp_new = [comp[ch] + w * col[ch] for ch in range(3)]
        inv1ma = 1.0 / torch.where(al >= 1.0, torch.full_like(al, 1e-15),
                                   1.0 - al)
        dl_da = (gc[0] * (col[0] * T - (fin[0] - comp_new[0]) * inv1ma)
                 + gc[1] * (col[1] * T - (fin[1] - comp_new[1]) * inv1ma)
                 + gc[2] * (col[2] * T - (fin[2] - comp_new[2]) * inv1ma)) \
            * mw
        q = dl_da * al
        opd = torch.maximum(r[:, tl.FIELD_OP, None, None],
                            torch.full_like(r[:, :1, None], 1e-30))
        part = warp_sums(column_sums(q, w_c, gc, yp, opd, basis))
        partial[:, k] = torch.where(walk[..., None], part,
                                    torch.zeros_like(part))
        comp = [torch.where(px, comp_new[ch], comp[ch]) for ch in range(3)]
        T = torch.where(px & live, T * (1.0 - al), T)
        walked[..., k] = walk
        poisoned |= walk & patch_any(nonfinite(*comp, T), cfg)
    return rd.from_tiles(torch.stack(fin), cfg), partial, walked


def default_init(tile_h):
    """The default fit's init (268x213, 1024 pcg3d splats) at the tile
    height, K tuned as the fit tunes it, dense binning."""
    ref = load_image(MINI)
    cfg = SplatConfig(width=ref.shape[1], height=ref.shape[0],
                      n_splats=1024, tile_h=tile_h, binning="dense")
    p = init_params(cfg, "cpu")
    cfg = tl.tune_tile_capacity(p, cfg)
    b = tl.bin_splats(p, cfg, cfg.max_splats_per_tile)
    assert int(b.n_dropped) == 0
    return cfg, b, rd.pad_ref_chw(ref, cfg, "cpu")


def small_case(kind, tile_h):
    """A 72 x 200 population at K = 256 (tests/test_torch_flat_cull.py's),
    dense binning; "nan" is the random one with a NaN position for the
    first splat of tile 0 whose row walk meets the tile's rows (its alpha
    is NaN at column 0 of those rows, where the cover of a NaN position
    falls)."""
    cfg, b = dense("random" if kind == "nan" else kind, tile_h + 17, 170,
                   tile_h)
    tp = b.tile_params
    if kind == "nan":
        py, h = tp[0, :, tl.FIELD_PY], tp[0, :, tl.FIELD_H]
        meets = ((py - h).trunc() <= tile_h - 1) & ((py + h).trunc() >= 0)
        slot = int(torch.nonzero(meets[: int(b.count[0])])[0, 0])
        tp = tp.clone()
        tp[b.ids == b.ids[0, slot], tl.FIELD_PX] = float("nan")
    ref = torch.rand((3, cfg.height, cfg.width),
                     generator=torch.Generator().manual_seed(tile_h))
    return cfg, b, tp, rd.pad_ref_chw(ref.permute(1, 2, 0), cfg, "cpu")


@pytest.mark.parametrize("case,tile_h", [("default", 32), ("default", 64),
                                         ("opaque", 32), ("nan", 32)])
def test_patch_reduction_is_the_unskipped_reduction(case, tile_h):
    if case == "default":
        cfg, b, ref_chw = default_init(tile_h)
        tp = b.tile_params
    else:
        cfg, b, tp, ref_chw = small_case(case, tile_h)
    count = b.count
    n_pass = tile_h // 32  # passes of 32 rows at tile_w 128
    c_s, part_s, walked = mxu_emulated(tp, count, ref_chw, cfg, skips=True)
    c_f, part_f, _ = mxu_emulated(tp, count, ref_chw, cfg, skips=False)
    mom_s = rr.patch_slot_sums(part_s, count, n_pass)
    mom_f = rr.patch_slot_sums(part_f, count, n_pass)
    assert same_bits(c_s, c_f)
    assert same_bits(mom_s, mom_f)
    keep = rr.listed_cover_mask(tp, count, cfg, ROWS)
    steps = int(count.sum()) * keep.shape[1]
    if case == "nan":
        assert torch.isnan(mom_f).any() and torch.isfinite(mom_f).any()
        assert int(keep.sum()) < int(walked.sum()) <= steps
        return
    assert torch.isfinite(mom_f).all() and torch.isfinite(c_f).all()
    # The skips are real: a fraction of the listed (patch, slot) steps.
    assert int(walked.sum()) <= int(keep.sum()) < steps
    if case == "opaque":  # the exit itself cuts walked survivors
        assert int(walked.sum()) < int(keep.sum())
    if case == "default":
        # The unskipped walk's colour is the plain twin's, bit for bit.
        color, _, _ = rm._l2_mxu_plain(tp, b.ids, count, ref_chw,
                                       cfg.n_splats, cfg, 256)
        assert torch.equal(c_f, color)
