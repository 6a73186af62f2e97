"""The warp-patch walk of the dense kernels 4/5 and the window kernel 12 in
plain PyTorch, on the CPU.

- ``render_resident.listed_cover_mask`` on the dense layout's rows (slot k
  of tile t at row t * K + k of the (n_tiles, K, 16) tile_params, the row
  source ``DenseRun`` of ``csrc/patch_walk.cuh``) equals the per-pixel
  cover of ``ops/render.py::_splat_terms`` gathered over each warp's 8 x 32
  pixels, at tile heights 32 and 64; a splat with a NaN position is kept in
  every patch.
- An emulation of the forward walk of kernels 6/7 (``patch_walk.cuh::
  fwd_patch`` over ``DenseRun``: a patch walks slot k where the cull keeps
  it, before its saturation exit or where the row is not finite; T starts
  at 1 inside the image, 0 on padding; a skipped step keeps the carry)
  gives ``render_dense._fwd_dense_plain``'s colour and T bit for bit at
  tile heights 32 and 64, on random, opacity-1 and opaque populations and
  with a NaN splat (equal NaN masks).
- An emulation of kernel 12's window-aware patch sum (splat i takes its
  partials only from the tiles t with bases[t] <= i < bases[t] + W, in tile
  order, each slot summed over its (pass, warp) parts as
  ``patch_sum_kernel`` sums them) over the one-block-per-tile partials of
  the plain L2 step, split into (pass, warp) parts, equals
  ``render_window._l2_window_plain``'s moments bit for bit: with a window
  that holds every id, a tuned window, and W = 128, whose escaped ids add
  nothing.

Every comparison is integer or bitwise: no tolerance.
"""

import pytest
import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.io.image import synthetic_target
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_dense as rdn
from gs2d_tpu_torch.ops import render_resident as rr
from gs2d_tpu_torch.ops import render_window as rw
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.params import params_from_numpy
from gs2d_tpu_torch.train.loop import init_train_state
from gs2d_tpu_torch.train.reorder import reorder_state
from tests.test_torch_flat_cull import (H, ROWS, W, any_cover, patch_pixels,
                                        patch_saturated, population)

torch.set_num_threads(1)


def dense(kind, seed, n, tile_h, k=256):
    cfg = SplatConfig(width=W, height=H, n_splats=n, tile_h=tile_h,
                      max_splats_per_tile=k, binning="dense")
    b = tl.bin_splats(params_from_numpy(population(kind, seed, n), "cpu"),
                      cfg, k)
    assert int(b.n_dropped) == 0
    return cfg, b


@pytest.mark.parametrize("tile_h", [32, 64])
@pytest.mark.parametrize("kind", ["random", "anisotropic", "opacity-1"])
def test_dense_mask_is_the_patches_per_pixel_cover(kind, tile_h):
    cfg, b = dense(kind, tile_h + 3, 160, tile_h)
    mask = rr.listed_cover_mask(b.tile_params, b.count, cfg, ROWS)
    want = any_cover(b.tile_params, b.count, cfg)
    assert mask.shape == want.shape
    assert mask.shape[1] == rr.patches_per_tile(cfg, ROWS)
    assert torch.equal(mask, want)
    # The cull is real: most listed (patch, slot) steps cover nothing.
    steps = int(b.count.sum()) * mask.shape[1]
    assert 0 < int(mask.sum()) < steps


@pytest.mark.parametrize("tile_h", [32, 64])
def test_dense_nan_position_is_kept_in_every_patch(tile_h):
    cfg, b = dense("random", 7, 120, tile_h)
    finite = rr.listed_cover_mask(b.tile_params, b.count, cfg, ROWS)
    tp = b.tile_params.clone()
    tp[b.ids == 17, tl.FIELD_PX] = float("nan")
    mask = rr.listed_cover_mask(tp, b.count, cfg, ROWS)
    slot = torch.isnan(tp[..., tl.FIELD_PX])
    assert int(slot.sum()) > 0
    assert bool(mask.permute(0, 2, 1)[slot].all())
    others = ~slot[:, None, :].expand_as(mask)
    assert torch.equal(mask[others], finite[others])


# ---- the forward walk of kernels 6/7, emulated ------------------------------

def fwd_emulated(tp, count, cfg):
    """Kernels 6/7's walk over the dense rows, every tile's list in
    lockstep: (colour (3, Hp, Wp), T (Hp, Wp), walked steps per patch)."""
    yy, xx, fy, fx, inside = rd.tile_coords(cfg, "cpu")
    keep = rr.listed_cover_mask(tp, count, cfg, ROWS)
    bad = ~torch.isfinite(tp[..., : tl.FIELD_OP + 1]).all(dim=-1)
    exited = torch.zeros(keep.shape[:2], dtype=torch.bool)
    walked = torch.zeros(keep.shape[:2], dtype=torch.int64)
    zero = torch.zeros_like(fx)
    carry = (zero, zero, zero, inside.to(torch.float32))
    for k in range(int(count.max())):
        walk = keep[..., k] & (~exited | bad[:, k, None])
        new = rd._fwd_one(tp[:, k], fx, fy, xx, yy, inside, cfg, carry)
        px = patch_pixels(walk, cfg)
        carry = tuple(torch.where(px, x, y) for x, y in zip(new, carry))
        walked += walk
        exited |= walk & patch_saturated(carry[3], cfg)
    cr, cg, cb, T = carry
    return (rd.from_tiles(torch.stack([cr, cg, cb]), cfg),
            rd.from_tiles(T[None], cfg)[0], walked)


def same_bits(got, want):
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)
                and torch.equal(got[~nan], want[~nan]))


@pytest.mark.parametrize("kind,tile_h", [
    ("random", 32), ("opacity-1", 32), ("opaque", 32), ("random", 64),
    ("opaque", 64), ("nan", 32), ("nan", 64)])
def test_forward_patch_walk_is_the_plain_forward(kind, tile_h):
    cfg, b = dense("random" if kind == "nan" else kind, tile_h + 23, 170,
                   tile_h)
    tp = b.tile_params
    if kind == "nan":
        tp = tp.clone()
        tp[b.ids == 17, tl.FIELD_PX] = float("nan")
    c_p, t_p = rdn._fwd_dense_plain(tp, b.count, cfg)
    c_e, t_e, walked = fwd_emulated(tp, b.count, cfg)
    assert same_bits(c_e, c_p) and same_bits(t_e, t_p)
    keep = rr.listed_cover_mask(tp, b.count, cfg, ROWS)
    steps = int(b.count.sum()) * keep.shape[1]
    assert int(walked.sum()) <= int(keep.sum()) < steps
    if kind == "nan":
        assert torch.isnan(t_p).any() and torch.isfinite(t_p).any()
    else:
        assert torch.isfinite(c_p).all() and torch.isfinite(t_p).all()
    if kind == "opaque":  # the exit itself cuts walked survivors
        assert int(walked.sum()) < int(keep.sum())


# ---- kernel 12's window-aware patch sum, emulated ---------------------------

WIN_H, WIN_W, WIN_N = 192, 256, 2048


def split_parts(partial, n_patch: int):
    """(n_tiles, K, 9) one-block-per-tile partials -> (n_tiles, K, n_patch,
    9) (pass, warp) parts that patch_sum_kernel's order adds back to them
    bit for bit: v's leading mantissa bits in pass 0's warp 0, the exact
    rest (v - hi) in the last pass's last warp, exact zeros elsewhere."""
    hi = (partial.view(torch.int32) & ~0xFFF).view(torch.float32)
    parts = torch.zeros(partial.shape[:2] + (n_patch, partial.shape[2]))
    parts[:, :, 0] = hi
    parts[:, :, n_patch - 1] = partial - hi
    return parts


def window_patch_sum(ids_s, count, bases, width: int, parts, n: int,
                     n_pass: int):
    """Kernel 12's splat-axis sum, (16, n_pad) moments: for each tile in
    order, the listed ids inside its window [bases[t], bases[t] + width)
    add their slot's patch sum (each id once per tile, so per splat the
    tiles add in order)."""
    slot = rr.patch_slot_sums(parts, count, n_pass)
    acc = torch.zeros((rw._n_pad(n), rd.N_MOMENTS))
    for t in range(ids_s.shape[0]):
        run = ids_s[t, : int(count[t])].long()
        inside = (run >= bases[t]) & (run < bases[t] + width)
        acc[run[inside]] = acc[run[inside]] + slot[t, : run.numel()][inside]
    out = torch.zeros((rd.N_GRAD_FIELDS, rw._n_pad(n)))
    out[:9] = acc.T
    return out


@pytest.mark.parametrize("tile_h,window", [
    (32, "n_pad"), (32, "tuned"), (32, "escapes"), (64, "n_pad"),
    (64, "escapes")])
def test_window_patch_sum_is_the_plain_window_sum(tile_h, window):
    """The pcg3d init of 2048 splats on 256 x 192, Morton-reordered (the
    window fit's population, cut to size; at 64-row tiles its windows tune
    to n_pad, so the tuned case runs at the fit's 32 rows)."""
    n = WIN_N
    cfg = SplatConfig(width=WIN_W, height=WIN_H, n_splats=n, tile_h=tile_h,
                      max_splats_per_tile=1024, binning="window")
    p = reorder_state(init_train_state(cfg, "cpu"), cfg).params
    width = {"n_pad": rw._n_pad(n), "escapes": 128,
             "tuned": rw.tune_window(p, cfg).window_width}[window]
    b = tl.bin_splats(p, cfg, 1024, ids_only=True)
    assert int(b.n_dropped) == 0
    table, ids_s = rr.resident_table(p, cfg), rr._remap_ids(b, n)
    ref = rd.pad_ref_chw(synthetic_target(WIN_H, WIN_W), cfg, "cpu")
    bases, escaped = rw.window_bases(b, n, width)
    _, want = rw._l2_window_plain(table, ids_s, b.count, bases, ref, n, cfg,
                                  width)
    _, partial = rr._l2_resident_partials(table, ids_s, b.count, ref, cfg)
    n_pass = tile_h // 32  # passes of 32 rows at tile_w 128
    parts = split_parts(partial, rr.patches_per_tile(cfg, ROWS))
    got = window_patch_sum(ids_s, b.count, bases, width, parts, n, n_pass)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)
    if window == "escapes":
        assert int(escaped) > 0
        # The escaped ids' partials are real: without the window they add.
        full = window_patch_sum(ids_s, b.count, bases, 2 * rw._n_pad(n),
                                parts, n, n_pass)
        assert not torch.equal(full, want)
    else:
        assert int(escaped) == 0
        assert (width < rw._n_pad(n)) == (window == "tuned")
