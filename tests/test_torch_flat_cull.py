"""The warp-patch walk of the flat kernels 10 and 11 in plain PyTorch, on the
CPU: the cull, the per-patch saturation exit, and the splat sum over each
splat's tile box.

- ``render_resident.listed_cover_mask`` on flat runs
  (``scripts/roofline.py::flat_listed_rows``) equals the per-pixel cover of
  ``ops/render.py::_splat_terms`` gathered over each warp's 8 x 32 pixels,
  at tile heights 32 and 64, on random, extremely anisotropic and opacity-1
  populations; a row with a NaN position is kept in every patch.
- An emulation of the patch walk (each step skipped, carry kept and zeros
  added, wherever the cull drops the row or the patch has passed its
  saturation exit) gives the plain versions' colour, T and per-row moments
  bit for bit, with a carry-in and a random cotangent: the CPU evidence that
  the cull and the exit skip only exact no-ops.
- The splat sum restricted to each splat's tile box (the box the binning
  expanded, ``tiles._bbox_and_quad``), splat by splat over the box's tiles
  in ascending order, equals ``render.segment_sum_plain``, offscreen splats
  included.

Every comparison is integer or bitwise: no tolerance.
"""

import numpy as np
import pytest
import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_flat as rf
from gs2d_tpu_torch.ops import render_resident as rr
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.ops import tiles_flat as tlf
from gs2d_tpu_torch.params import params_from_numpy
from gs2d_tpu_torch.scripts.roofline import flat_listed_rows

torch.set_num_threads(1)

H, W = 72, 200  # two tile columns, the second one partly outside
ROWS = 8  # pixel rows of a warp patch (the library's gs2d_rows_per_thread)


def population(kind: str, seed: int, n: int) -> dict:
    rng = np.random.default_rng(seed)
    d = {"pos": np.stack([rng.uniform(-6, W + 6, n),
                          rng.uniform(-6, H + 6, n)], -1),
         "sx": rng.uniform(1.5, 12.0, n), "sy": rng.uniform(1.5, 12.0, n),
         "rot": rng.uniform(0.0, np.pi, n),
         "color": rng.uniform(0.0, 1.0, (n, 3)),
         "opacity": rng.uniform(0.3, 1.0, n)}
    if kind == "anisotropic":
        d["sx"] = rng.uniform(0.3, 0.8, n)
        d["sy"] = rng.uniform(30.0, 60.0, n)
    elif kind == "opacity-1":
        d["opacity"] = np.ones(n)
        d["pos"][: n // 4] = np.floor(d["pos"][: n // 4]) + 0.5
    elif kind == "opaque":  # large opaque splats: every patch saturates
        d["sx"] = rng.uniform(10.0, 40.0, n)
        d["sy"] = rng.uniform(10.0, 40.0, n)
        d["opacity"] = rng.uniform(0.9, 1.0, n)
    elif kind == "offscreen":  # a quarter far outside the image
        d["pos"][: n // 4] += np.array([3 * W, -2 * H])
    return {k: v.astype(np.float32) for k, v in d.items()}


def flat(kind, seed, n, tile_h, kc):
    cfg = SplatConfig(width=W, height=H, n_splats=n, tile_h=tile_h,
                      flat_chunk=kc, binning="flat")
    p = params_from_numpy(population(kind, seed, n), "cpu")
    cfg = rf.tune_flat_config(p, cfg)
    b = tlf.bin_splats_flat(p, cfg, cfg.flat_capacity, kc=kc,
                            max_chunks=cfg.flat_max_chunks)
    assert int(b.n_dropped) == 0
    return p, cfg, b


def any_cover(listed, count, cfg):
    """(n_tiles, patches per tile, K): some pixel of the warp's patch
    covered, per _splat_terms (live with T = 1 and the 1/256 early-out is
    cover), slots past count excluded."""
    ngrp, ncg = cfg.tile_h // ROWS, cfg.tile_w // 32
    yy, xx, fy, fx, inside = rd.tile_coords(cfg, "cpu")
    ones = torch.ones_like(fx)
    n_tiles, k = listed.shape[:2]
    out = torch.zeros((n_tiles, ngrp * ncg, k), dtype=torch.bool)
    for slot in range(k):
        live = rd._splat_terms(listed[:, slot], fx, fy, xx, yy, inside, ones,
                               cfg)[0]
        out[..., slot] = live.reshape(n_tiles, ngrp, ROWS, ncg, 32).any(
            dim=(2, 4)).reshape(n_tiles, ngrp * ncg)
    return out & (torch.arange(k)[None] < count[:, None])[:, None]


@pytest.mark.parametrize("tile_h", [32, 64])
@pytest.mark.parametrize("kind", ["random", "anisotropic", "opacity-1"])
def test_flat_mask_is_the_patches_per_pixel_cover(kind, tile_h):
    _, cfg, b = flat(kind, tile_h + 1, 160, tile_h, 32)
    listed = flat_listed_rows(b, "cpu")
    mask = rr.listed_cover_mask(listed, b.count, cfg, ROWS)
    want = any_cover(listed, b.count, cfg)
    assert mask.shape == want.shape
    assert mask.shape[1] == rr.patches_per_tile(cfg, ROWS)
    assert torch.equal(mask, want)
    # The cull is real: most listed (patch, slot) steps cover nothing.
    steps = int(b.count.sum()) * mask.shape[1]
    assert 0 < int(mask.sum()) < steps


@pytest.mark.parametrize("tile_h", [32, 64])
def test_flat_nan_position_is_kept_in_every_patch(tile_h):
    _, cfg, b = flat("random", 7, 120, tile_h, 32)
    finite = rr.listed_cover_mask(flat_listed_rows(b, "cpu"), b.count, cfg,
                                  ROWS)
    rows = b.rows.clone()
    rows[b.ids == 17, tl.FIELD_PX] = float("nan")
    listed = flat_listed_rows(b._replace(rows=rows), "cpu")
    mask = rr.listed_cover_mask(listed, b.count, cfg, ROWS)
    slot = torch.isnan(listed[..., tl.FIELD_PX])
    assert int(slot.sum()) > 0
    assert bool(mask.permute(0, 2, 1)[slot].all())
    others = ~slot[:, None, :].expand_as(mask)
    assert torch.equal(mask[others], finite[others])


# ---- the patch walk, emulated ----------------------------------------------

def patch_pixels(flags, cfg):
    """(n_tiles, patches) -> (n_tiles, tile_h, tile_w): each patch's flag on
    its 8 x 32 pixels (patch j = row group j // (tile_w / 32), column group
    j % (tile_w / 32))."""
    g, c = cfg.tile_h // ROWS, cfg.tile_w // 32
    x = flags.reshape(-1, g, 1, c, 1).expand(-1, g, ROWS, c, 32)
    return x.reshape(-1, cfg.tile_h, cfg.tile_w)


def patch_saturated(T, cfg):
    """(n_tiles, patches): no pixel of the patch keeps T >= min_throughput."""
    g, c = cfg.tile_h // ROWS, cfg.tile_w // 32
    open_ = (T >= cfg.min_throughput).reshape(-1, g, ROWS, c, 32)
    return ~open_.any(dim=(2, 4)).reshape(-1, g * c)


def patch_walk(b, cfg, kc, mc, step, carry, get_t):
    """The warp-patch walk of kernels 10 and 11 over every tile's run in
    lockstep: slot k is walked in patch j iff the cull keeps it there
    (listed_cover_mask) and j has not passed its saturation exit, the
    walked survivor after which no pixel of the patch keeps T >=
    min_throughput (a non-finite row is walked all the same). ``step(idx,
    rows, walk, carry)`` takes the flat row index of each tile's slot k (M
    past its count), those rows and the (n_tiles, tile_h, tile_w) pixels
    that walk the step; a pixel that does not keeps its carry and adds
    zeros. Returns (carry, walked steps per patch)."""
    count = b.count.clamp(max=mc * kc)
    listed = flat_listed_rows(b._replace(count=count), "cpu")
    keep = rr.listed_cover_mask(listed, count, cfg, ROWS)
    bad = ~torch.isfinite(listed[..., : tl.FIELD_OP + 1]).all(dim=-1)
    exited = torch.zeros(keep.shape[:2], dtype=torch.bool)
    walked = torch.zeros(keep.shape[:2], dtype=torch.int64)
    m = b.rows.shape[0]
    rows_ext = torch.cat([b.rows, tl.pad_row("cpu")[None]])
    for k in range(int(count.max())):
        walk = keep[..., k] & (~exited | bad[:, k, None])
        idx = torch.where(k < count, b.start + k, m).long()
        carry = step(idx, rows_ext[idx], patch_pixels(walk, cfg), carry)
        walked += walk
        exited |= walk & patch_saturated(get_t(carry), cfg)
    return carry, walked


def fwd_emulated(b, cfg, kc, mc):
    yy, xx, fy, fx, inside = rd.tile_coords(cfg, "cpu")
    zero = torch.zeros_like(fx)

    def step(idx, r, walk, carry):
        new = rd._fwd_one(r, fx, fy, xx, yy, inside, cfg, carry)
        return tuple(torch.where(walk, x, y) for x, y in zip(new, carry))

    (cr, cg, cb, T), walked = patch_walk(
        b, cfg, kc, mc, step, (zero, zero, zero, inside.to(torch.float32)),
        lambda c: c[3])
    return (rd.from_tiles(torch.stack([cr, cg, cb]), cfg),
            rd.from_tiles(T[None], cfg)[0], walked)


def bwd_emulated(b, cfg, kc, mc, fin, gc, cin, tin):
    """Per-row moments (M, 9): render._bwd_splat_step with the skipped
    pixels' carry kept and their moment terms replaced by zeros."""
    yy, xx, fy, fx, inside = rd.tile_coords(cfg, "cpu")
    gc_rgb, gf, ga = rd.cotangent_tiles(fin, gc, cin, cfg)
    moments = torch.zeros((b.rows.shape[0] + 1, rd.N_MOMENTS))

    def step(idx, r, walk, carry):
        ga, T = carry
        live, alpha, vx, vy, (cr, cg, cb) = rd._splat_terms(
            r, fx, fy, xx, yy, inside, T, cfg)
        mw = live.to(torch.float32)
        w_c = alpha * T * mw
        gcdot = gc_rgb[0] * cr + gc_rgb[1] * cg + gc_rgb[2] * cb
        ga_new = ga + w_c * gcdot
        one_minus = torch.where(alpha >= 1.0, torch.full_like(alpha, 1e-15),
                                1.0 - alpha)
        z = (T * gcdot - (gf - ga_new) * (1.0 / one_minus)) * mw * alpha
        zero = torch.zeros_like(z)
        moments[idx] = rd._moment_reduce(
            torch.where(walk, z, zero), vx[:, 0, :], vy,
            torch.where(walk, w_c, zero), gc_rgb)
        T_new = torch.where(live, T * (1.0 - alpha), T)
        return torch.where(walk, ga_new, ga), torch.where(walk, T_new, T)

    _, walked = patch_walk(b, cfg, kc, mc, step,
                           (ga, rd.to_tiles(tin[None], cfg)[0]),
                           lambda c: c[1])
    return moments[:-1], walked


@pytest.mark.parametrize("kind,tile_h,kc", [
    ("random", 32, 32), ("opacity-1", 32, 64), ("opaque", 32, 32),
    ("random", 64, 32), ("opaque", 64, 64)])
def test_patch_walk_is_the_plain_walk_bit_for_bit(kind, tile_h, kc):
    """Kernel 10's and 11's walk, emulated, against _fwd_flat_plain and
    _bwd_flat_plain: colour, T and the per-row moments equal, from a
    carry-in under a random cotangent."""
    _, cfg, b = flat(kind, tile_h + kc, 180, tile_h, kc)
    mc = cfg.flat_max_chunks
    c_p, t_p = rf._fwd_flat_plain(b.rows, b.start, b.count, cfg, kc, mc)
    c_e, t_e, walked_fwd = fwd_emulated(b, cfg, kc, mc)
    assert torch.equal(c_e, c_p) and torch.equal(t_e, t_p)

    # A prefix population's render as the carry-in.
    _, cfg_pre, b_pre = flat("random", 99, 120, tile_h, kc)
    cin, tin = rf._fwd_flat_plain(b_pre.rows, b_pre.start, b_pre.count,
                                  cfg_pre, kc, cfg_pre.flat_max_chunks)
    rng = np.random.default_rng(tile_h * kc)
    gc = torch.from_numpy(rng.normal(size=c_p.shape).astype(np.float32))
    m_p, _ = rf._bwd_flat_plain(b.rows, b.ids, b.start, b.count, c_p, gc,
                                cin, tin, cfg.n_splats, cfg, kc, mc)
    m_e, walked_bwd = bwd_emulated(b, cfg, kc, mc, c_p, gc, cin, tin)
    for x in (c_p, t_p, cin, tin, gc, m_p):
        assert torch.isfinite(x).all()
    assert torch.equal(m_e, m_p)
    # The cull and the exit leave a fraction of the (patch, slot) steps.
    keep = rr.listed_cover_mask(flat_listed_rows(b, "cpu"), b.count, cfg,
                                ROWS)
    steps = int(b.count.sum()) * keep.shape[1]
    assert int(walked_fwd.sum()) <= int(keep.sum()) < steps
    assert int(walked_bwd.sum()) <= int(keep.sum())
    if kind == "opaque":  # the exit itself cuts walked survivors
        assert int(walked_fwd.sum()) < int(keep.sum())


# ---- the tail of kernel 10's walk after its saturation exit ----------------

def tail_slots(words, s, n, k0):
    """The slots fwd_tail (csrc/patch_walk.cuh) walks in a run of n slots
    from flat row s, from chunk k0 on: each chunk's word of the int32 mask
    words as FlatRun::nonfinite forms it (two words where the run starts
    inside one, its unlisted bits cleared), and for a chunk whose word is
    not 0 the chunk's slots with a non-finite field, in slot order. The
    caller's ``bad`` (M,) decides those; the word only picks the chunk."""
    w32 = [int(x) & 0xFFFFFFFF for x in words.tolist()]
    base, bit0 = s // 32, s % 32
    chunks = []
    for k in range(k0, n, 32):
        w = base + (bit0 + k) // 32
        hi = w32[w + 1] if bit0 and n - k > 32 - bit0 else 0
        bits = ((hi << 32 | w32[w]) >> bit0) & 0xFFFFFFFF
        if n - k < 32:
            bits &= (1 << (n - k)) - 1
        if bits:
            chunks.append(k)
    return chunks


@pytest.mark.parametrize("kc", [16, 32, 64])
def test_masked_tail_walks_the_culls_non_finite_survivors(kc):
    """After a warp's exit the full cull walks the survivors that hold a
    non-finite field; the tail reads the mask words instead. For every
    tile and every chunk start, the chunks whose word is set hold every
    listed non-finite slot from there on, so the tail walks exactly those
    slots in order; and every such slot is a survivor of every patch, so
    they are the full cull's after the exit. kc 16 starts runs inside a
    word."""
    _, cfg, b = flat("random", 7 + kc, 400, 32, kc)
    rows = b.rows.clone()
    rng = np.random.default_rng(kc)
    listed = torch.nonzero(b.ids >= 0)[:, 0].numpy()
    for i, r in enumerate(rng.choice(listed, 40, replace=False)):
        rows[r, i % (tl.FIELD_OP + 1)] = (np.nan, np.inf, -np.inf)[i % 3]
    for r in rng.choice(listed, 10, replace=False):  # fields never read
        rows[r, tl.FIELD_SX + int(r) % 6] = np.nan
    bad = ~torch.isfinite(rows[:, : tl.FIELD_OP + 1]).all(dim=1)
    words = rf._nonfinite_mask_plain(rows)
    mc = cfg.flat_max_chunks
    count = b.count.clamp(max=mc * kc)
    starts = [int(x) for x in b.start]
    assert any(s % 32 for s in starts) == (kc % 32 != 0)
    for t, (s, n) in enumerate(zip(starts, count.tolist())):
        run_bad = [k for k in range(n) if bool(bad[s + k])]
        for k0 in range(0, n, 32):
            walked = [k for c in tail_slots(words, s, n, k0)
                      for k in range(c, min(c + 32, n)) if bool(bad[s + k])]
            assert walked == [k for k in run_bad if k >= k0], (t, k0)
    keep = rr.listed_cover_mask(
        flat_listed_rows(b._replace(rows=rows, count=count), "cpu"), count,
        cfg, ROWS)
    k = torch.arange(keep.shape[-1])
    row = (b.start[:, None] + k).clamp(max=rows.shape[0] - 1)
    slot_bad = bad[row] & (k < count[:, None])
    assert int(slot_bad.sum()) > 0
    assert bool(keep[slot_bad[:, None, :].expand_as(keep)].all())


# ---- the splat sum over each splat's tile box ------------------------------

def box_segment_sum(ids, start, count, moments, p, cfg):
    """(9, n): splat i's rows summed over the tiles of its tile box in
    ascending tile order, each found by a search of the tile's run (the
    splat sum of kernel 11, splat by splat)."""
    (tx0, tx1, ty0, ty1, off), _ = tl._bbox_and_quad(p, cfg)
    acc = torch.zeros((p.n, rd.N_MOMENTS))
    for i in range(p.n):
        if bool(off[i]):
            continue
        for ty in range(int(ty0[i]), int(ty1[i]) + 1):
            for tx in range(int(tx0[i]), int(tx1[i]) + 1):
                t = ty * cfg.n_tiles_x + tx
                s, c = int(start[t]), int(count[t])
                run = ids[s: s + c]
                key = torch.tensor(i, dtype=run.dtype)
                j = int(torch.searchsorted(run, key))
                if j < c and int(run[j]) == i:
                    acc[i] = acc[i] + moments[s + j]
    return acc.T.contiguous()


@pytest.mark.parametrize("kind,tile_h", [("offscreen", 32),
                                         ("anisotropic", 64)])
def test_box_segment_sum_is_the_all_tile_sum(kind, tile_h):
    p, cfg, b = flat(kind, 5 + tile_h, 150, tile_h, 32)
    rng = np.random.default_rng(tile_h)
    m = b.rows.shape[0]
    moments = torch.from_numpy(
        (rng.normal(size=(m, 9)) * 10.0 ** rng.integers(-3, 4, (m, 1)))
        .astype(np.float32))
    want = rd.segment_sum_plain(b.ids, b.start, b.count, moments, p.n)
    got = box_segment_sum(b.ids, b.start, b.count, moments, p, cfg)
    assert torch.equal(got, want)
    (tx0, tx1, ty0, ty1, off), _ = tl._bbox_and_quad(p, cfg)
    if kind == "offscreen":
        assert int(off.sum()) > 0
        assert bool((want[:, off] == 0).all())
    # Some boxes span several tiles, so the search visits more than one.
    assert bool(((tx1 > tx0) | (ty1 > ty0))[~off].any())
