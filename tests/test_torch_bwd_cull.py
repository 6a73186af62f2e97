"""The warp-patch replay of kernels 3 (resident backward) and 8/9 (dense
backward) in plain PyTorch, on the CPU.

The two kernels replay each 8 x 32 patch from the carry-in planes under an
upstream cotangent (``csrc/patch_walk.cuh::replay_patch``): a warp walks a
listed slot only where the cull keeps it (``listed_cover_mask`` of the rows
the layout lists: the resident table through the ids, or the dense
tile_params), stops after the survivor at which no pixel of its patch keeps
T >= min_throughput on its own replayed T (walking only the non-finite
survivors after it), and walks every later slot once a pixel's cotangent or
carry is not finite. An emulation of that walk (a skipped step keeps the
patch's carry and adds zeros) gives per-(tile, slot) partials; split into
(pass, warp) parts that ``patch_sum_kernel``'s order adds back exactly and
summed in that order (tests/test_torch_dense_cull.py's ``split_parts`` and
``window_patch_sum`` at a window that holds every id), they equal
``_bwd_resident_plain``'s and ``_bwd_dense_plain``'s moments bit for bit,
and the plain partial of every slot that no patch walks is exactly zero:
the CPU evidence that the cull and the exit skip only exact no-ops. Cases:
random, opacity-1 and opaque populations at 32- and 64-row tiles, from a
carry-in under a random cotangent; a NaN splat, walked in every patch,
whose NaNs fall where the plain versions' do. Walked steps <= survivors <=
listed (patch, slot) steps, and in the opaque case the exit cuts
survivors.

Every comparison above is integer or bitwise. One case holds the emulated
kernel-3 gradients against gs2d_tpu's ``backward_resident`` (its Pallas
kernel in interpret mode) at atol 1e-4 * max(1, |g| max) per field, the
tolerance tests/test_torch_ssim.py holds the plain kernel 3 to (float32
sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.ops import render_pallas_resident as jrr
from gs2d_tpu.ops import tiles as jtl
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_dense as rdn
from gs2d_tpu_torch.ops import render_resident as rr
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.params import FIELDS, params_from_numpy
from tests.helpers import random_splats, to_params
from tests.test_torch_dense_cull import split_parts, window_patch_sum
from tests.test_torch_flat_cull import (H, ROWS, W, patch_pixels,
                                        patch_saturated, population)

torch.set_num_threads(1)

NAN_SPLAT = 17


def patch_any(flags, cfg):
    """(n_tiles, tile_h, tile_w) -> (n_tiles, patches): some pixel set."""
    g, c = cfg.tile_h // ROWS, cfg.tile_w // 32
    return flags.reshape(-1, g, ROWS, c, 32).any(dim=(2, 4)).reshape(
        -1, g * c)


def nonfinite(*planes):
    bad = torch.zeros_like(planes[0], dtype=torch.bool)
    for x in planes:
        bad |= ~torch.isfinite(x)
    return bad


def replay_emulated(listed, count, cfg, fin, gc, cin, tin):
    """The replay of kernels 3 and 8/9, emulated over each tile's listed
    rows (n_tiles, K, N_FIELDS): slot k is walked in patch j iff it is
    listed and the patch is poisoned (a non-finite cotangent or carry), or
    the cull keeps it and the patch has not passed its exit or the row is
    not finite. Returns (per-(tile, slot) partials (n_tiles, K, 9), the
    (n_tiles, patches, K) walked steps, the cull mask)."""
    yy, xx, fy, fx, inside = rd.tile_coords(cfg, "cpu")
    gc_rgb, gf, ga = rd.cotangent_tiles(fin, gc, cin, cfg)
    T = rd.to_tiles(tin[None], cfg)[0]
    keep = rr.listed_cover_mask(listed, count, cfg, ROWS)
    bad = ~torch.isfinite(listed[..., : tl.FIELD_OP + 1]).all(dim=-1)
    n_tiles, n_patch, k = keep.shape
    exited = torch.zeros((n_tiles, n_patch), dtype=torch.bool)
    poisoned = patch_any(nonfinite(*gc_rgb, gf, ga, T), cfg)
    walked = torch.zeros_like(keep)
    partial = torch.zeros((n_tiles, k, rd.N_MOMENTS))
    for slot in range(int(count.max())):
        listed_k = (slot < count)[:, None]
        walk = listed_k & (poisoned | (keep[..., slot]
                                       & (~exited | bad[:, slot, None])))
        px = patch_pixels(walk, cfg)
        live, alpha, vx, vy, (cr, cg, cb) = rd._splat_terms(
            listed[:, slot], fx, fy, xx, yy, inside, T, cfg)
        mw = live.to(torch.float32)
        w_c = alpha * T * mw
        gcdot = gc_rgb[0] * cr + gc_rgb[1] * cg + gc_rgb[2] * cb
        ga_new = ga + w_c * gcdot
        one_minus = torch.where(alpha >= 1.0, torch.full_like(alpha, 1e-15),
                                1.0 - alpha)
        z = (T * gcdot - (gf - ga_new) * (1.0 / one_minus)) * mw * alpha
        zero = torch.zeros_like(z)
        partial[:, slot] = rd._moment_reduce(
            torch.where(px, z, zero), vx[:, 0, :], vy,
            torch.where(px, w_c, zero), gc_rgb)
        ga = torch.where(px, ga_new, ga)
        T = torch.where(px, torch.where(live, T * (1.0 - alpha), T), T)
        walked[..., slot] = walk
        poisoned |= walk & patch_any(nonfinite(ga, T), cfg)
        exited |= walk & patch_saturated(T, cfg)
    return partial, walked, keep


def patch_sum(partial, walked, ids, count, n, cfg):
    """((n_tiles, K, patches, 9) parts, (16, n_pad) moments): per-(tile,
    slot) partials split into (pass, warp) parts and summed in
    patch_sum_kernel's order. A slot that no patch walked is all zero
    parts, as the kernels write it."""
    parts = split_parts(partial, walked.shape[1])
    parts[~walked.any(dim=1)] = 0.0
    n_pass = cfg.tile_h // 32  # passes of 32 rows at tile_w 128
    width = 2 * rr._n_pad(n)
    return parts, window_patch_sum(ids, count, torch.zeros_like(count),
                                   width, parts, n, n_pass)


def carry_and_cotangent(cfg, seed):
    """A prefix population's render (the carry-in, resident plain forward)
    and a random cotangent plane, both (…, Hp, Wp)."""
    pre = params_from_numpy(population("random", seed, 90), "cpu")
    cfg_pre = cfg.replace(n_splats=90)
    b = tl.bin_splats(pre, cfg_pre, 256, ids_only=True)
    cin, tin = rr._fwd_resident_plain(rr.resident_table(pre, cfg_pre),
                                      rr._remap_ids(b, 90), b.count, cfg_pre)
    rng = np.random.default_rng(seed)
    gc = torch.from_numpy(rng.normal(
        size=(3, cfg.padded_height, cfg.padded_width)).astype(np.float32))
    return gc, cin[0], tin[0]


def walk_counts(walked, keep, count):
    """Walked steps, survivors, listed (patch, slot) steps."""
    return (int(walked.sum()), int(keep.sum()),
            int(count.sum()) * keep.shape[1])


def same_bits(got, want):
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)
                and torch.equal(got[~nan], want[~nan]))


def same_listed(partial, want_part, walked, count):
    """The emulated partials equal the plain ones on every listed slot (the
    plain walks step the pad row past a tile's count too, which a poisoned
    tile turns to NaN), and the plain partial of a listed slot that no
    patch walks is exactly zero."""
    k = want_part.shape[1]
    listed = torch.arange(k)[None] < count[:, None]
    skipped = listed & ~walked[..., :k].any(dim=1)
    return (same_bits(partial[:, :k][listed], want_part[listed])
            and bool((want_part[skipped] == 0).all()))


CASES = [("random", 32), ("opacity-1", 32), ("opaque", 32), ("random", 64),
         ("opaque", 64), ("nan", 32), ("nan", 64)]


def resident_case(kind, tile_h):
    n = 170
    cfg = SplatConfig(width=W, height=H, n_splats=n, tile_h=tile_h,
                      max_splats_per_tile=256)
    p = params_from_numpy(population("random" if kind == "nan" else kind,
                                     tile_h + 5, n), "cpu")
    b = tl.bin_splats(p, cfg, 256, ids_only=True)
    assert int(b.n_dropped) == 0
    table, ids_s = rr.resident_table(p, cfg), rr._remap_ids(b, n)
    fin = rr._fwd_resident_plain(table, ids_s, b.count, cfg)[0][0]
    if kind == "nan":  # after the forward, as chip_smoke.py poisons it
        table.reshape(-1, tl.N_FIELDS)[NAN_SPLAT, tl.FIELD_PX] = float("nan")
    return cfg, p, b, table, ids_s, fin


@pytest.mark.parametrize("kind,tile_h", CASES)
def test_resident_replay_is_the_plain_replay_bit_for_bit(kind, tile_h):
    """Kernel 3's walk over the table rows its ids name, emulated, against
    _bwd_resident_plain: per-(tile, slot) partials and the patch-order
    moments."""
    cfg, _, b, table, ids_s, fin = resident_case(kind, tile_h)
    n = cfg.n_splats
    gc, cin, tin = carry_and_cotangent(cfg, tile_h)
    args = (fin, gc, cin, tin)
    listed = table.reshape(-1, tl.N_FIELDS)[ids_s.long()]
    partial, walked, keep = replay_emulated(listed, b.count, cfg, *args)
    coords = rd.tile_coords(cfg, "cpu")
    gc_rgb, gf, ga = rd.cotangent_tiles(fin, gc, cin, cfg)
    want_part = rr._replay_partials(table, ids_s, b.count, cfg, coords,
                                    gc_rgb, gf,
                                    (ga, rd.to_tiles(tin[None], cfg)[0]))
    want = rr._bwd_resident_plain(table, ids_s, b.count, *args, n, cfg)
    assert same_listed(partial, want_part, walked, b.count)
    _, got = patch_sum(partial, walked, ids_s, b.count, n, cfg)
    assert same_bits(got[:9, :n], want[:9, :n])
    check_walk(kind, walked, keep, b.count, want[:9, :n])


@pytest.mark.parametrize("kind,tile_h", CASES)
def test_dense_replay_is_the_plain_replay_bit_for_bit(kind, tile_h):
    """Kernel 8/9's walk over the dense tile_params, emulated, against
    _bwd_dense_plain: per-(tile, slot) partials, their patch_slot_sums
    view, and the patch-order moments."""
    n = 170
    cfg = SplatConfig(width=W, height=H, n_splats=n, tile_h=tile_h,
                      max_splats_per_tile=256, binning="dense")
    p = params_from_numpy(population("random" if kind == "nan" else kind,
                                     tile_h + 5, n), "cpu")
    b = tl.bin_splats(p, cfg, 256)
    assert int(b.n_dropped) == 0
    tp = b.tile_params
    fin, _ = rdn._fwd_dense_plain(tp, b.count, cfg)
    if kind == "nan":
        tp = tp.clone()
        tp[b.ids == NAN_SPLAT, tl.FIELD_PX] = float("nan")
    gc, cin, tin = carry_and_cotangent(cfg, tile_h)
    args = (fin, gc, cin, tin)
    partial, walked, keep = replay_emulated(tp, b.count, cfg, *args)
    want_part, want = rdn._bwd_dense_plain(tp, b.ids, b.count, *args, n,
                                           cfg)
    assert same_listed(partial, want_part, walked, b.count)
    parts, got = patch_sum(partial, walked, b.ids, b.count, n, cfg)
    listed = torch.arange(tp.shape[1])[None] < b.count[:, None]
    assert same_bits(rr.patch_slot_sums(parts, b.count, tile_h // 32)[listed],
                     want_part[listed])
    assert same_bits(got[:9, :n], want)
    check_walk(kind, walked, keep, b.count, want)


def check_walk(kind, walked, keep, count, moments):
    n_walked, survivors, steps = walk_counts(walked, keep, count)
    assert 0 < survivors < steps
    if kind == "nan":
        # Every patch of a tile that lists the splat walks it, then every
        # later slot: more steps than survivors, at most every listed one.
        assert survivors < n_walked <= steps
        assert torch.isnan(moments).any() and torch.isfinite(moments).any()
    else:
        assert n_walked <= survivors
        assert torch.isfinite(moments).all()
    if kind == "opaque":  # the exit itself cuts walked survivors
        assert n_walked < survivors


def test_resident_replay_matches_jax_backward_resident(rng):
    """The emulated kernel-3 walk, summed in patch order, against
    gs2d_tpu's backward_resident (Pallas, interpret mode) from a
    non-identity carry-in under a random cotangent, on one binning."""
    n, hh, ww = 130, 48, 64
    kw = dict(width=ww, height=hh, n_splats=n, tile_h=32,
              max_splats_per_tile=128)
    cfg_j, cfg = JaxConfig(**kw), SplatConfig(**kw)
    jp = to_params(random_splats(rng, n, ww, hh))
    jb = jtl.bin_splats(jp, cfg_j, 128, ids_only=True)
    jtab = jrr.resident_table(jp, cfg_j)
    b = tl.TileBinning(ids=torch.tensor(np.asarray(jb.ids)),
                       count=torch.tensor(np.asarray(jb.count)),
                       n_dropped=torch.tensor(int(jb.n_dropped)))
    table = torch.tensor(np.asarray(jtab))
    ids_s = rr._remap_ids(b, n)
    fin = rr.forward_resident(b, table, n, cfg)[0]
    c_in = torch.from_numpy(rng.uniform(0, 0.5, (hh, ww, 3))
                            .astype(np.float32))
    t_in = torch.from_numpy(rng.uniform(0.2, 1.0, (hh, ww))
                            .astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(hh, ww, 3)).astype(np.float32))
    planes = rd.carry_planes(fin, g, (c_in, t_in), cfg)
    listed = table.reshape(-1, tl.N_FIELDS)[ids_s.long()]
    partial, walked, _ = replay_emulated(listed, b.count, cfg, *planes)
    _, m = patch_sum(partial, walked, ids_s, b.count, n, cfg)
    got = rd.moments_to_grads(rd.unpack_moments(m, n),
                              rr._table_fields(table, n))
    want = jrr.backward_resident(jb, jtab, jnp.asarray(fin.numpy()),
                                 jnp.asarray(g.numpy()), n, cfg_j,
                                 carry_in=(jnp.asarray(c_in.numpy()),
                                           jnp.asarray(t_in.numpy())))
    for f in FIELDS:
        ref = np.asarray(getattr(want, f))
        atol = 1e-4 * max(1.0, np.abs(ref).max())
        np.testing.assert_allclose(getattr(got, f).numpy(), ref, atol=atol,
                                   err_msg=f)
