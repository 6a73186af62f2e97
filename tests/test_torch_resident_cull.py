"""The cull of the resident kernels 1 and 2 in plain PyTorch
(``render_resident.patch_cover_mask``) on the CPU, and the tile-order sum of
their plain versions.

The mask must keep every (warp patch, slot) at which the splat covers a
pixel, and the kernels decide it on the bits of ``_splat_terms``' cover, so
it is held for equality against the per-pixel cover of
``ops/render.py::_splat_terms`` gathered over each warp's 8 x 32 pixels: at
tile heights 8, 16, 32 and 64, on random, extremely anisotropic and
opacity-1 populations, and with a NaN position, whose slot is kept in every
patch. No tolerance: both sides are integer and boolean.
"""

import numpy as np
import pytest
import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.io.image import load_image
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_resident as rr
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.params import init_params, params_from_numpy

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
    return {k: v.astype(np.float32) for k, v in d.items()}


def binned(p, cfg, k=256):
    b = tl.bin_splats(p, cfg, k, ids_only=True)
    assert int(b.n_dropped) == 0
    return rr.resident_table(p, cfg), rr._remap_ids(b, p.n), b.count


def any_cover(table, ids, count, cfg):
    """(n_tiles, patches per tile, K): some pixel of the warp's patch
    covered, per _splat_terms (live with T = 1 and the 1/256 early-out is
    cover), slots past count excluded."""
    ngrp, ncg = cfg.tile_h // ROWS, cfg.tile_w // 32
    yy, xx, fy, fx, inside = rd.tile_coords(cfg, "cpu")
    rows = table.reshape(-1, tl.N_FIELDS)
    ones = torch.ones_like(fx)
    n_tiles, k = ids.shape
    out = torch.zeros((n_tiles, ngrp * ncg, k), dtype=torch.bool)
    for slot in range(k):
        live = rd._splat_terms(rows[ids[:, slot].long()], fx, fy, xx, yy,
                               inside, ones, cfg)[0]
        out[..., slot] = live.reshape(n_tiles, ngrp, ROWS, ncg, 32).any(
            dim=(2, 4)).reshape(n_tiles, ngrp * ncg)
    listed = torch.arange(k)[None] < count[:, None]
    return out & listed[:, None]


@pytest.mark.parametrize("tile_h", [8, 16, 32, 64])
@pytest.mark.parametrize("kind", ["random", "anisotropic", "opacity-1"])
def test_mask_is_the_patches_per_pixel_cover(kind, tile_h):
    n = 160
    cfg = SplatConfig(width=W, height=H, n_splats=n, tile_h=tile_h,
                      max_splats_per_tile=256)
    table, ids, count = binned(
        params_from_numpy(population(kind, tile_h, n), "cpu"), cfg)
    mask = rr.patch_cover_mask(table, ids, count, cfg, ROWS)
    want = any_cover(table, ids, count, cfg)
    assert mask.shape == want.shape
    assert mask.shape[1] == rr.patches_per_tile(cfg, ROWS)
    assert torch.equal(mask, want)
    # The cull is real: most listed (patch, slot) steps cover nothing.
    listed = int(count.sum()) * mask.shape[1]
    assert 0 < int(mask.sum()) < listed


@pytest.mark.parametrize("tile_h", [8, 32, 64])
def test_nan_position_is_kept_in_every_patch(tile_h):
    n = 120
    cfg = SplatConfig(width=W, height=H, n_splats=n, tile_h=tile_h,
                      max_splats_per_tile=256)
    table, ids, count = binned(
        params_from_numpy(population("random", 7, n), "cpu"), cfg)
    finite = rr.patch_cover_mask(table, ids, count, cfg, ROWS)
    table.reshape(-1, tl.N_FIELDS)[17, tl.FIELD_PX] = float("nan")
    mask = rr.patch_cover_mask(table, ids, count, cfg, ROWS)
    slot = ids == 17
    assert int(slot.sum()) > 0
    assert bool(mask.permute(0, 2, 1)[slot].all())
    others = ~slot[:, None, :].expand_as(mask)
    assert torch.equal(mask[others], finite[others])


def test_default_init_counts():
    """The default fit's init (268x213, 1024 splats, 32x128 tiles, K =
    512): 2991 listed pairs, 47 856 (patch, slot) steps of the
    one-block-per-tile walk, of which 14 140 cover a pixel of their
    patch."""
    ref = load_image("assets/squirrel_cls_mini.npy")
    cfg = SplatConfig(width=ref.shape[1], height=ref.shape[0],
                      n_splats=1024)
    p = init_params(cfg, "cpu")
    cfg = tl.tune_tile_capacity(p, tl.tune_tile_height(cfg, p))
    assert (cfg.tile_h, cfg.max_splats_per_tile) == (32, 512)
    table, ids, count = binned(p, cfg, 512)
    mask = rr.patch_cover_mask(table, ids, count, cfg, ROWS)
    assert mask.shape == (21, 16, 512)
    assert int(count.sum()) == 2991
    assert int(count.sum()) * 16 == 47856
    assert int(mask.sum()) == 14140


def test_tile_order_sum_equals_one_index_add_on_cpu():
    """The plain versions now add the per-(tile, slot) partials one tile at
    a time (deterministic on CUDA); on the CPU that equals the single
    index_add_ over all rows bit for bit."""
    gen = np.random.default_rng(3)
    n_tiles, n_k, n, n_pad = 9, 40, 300, 384
    ids = np.full((n_tiles, n_k), n, np.int64)  # the pad row N
    for t in range(n_tiles):
        m = gen.integers(5, n_k)
        ids[t, :m] = np.sort(gen.choice(n, m, replace=False))
    ids[gen.random(ids.shape) < 0.05] = n_pad  # dropped
    partial = (gen.normal(size=(n_tiles, n_k, 9))
               * 10.0 ** gen.integers(-3, 4, size=(n_tiles, n_k, 1))
               ).astype(np.float32)
    partial[ids == n] = 0.0
    ids_t, part_t = torch.from_numpy(ids), torch.from_numpy(partial)
    got = rr._tile_order_sum(part_t, ids_t, n_pad)
    want = torch.zeros((n_pad + 1, 9), dtype=torch.float32)
    want.index_add_(0, ids_t.reshape(-1), part_t.reshape(-1, 9))
    assert torch.equal(got, want)
