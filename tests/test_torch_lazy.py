"""PyTorch port lazy rebinning and opacity culling vs the JAX package: the
footprint margin and the cull's per-splat cutoff in ``_bbox_and_quad`` and
``tile_may_touch``, the tripwire ``pairs_covered_by``, margined binning
(``bin_splats``, counts-only, ``bin_splats_flat``), the margin and capacity
tuners, and the tripwire's soundness on fuzzed drift. Integers must be
equal, the cutoff k2 bitwise; the fuzz checks the port against the pixels
its kernels walk, as gs2d_tpu's fuzz checks gs2d_tpu."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.ops import render_pallas_flat as jrpf
from gs2d_tpu.ops import tiles as jtl
from gs2d_tpu.ops import tiles_flat as jtlf
from gs2d_tpu.params import GaussianParams as JaxParams
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import render_flat as trf
from gs2d_tpu_torch.ops import tiles as ttl
from gs2d_tpu_torch.ops import tiles_flat as ttlf
from gs2d_tpu_torch.ops.numerics import log_f32
from gs2d_tpu_torch.params import FIELDS, params_from_numpy
from tests.helpers import random_splats, to_params
from tests.test_binning_fuzz import (brute_force_coverage, make_params,
                                     splats_strategy)
from tests.test_opacity_cull import ALPHA, min_tile_q, with_opacity

torch.set_num_threads(1)

H, W = 48, 64
CULLS = (0.0, 1.0 / 256.0, 0.05)


def port(jp) -> "object":
    return params_from_numpy({f: np.asarray(getattr(jp, f)) for f in FIELDS},
                             "cpu")


def cfgs(n, tile_h=8, **kw):
    return (JaxConfig(width=W, height=H, n_splats=n, tile_h=tile_h, **kw),
            SplatConfig(width=W, height=H, n_splats=n, tile_h=tile_h, **kw))


def population(rng, n, special=True):
    """random_splats with opacities across the cull's range and, with
    ``special``, a NaN splat, an opacity-0 splat and an off-screen one."""
    s = random_splats(rng, n, W, H, opacity_range=(0.0, 1.0))
    if special:
        s.pos[3] = np.nan
        s.opacity[4] = 0.0
        s.pos[5] = (-400.0, 30.0)
    return to_params(s)


def test_log_f32_matches_jax_log():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(1e-6, 1.0, 200000), rng.uniform(0.1, 256.0, 100000),
        np.exp(rng.uniform(-90.0, 88.0, 100000)),
        [0.0, -0.0, -1.0, np.inf, -np.inf, np.nan, 1e-40, 1e-30, 1.0,
         0.70710677, 0.7071068]]).astype(np.float32)
    want = np.asarray(jnp.log(jnp.asarray(x)))
    got = log_f32(torch.from_numpy(x)).numpy()
    same = (got.view(np.int32) == want.view(np.int32)) \
        | (np.isnan(got) & np.isnan(want))
    assert same.all(), x[~same][:8]


@pytest.mark.parametrize("margin", [0.0, 2.0, 4.5])
@pytest.mark.parametrize("alpha", CULLS)
def test_bbox_and_quad(rng, margin, alpha):
    """Integer-equal tile boxes and offscreen flags, k2 bitwise (None
    without the cull), on a population with a NaN, an opacity-0 and an
    off-screen splat."""
    cfg_j, cfg_t = cfgs(96, opacity_cull_alpha=alpha)
    jp = population(rng, 96)
    jbox, jq = jtl._bbox_and_quad(jp, cfg_j, margin)
    tbox, tq = ttl._bbox_and_quad(port(jp), cfg_t, margin)
    for a, b in zip(jbox, tbox):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if alpha == 0.0:
        assert jq[5] is None and tq[5] is None
    else:
        k2j = np.asarray(jq[5], np.float32)
        k2t = tq[5].numpy()
        same = (k2t.view(np.int32) == k2j.view(np.int32)) \
            | (np.isnan(k2t) & np.isnan(k2j))
        assert same.all()
        assert bool(tbox[4][4])  # opacity 0: k2 = -inf, bins nowhere


@pytest.mark.parametrize("margin", [0.0, 1.0, 3.0])
def test_tile_may_touch(rng, margin):
    """Bool-equal on the same float32 inputs: every splat of a population
    against every tile of a 24-row grid, with and without a per-splat k2
    (some of it <= 0)."""
    cfg_j, cfg_t = cfgs(64)
    jp = population(rng, 64, special=False)
    _, (px, py, a, b, d, _) = jtl._bbox_and_quad(jp, cfg_j)
    cols = [np.asarray(v, np.float32)[:, None] for v in (px, py, a, b, d)]
    tx, ty = np.meshgrid(np.arange(2, dtype=np.int32),
                         np.arange(6, dtype=np.int32))
    tx, ty = tx.reshape(1, -1), ty.reshape(1, -1)
    k2 = rng.uniform(-1.0, 9.0, (64, 1)).astype(np.float32)
    for k in (None, k2):
        want = np.asarray(jtl.tile_may_touch(
            *cols, tx, ty, cfg_j, margin,
            k2=None if k is None else jnp.asarray(k)))
        got = ttl.tile_may_touch(
            *(torch.from_numpy(c) for c in cols), torch.from_numpy(tx),
            torch.from_numpy(ty), cfg_t, margin,
            k2=None if k is None else torch.from_numpy(k))
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < want.size


@pytest.mark.parametrize("alpha", [0.0, 1.0 / 256.0])
def test_pairs_covered_by_drift_ladder(rng, alpha):
    """The tripwire of one snapshot against drifts from 0 to past the
    margin, an opacity change, and a splat grown past the slot grid
    (count_full > max_tiles_per_splat): equal to gs2d_tpu's."""
    cfg_j, cfg_t = cfgs(48, opacity_cull_alpha=alpha, max_tiles_per_splat=8)
    jp = population(rng, 48, special=False)
    drift = rng.uniform(-1.0, 1.0, (48, 2)).astype(np.float32)
    seen = set()
    for step in (0.0, 0.5, 1.0, 1.9, 2.5, 4.0):
        moved = jp.replace(pos=np.asarray(jp.pos) + step * drift)
        cases = [moved, moved.replace(
            opacity=np.asarray(moved.opacity) * np.float32(1.5))]
        if step == 0.0:
            big = np.asarray(jp.sx).copy()
            big[7] = 60.0
            cases.append(jp.replace(sx=big))
        for now in cases:
            want = bool(jtl.pairs_covered_by(now, jp, cfg_j, 2.0))
            got = ttl.pairs_covered_by(port(now), port(jp), cfg_t, 2.0)
            assert got.dtype == torch.bool and got.dim() == 0
            assert bool(got) == want
            seen.add(want)
    assert seen == {True, False}


@pytest.mark.parametrize("margin", [0.0, 2.0])
@pytest.mark.parametrize("alpha", [0.0, 1.0 / 256.0])
def test_margined_binning(rng, margin, alpha):
    """bin_splats (ids-only and counts-only, with a per-tile cap that
    overflows) and bin_splats_flat under a margin and the cull: ids, count,
    start and n_dropped integer-equal."""
    cfg_j, cfg_t = cfgs(80, opacity_cull_alpha=alpha)
    jp = population(rng, 80)
    tp = port(jp)
    for k in (64, 6):
        jb = jtl.bin_splats(jp, cfg_j, k, ids_only=True, margin=margin)
        tb = ttl.bin_splats(tp, cfg_t, k, ids_only=True, margin=margin)
        np.testing.assert_array_equal(tb.ids.numpy(), np.asarray(jb.ids))
        np.testing.assert_array_equal(tb.count.numpy(), np.asarray(jb.count))
        assert int(tb.n_dropped) == int(jb.n_dropped)
    np.testing.assert_array_equal(
        ttl.bin_splats(tp, cfg_t, 1, counts_only=True, margin=margin).numpy(),
        np.asarray(jtl.bin_splats(jp, cfg_j, 1, counts_only=True,
                                  margin=margin)))
    for m_cap in (1024, 64):
        jf = jtlf.bin_splats_flat(jp, cfg_j, m_cap, kc=16, max_chunks=4,
                                  ids_only=True, margin=margin)
        tf = ttlf.bin_splats_flat(tp, cfg_t, m_cap, kc=16, max_chunks=4,
                                  ids_only=True, margin=margin)
        for f in ("ids", "start", "count"):
            np.testing.assert_array_equal(getattr(tf, f).numpy(),
                                          np.asarray(getattr(jf, f)), f)
        assert int(tf.n_dropped) == int(jf.n_dropped)


@pytest.mark.parametrize("scales,tile,want", [
    ((4.0, 12.0), (8, 128), 2.0), ((1.5, 3.0), (8, 16), 1.0),
    ((0.6, 1.6), (8, 16), 0.0)])
def test_tune_rebin_margin(scales, tile, want):
    """The auto margin picks 2, 1 and (too much pair inflation) 0 on three
    populations, as gs2d_tpu's does."""
    rng = np.random.default_rng(5)
    n = 64
    s = random_splats(rng, n, W, H)
    s.sx[:] = rng.uniform(*scales, n)
    s.sy[:] = rng.uniform(*scales, n)
    cfg_j, cfg_t = cfgs(n, tile_h=tile[0], tile_w=tile[1], rebin_margin=-1.0)
    jp = to_params(s)
    assert jtl.tune_rebin_margin(jp, cfg_j).rebin_margin == want
    assert ttl.tune_rebin_margin(port(jp), cfg_t).rebin_margin == want


@pytest.mark.parametrize("margin", [2.0, 6.0])
def test_tuners_under_margin(rng, margin):
    """tune_tile_capacity and tune_flat_config size for the margined
    footprints: the same statics as gs2d_tpu's."""
    cfg_j, cfg_t = cfgs(96, rebin_margin=margin)
    jp = population(rng, 96, special=False)
    tp = port(jp)
    a = jtl.tune_tile_capacity(jp, cfg_j)
    b = ttl.tune_tile_capacity(tp, cfg_t)
    assert (b.max_splats_per_tile, b.max_tiles_per_splat) == \
        (a.max_splats_per_tile, a.max_tiles_per_splat)
    a = jrpf.tune_flat_config(jp, cfg_j.replace(binning="flat"))
    b = trf.tune_flat_config(tp, cfg_t.replace(binning="flat"))
    assert (b.flat_capacity, b.flat_max_chunks, b.max_tiles_per_splat) == \
        (a.flat_capacity, a.flat_max_chunks, a.max_tiles_per_splat)


def _cached_lists(p_old, cfg, margin):
    got = ttl.bin_splats(port(p_old), cfg, 64, max_tiles_per_splat=64,
                         ids_only=True, margin=margin)
    assert int(got.n_dropped) == 0
    ids, count = got.ids.numpy(), got.count.numpy()
    return {t: set(ids[t, : count[t]].tolist()) for t in range(len(count))}


@settings(max_examples=8, deadline=None, database=None)
@given(splats_strategy(10),
       st.lists(st.tuples(
           st.floats(min_value=-6.0, max_value=6.0, width=32,
                     allow_nan=False),
           st.floats(min_value=-6.0, max_value=6.0, width=32,
                     allow_nan=False)), min_size=10, max_size=10),
       st.floats(min_value=0.875, max_value=1.125, width=32,
                 allow_nan=False))
def test_tripwire_soundness_fuzz(data, drifts, scale_mul):
    """Whenever the port's tripwire says the cache holds after a drift of
    position and scale, every tile whose pixels the drifted splat covers
    lists it in the margined binning of the old population
    (tests/test_binning_fuzz.py's property, held on the port)."""
    n = 10
    cfg = SplatConfig(width=64, height=48, n_splats=n, tile_h=16)
    p_old = make_params(data, n)
    p_new = JaxParams(
        pos=p_old.pos + np.asarray(drifts, np.float32),
        sx=np.clip(p_old.sx * np.float32(scale_mul), 1.0, 1024.0),
        sy=np.clip(p_old.sy * np.float32(scale_mul), 1.0, 1024.0),
        rot=p_old.rot, color=p_old.color, opacity=p_old.opacity)
    if not bool(ttl.pairs_covered_by(port(p_new), port(p_old), cfg, 2.0)):
        return  # tripping forces a rebin: always safe
    cached = _cached_lists(p_old, cfg, 2.0)
    for i, tiles in brute_force_coverage(p_new, cfg).items():
        for t in tiles:
            assert i in cached.get(t, set()), (i, t)


@settings(max_examples=8, deadline=None, database=None)
@given(splats_strategy(8),
       st.lists(st.floats(min_value=0.03125, max_value=1.0, width=32,
                          allow_nan=False), min_size=8, max_size=8),
       st.lists(st.floats(min_value=0.25, max_value=4.0, width=32,
                          allow_nan=False), min_size=8, max_size=8),
       st.lists(st.tuples(
           st.floats(min_value=-4.0, max_value=4.0, width=32,
                     allow_nan=False),
           st.floats(min_value=-4.0, max_value=4.0, width=32,
                     allow_nan=False)), min_size=8, max_size=8))
def test_tripwire_soundness_with_cull_fuzz(data, ops, op_mul, drifts):
    """Under the opacity cull, after position and opacity drift: whenever
    the port's tripwire holds, every clearly visible pair of the drifted
    population is in the cached binning (tests/test_opacity_cull.py's
    property and margins, held on the port)."""
    n = 8
    cfg = SplatConfig(width=96, height=72, n_splats=n, tile_h=16,
                      opacity_cull_alpha=ALPHA)
    jcfg = JaxConfig(width=96, height=72, n_splats=n, tile_h=16,
                     opacity_cull_alpha=ALPHA)
    p_old = with_opacity(make_params(data, n), ops)
    p_new = JaxParams(
        pos=p_old.pos + np.asarray(drifts, np.float32),
        sx=p_old.sx, sy=p_old.sy, rot=p_old.rot, color=p_old.color,
        opacity=np.clip(np.asarray(p_old.opacity)
                        * np.asarray(op_mul, np.float32), 0.0, 1.0))
    if not bool(ttl.pairs_covered_by(port(p_new), port(p_old), cfg, 2.0)):
        return
    cached = _cached_lists(p_old, cfg, 2.0)
    op_new = np.asarray(p_new.opacity)
    for i in range(n):
        for t in range(cfg.n_tiles_x * cfg.n_tiles_y):
            q = min_tile_q(p_new, i, t, jcfg)
            if q <= cfg.cutoff_sq - 0.05 \
                    and op_new[i] * np.exp(-0.5 * q) >= ALPHA * 1.05:
                assert i in cached.get(t, set()), (i, t)
