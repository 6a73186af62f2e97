"""The band arguments of the port's binning and kernels against gs2d_tpu's,
on the CPU: ``tiles.bin_splats`` and ``tiles_flat.bin_splats_flat`` with
``band_row0`` / ``band_rows`` (margins and the ids-only form included)
equal gs2d_tpu's binning of the same band pair for pair; the lazy tripwire
on one splat shard gives gs2d_tpu's answer; the plain versions of the
resident, dense and flat kernels under band arguments, with min_throughput
0 and a carry-in, equal gs2d_tpu's Pallas kernels in interpret mode on the
same inputs (colour atol 3e-7, gradients atol 1e-4 * max(1, |g| max), the
tolerances of tests/test_resident.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.ops import render_pallas as jrp
from gs2d_tpu.ops import render_pallas_flat as jrpf
from gs2d_tpu.ops import render_pallas_resident as jrr
from gs2d_tpu.ops import tiles as jtl
from gs2d_tpu.ops import tiles_flat as jtlf
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import render_dense as trdn
from gs2d_tpu_torch.ops import render_flat as trf
from gs2d_tpu_torch.ops import render_resident as trr
from gs2d_tpu_torch.ops import tiles as ttl
from gs2d_tpu_torch.ops import tiles_flat as ttlf
from gs2d_tpu_torch.params import FIELDS, params_from_numpy
from tests.helpers import random_splats, to_params

torch.set_num_threads(1)

H, W = 32, 64


def case(rng, n, tile_h, **kw):
    kw = dict(width=W, height=H, n_splats=n, tile_h=tile_h, **kw)
    jp = to_params(random_splats(rng, n, W, H))
    tp = params_from_numpy({f: np.asarray(getattr(jp, f)) for f in FIELDS},
                           "cpu")
    return JaxConfig(**kw), SplatConfig(**kw), jp, tp


def t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x))


def assert_grads_close(g_port, g_ref):
    for f in FIELDS:
        want = np.asarray(getattr(g_ref, f))
        atol = 1e-4 * max(1.0, np.abs(want).max())
        np.testing.assert_allclose(getattr(g_port, f).numpy(), want,
                                   atol=atol, err_msg=f)


# --- band arguments ---------------------------------------------------------

@pytest.mark.parametrize("band", [(0, 1), (1, 2), (3, 1)])
@pytest.mark.parametrize("margin", [0.0, 1.5])
def test_banded_binning_equals_gs2d_tpu(rng, band, margin):
    """Band-local ids, counts and drops pair for pair: splats whose box
    straddles two bands are listed in both, and a splat outside the band
    is off screen, not dropped (a small per-splat cap makes the unbanded
    drops differ from each band's)."""
    cfg_j, cfg_t, jp, tp = case(rng, 96, 8, max_tiles_per_splat=4)
    kw = dict(band_row0=band[0], band_rows=band[1], margin=margin)
    for ids_only in (True, False):
        want = jtl.bin_splats(jp, cfg_j, 64, ids_only=ids_only, **kw)
        got = ttl.bin_splats(tp, cfg_t, 64, ids_only=ids_only, **kw)
        assert got.ids.shape == (band[1] * cfg_t.n_tiles_x, 64)
        for f in ("ids", "count", "n_dropped"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        if not ids_only:  # the rows of its own ids
            assert torch.equal(got.tile_params,
                               ttl.pregather_rows(got.ids, tp, cfg_t))
    want = jtlf.bin_splats_flat(jp, cfg_j, 512, kc=16, ids_only=True, **kw)
    got = ttlf.bin_splats_flat(tp, cfg_t, 512, kc=16, ids_only=True, **kw)
    for f in ("ids", "start", "count", "n_dropped"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_tripwire_on_a_shard_equals_gs2d_tpu(rng):
    """The lazy tripwire on one splat shard's slice (each rank runs it on
    its own shard) gives gs2d_tpu's answer."""
    cfg_j, cfg_t, jp, tp = case(rng, 64, 8, rebin_margin=1.0)
    moved_j = jp.replace(pos=jp.pos + 0.7)
    moved_t = tp.replace(pos=tp.pos + 0.7)
    for sl in (slice(0, 32), slice(32, 64)):
        shard_j = jax.tree.map(lambda x: x[sl], jp)
        mj = jax.tree.map(lambda x: x[sl], moved_j)
        shard_t = tp.map(lambda x: x[sl])
        mt = moved_t.map(lambda x: x[sl])
        for m in (0.5, 1.0):
            assert bool(ttl.pairs_covered_by(mt, shard_t, cfg_t, m)) \
                == bool(jtl.pairs_covered_by(mj, shard_j, cfg_j, m))


def _carry(rng, shape):
    return (rng.uniform(0, 0.5, shape + (3,)).astype(np.float32),
            rng.uniform(0, 1, shape).astype(np.float32))


@pytest.mark.parametrize("band", [(1, 1), (2, 2)])
def test_banded_resident_and_dense_plain_match_gs2d_tpu(rng, band):
    """Kernels 1-3 (resident) and 4-9 (dense) in plain PyTorch under band
    arguments, with min_throughput 0 and a carry-in, against gs2d_tpu's
    kernels in interpret mode on gs2d_tpu's banded binning."""
    cfg_j, cfg_t, jp, tp = case(rng, 80, 8, min_throughput=0.0)
    r0, rows = band
    kw = dict(band_row0=r0, band_rows=rows)
    bh = rows * 8
    ref = rng.uniform(0, 1, (1, 3, bh, cfg_t.padded_width)) \
        .astype(np.float32)
    fin = rng.uniform(0, 1, (bh, cfg_t.padded_width, 3)).astype(np.float32)
    gc = rng.normal(size=fin.shape).astype(np.float32)
    c_in, t_in = _carry(rng, (bh, cfg_t.padded_width))
    jb = jtl.bin_splats(jp, cfg_j, 64, ids_only=True, **kw)
    jtab = jrr.resident_table(jp, cfg_j)
    tb = ttl.TileBinning(ids=t(jb.ids), count=t(jb.count),
                         n_dropped=t(jb.n_dropped))
    ttab = t(jtab)
    Cj, Tj = jrr.forward_resident(jb, jtab, 80, cfg_j, crop=False, **kw)
    Ct, Tt = trr.forward_resident(tb, ttab, 80, cfg_t, crop=False, **kw)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), atol=3e-7)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=3e-7)
    Cj, gj = jrr.l2_render_and_grads_resident(jb, jtab, jnp.asarray(ref), 80,
                                              cfg_j, **kw)
    Ct, gt = trr.l2_render_and_grads_resident(tb, ttab, torch.tensor(ref),
                                              80, cfg_t, **kw)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), atol=3e-7)
    assert_grads_close(gt, gj)
    for carry in (None, (c_in, t_in)):
        gj = jrr.backward_resident(
            jb, jtab, jnp.asarray(fin), jnp.asarray(gc), 80, cfg_j,
            carry_in=None if carry is None else tuple(map(jnp.asarray,
                                                          carry)), **kw)
        gt = trr.backward_resident(
            tb, ttab, torch.tensor(fin), torch.tensor(gc), 80, cfg_t,
            carry_in=None if carry is None else tuple(map(torch.tensor,
                                                          carry)), **kw)
        assert_grads_close(gt, gj)
    # Dense: the pregathered tile_params of the same band.
    jd = jtl.bin_splats(jp, cfg_j, 64, **kw)
    td = ttl.TileBinning(ids=t(jd.ids), count=t(jd.count),
                         n_dropped=t(jd.n_dropped),
                         tile_params=t(jd.tile_params))
    Cj, Tj = jrp.forward_tiled(jd, cfg_j, crop=False, **kw)
    Ct, Tt = trdn.forward_tiled(td, cfg_t, crop=False, **kw)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), atol=3e-7)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=3e-7)
    Cj, gj = jrp.l2_render_and_grads(jd, jnp.asarray(ref), 80, cfg_j, jp,
                                     **kw)
    Ct, gt = trdn.l2_render_and_grads(td, torch.tensor(ref), 80, cfg_t, tp,
                                      **kw)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), atol=3e-7)
    assert_grads_close(gt, gj)
    gj = jrp.backward_tiled(jd, jnp.asarray(fin), jnp.asarray(gc), 80, cfg_j,
                            jp, carry_in=tuple(map(jnp.asarray,
                                                   (c_in, t_in))), **kw)
    gt = trdn.backward_tiled(td, torch.tensor(fin), torch.tensor(gc), 80,
                             cfg_t, tp, carry_in=tuple(map(torch.tensor,
                                                           (c_in, t_in))),
                             **kw)
    assert_grads_close(gt, gj)


def test_banded_flat_plain_matches_gs2d_tpu(rng):
    """Kernels 10 and 11 in plain PyTorch on the band of tile rows 2-3 of a
    4-band grid, and the flat L2 step, against gs2d_tpu's in interpret
    mode on gs2d_tpu's banded flat binning."""
    cfg_j, cfg_t, jp, tp = case(rng, 120, 8, flat_chunk=16, binning="flat")
    kw = dict(band_row0=2, band_rows=2)
    bh = 16
    jb = jtlf.bin_splats_flat(jp, cfg_j, 1024, kc=16, **kw)
    assert int(jb.n_dropped) == 0
    tb = ttlf.FlatBinning(*(t(x) for x in jb))
    mc = 1024 // 16
    Cj, Tj = jrpf.forward_flat(jb, cfg_j, 16, mc, **kw)
    Ct, Tt = trf.forward_flat(tb, cfg_t, 16, mc, **kw)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), atol=3e-7)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=3e-7)
    gc = rng.normal(size=(bh, cfg_t.padded_width, 3)).astype(np.float32)
    carry = _carry(rng, (bh, cfg_t.padded_width))
    gj = jrpf.backward_flat(jb, Cj, jnp.asarray(gc), 120, cfg_j, 16, mc,
                            params=jp,
                            carry_in=tuple(map(jnp.asarray, carry)), **kw)
    gt = trf.backward_flat(tb, Ct, torch.tensor(gc), 120, cfg_t, 16, mc, tp,
                           carry_in=tuple(map(torch.tensor, carry)), **kw)
    assert_grads_close(gt, gj)
    ref = rng.uniform(0, 1, (1, 3, bh, cfg_t.padded_width)) \
        .astype(np.float32)
    Cj, gj = jrpf.l2_render_and_grads_flat(jb, jnp.asarray(ref), 120, cfg_j,
                                           16, mc, params=jp, **kw)
    Ct, gt = trf.l2_render_and_grads_flat(tb, torch.tensor(ref), 120, cfg_t,
                                          16, mc, tp, **kw)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), atol=3e-7)
    assert_grads_close(gt, gj)
