"""PyTorch port binning vs the JAX package: packed fields, ids-only and
counts-only binning (integer-equal ids, counts and n_dropped, including
capacity overflow and per-splat tile truncation), the dense pregather, and
capacity tuning."""

import numpy as np
import pytest
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.ops import tiles as jtl
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import tiles as ttl
from gs2d_tpu_torch.params import FIELDS, params_from_numpy
from tests.helpers import random_splats, to_params

torch.set_num_threads(1)

H, W = 48, 64


def case(rng, n, tile_h, **kw):
    cfg_j = JaxConfig(width=W, height=H, n_splats=n, tile_h=tile_h, **kw)
    cfg_t = SplatConfig(width=W, height=H, n_splats=n, tile_h=tile_h, **kw)
    jp = to_params(random_splats(rng, n, W, H))
    tp = params_from_numpy({f: getattr(jp, f) for f in FIELDS}, "cpu")
    return cfg_j, cfg_t, jp, tp


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_field_layout_matches():
    for name in dir(jtl):
        if name.startswith("FIELD_") or name == "N_FIELDS":
            assert getattr(ttl, name) == getattr(jtl, name), name


def test_packed_fields(rng):
    """Fields that do not depend on rot are bitwise; cos/sin within 1 ulp
    (XLA's and libm's float32 cos/sin differ by 1 ulp on a few percent of
    inputs). a, b, d, h inherit that ulp through the covariance's
    cancellation, so a, b, d are held bitwise to the JAX formula evaluated
    in numpy float32 on the port's own cos/sin, and all four to JAX within
    2e-5 relative."""
    _, _, jp, tp = case(rng, 130, 8)
    jf = np.asarray(jtl.packed_fields(jp, 3.0))
    tf = ttl.packed_fields(tp, 3.0).numpy()
    exact = [ttl.FIELD_PX, ttl.FIELD_PY, ttl.FIELD_CR, ttl.FIELD_CG,
             ttl.FIELD_CB, ttl.FIELD_OP, ttl.FIELD_SX, ttl.FIELD_SY,
             ttl.FIELD_VALID, 15]
    np.testing.assert_array_equal(tf[exact], jf[exact])
    assert _ulps(tf[[ttl.FIELD_COS, ttl.FIELD_SIN]],
                 jf[[ttl.FIELD_COS, ttl.FIELD_SIN]]).max() <= 1

    c, s = tf[ttl.FIELD_COS], tf[ttl.FIELD_SIN]
    sx, sy = tp.sx.numpy(), tp.sy.numpy()
    l0, l1 = sx * sx, sy * sy
    s11 = l0 * c * c + l1 * s * s
    s12 = (l0 - l1) * s * c
    s22 = l0 + l1 - s11
    det = s11 * s22 - s12 * s12
    a, b, d = s22 / det, -s12 / det, s11 / det
    for fld, want in ((ttl.FIELD_A, a), (ttl.FIELD_B, b), (ttl.FIELD_D, d)):
        np.testing.assert_array_equal(tf[fld], want)
    for fld in (ttl.FIELD_A, ttl.FIELD_B, ttl.FIELD_D, ttl.FIELD_H):
        np.testing.assert_allclose(tf[fld], jf[fld], rtol=2e-5, atol=1e-12)


# (n, tile_h, K, max_tiles_per_splat): ordinary lists at both production
# tile heights, per-tile capacity overflow, and per-splat tile truncation.
BIN_CASES = [(130, 8, 128, None), (130, 32, 128, None), (64, 8, 8, None),
             (130, 32, 16, None), (96, 8, 64, 2), (96, 32, 64, 1)]


@pytest.mark.parametrize("n,tile_h,k,mtps", BIN_CASES)
def test_bin_splats_ids_equal(rng, n, tile_h, k, mtps):
    cfg_j, cfg_t, jp, tp = case(rng, n, tile_h)
    jb = jtl.bin_splats(jp, cfg_j, k, ids_only=True,
                        max_tiles_per_splat=mtps)
    tb = ttl.bin_splats(tp, cfg_t, k, ids_only=True,
                        max_tiles_per_splat=mtps)
    np.testing.assert_array_equal(tb.ids.numpy(), np.asarray(jb.ids))
    np.testing.assert_array_equal(tb.count.numpy(), np.asarray(jb.count))
    assert int(tb.n_dropped) == int(jb.n_dropped)
    assert tb.ids.dtype == torch.int32 and tb.count.dtype == torch.int32
    if (k, mtps) in ((8, None), (16, None), (64, 2), (64, 1)):
        assert int(tb.n_dropped) > 0  # the overflow cases really overflow


@pytest.mark.parametrize("tile_h", [8, 32])
def test_counts_only_and_tuning_equal(rng, tile_h):
    cfg_j, cfg_t, jp, tp = case(rng, 130, tile_h)
    np.testing.assert_array_equal(
        ttl.bin_splats(tp, cfg_t, 1, counts_only=True).numpy(),
        np.asarray(jtl.bin_splats(jp, cfg_j, 1, counts_only=True)))
    tj = jtl.tune_tile_capacity(jp, cfg_j)
    tt = ttl.tune_tile_capacity(tp, cfg_t)
    assert tt.max_splats_per_tile == tj.max_splats_per_tile
    assert tt.max_tiles_per_splat == tj.max_tiles_per_splat


def test_offscreen_and_negative_floor(rng):
    """Splats left of / above the image bin by floor division (the bbox's
    negative pixel ends), and fully off-screen splats bin nowhere."""
    cfg_j, cfg_t, jp, tp = case(rng, 8, 8)
    pos = np.array([[-5, 10], [10, -5], [-300, 20], [20, 400], [-2, -2],
                    [63.5, 47.5], [70, 20], [30, 52]], np.float32)
    jp = jp.replace(pos=pos)
    tp = tp.replace(pos=torch.tensor(pos))
    jb = jtl.bin_splats(jp, cfg_j, 16, ids_only=True)
    tb = ttl.bin_splats(tp, cfg_t, 16, ids_only=True)
    np.testing.assert_array_equal(tb.ids.numpy(), np.asarray(jb.ids))
    ids = set(tb.ids.numpy().ravel().tolist())
    assert 2 not in ids and 3 not in ids  # fully off-screen
    assert {0, 1, 4, 5} <= ids


def test_dense_pregather(rng):
    """Without ids_only the binning pregathers each listed splat's packed
    row into tile_params; padded slots hold the benign pad row."""
    _, cfg_t, _, tp = case(rng, 16, 8)
    b = ttl.bin_splats(tp, cfg_t, 16)
    assert b.tile_params.shape == (*b.ids.shape, ttl.N_FIELDS)
    rows = ttl.packed_fields(tp, 3.0).T
    live = b.ids >= 0
    assert bool((~live).any())
    assert torch.equal(b.tile_params[live], rows[b.ids[live].long()])
    assert torch.equal(b.tile_params[~live],
                       ttl.pad_row("cpu").expand(int((~live).sum()), -1))
    assert ttl.bin_splats(tp, cfg_t, 16, ids_only=True).tile_params is None
