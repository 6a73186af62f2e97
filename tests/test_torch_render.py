"""PyTorch port rasterizer vs the JAX package on the CPU: the plain
versions of the two resident kernels (``l2_render_and_grads_resident``,
``forward_resident``) against the JAX resident Pallas kernels in interpret
mode and against the scan renderer ``render_jax``, plus the non-kernel
pieces (moments_to_grads, pad_ref_chw, the layout policy).

The kernels' inputs (ids-only binning and packed table) are built once by
the JAX package and handed to both sides, so the comparison isolates the
kernels; binning and packing have their own tests (test_torch_tiles.py).
Tolerances follow tests/test_resident.py: color atol 3e-7, gradients atol
1e-4 * max(1, |g|max) (float32 reassociation across programs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.ops import render_pallas as jrp
from gs2d_tpu.ops import render_pallas_flat as jrpf
from gs2d_tpu.ops import render_pallas_resident as jrr
from gs2d_tpu.ops import tiles as jtl
from gs2d_tpu.ops.render_jax import render_backward, render_forward
from gs2d_tpu.params import GaussianParams as JaxParams
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import render as trd
from gs2d_tpu_torch.ops import render_resident as trr
from gs2d_tpu_torch.ops import tiles as ttl
from gs2d_tpu_torch.params import FIELDS, GaussianParams, params_from_numpy
from tests.helpers import random_splats, to_params

torch.set_num_threads(1)

H, W = 48, 64
K = 128


def case(rng, n, tile_h):
    cfg_j = JaxConfig(width=W, height=H, n_splats=n, tile_h=tile_h,
                      max_splats_per_tile=K)
    cfg_t = SplatConfig(width=W, height=H, n_splats=n, tile_h=tile_h,
                        max_splats_per_tile=K)
    jp = to_params(random_splats(rng, n, W, H))
    ref = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return cfg_j, cfg_t, jp, ref


def shared_inputs(jp, cfg_j):
    """JAX-built binning and table, and their torch copies."""
    jb = jtl.bin_splats(jp, cfg_j, K, ids_only=True)
    jtab = jrr.resident_table(jp, cfg_j)
    tb = ttl.TileBinning(ids=torch.tensor(np.asarray(jb.ids)),
                         count=torch.tensor(np.asarray(jb.count)),
                         n_dropped=torch.tensor(int(jb.n_dropped)))
    return jb, jtab, tb, torch.tensor(np.asarray(jtab))


def assert_grads_close(g_port: GaussianParams, g_ref):
    for f in FIELDS:
        want = np.asarray(getattr(g_ref, f))
        got = getattr(g_port, f).numpy()
        atol = 1e-4 * max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=atol, err_msg=f)


@pytest.mark.parametrize("tile_h", [8, 32])
def test_l2_resident_matches_jax_kernel_and_scan(rng, tile_h):
    n = 130  # not a multiple of 128: exercises the padded splat axis
    cfg_j, cfg_t, jp, ref = case(rng, n, tile_h)
    jb, jtab, tb, ttab = shared_inputs(jp, cfg_j)
    Cj, gj = jrr.l2_render_and_grads_resident(
        jb, jtab, jrp.pad_ref_chw(jnp.asarray(ref), cfg_j), n, cfg_j)
    before = dict(trr.launches)
    Ct, gt = trr.l2_render_and_grads_resident(
        tb, ttab, trd.pad_ref_chw(ref, cfg_t), n, cfg_t)
    assert trr.launches == before  # the CPU path launches no kernel
    assert Ct.shape == (H, W, 3)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), atol=3e-7)
    assert_grads_close(gt, gj)

    C1, _ = render_forward(jp, cfg_j)
    g1 = render_backward(jp, C1, C1 - jnp.asarray(ref), cfg_j)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(C1), atol=3e-7)
    assert_grads_close(gt, g1)


@pytest.mark.parametrize("tile_h", [8, 32])
def test_forward_resident_matches_jax_kernel(rng, tile_h):
    n = 130
    cfg_j, cfg_t, jp, _ = case(rng, n, tile_h)
    jb, jtab, tb, ttab = shared_inputs(jp, cfg_j)
    Cj, Tj = jrr.forward_resident(jb, jtab, n, cfg_j)
    Ct, Tt = trr.forward_resident(tb, ttab, n, cfg_t)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), atol=3e-7)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=3e-7)
    Cp, Tp = trr.forward_resident(tb, ttab, n, cfg_t, crop=False)
    assert Cp.shape == (cfg_t.padded_height, cfg_t.padded_width, 3)
    assert float(Tp[:, W:].abs().max()) == 0.0  # padding never composites


def test_alpha_one_at_pixel_centre_gives_finite_grads():
    """An opacity-1 splat centred on a pixel centre makes alpha == 1 there
    (fast exp of 0 is exactly 1): the select-form 1 - alpha guard keeps
    every gradient finite, and the pixel's transmittance drops to 0."""
    cfg = SplatConfig(width=W, height=H, n_splats=3, tile_h=8,
                      max_splats_per_tile=8)
    p = params_from_numpy({
        "pos": np.array([[10.5, 12.5], [10.5, 12.5], [40.5, 30.5]],
                        np.float32),
        "sx": np.array([3.0, 5.0, 2.0], np.float32),
        "sy": np.array([2.0, 4.0, 6.0], np.float32),
        "rot": np.array([0.3, 1.0, 2.0], np.float32),
        "color": np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32),
        "opacity": np.ones(3, np.float32)}, "cpu")
    ref = np.full((H, W, 3), 0.25, np.float32)
    color, grads, n_dropped = trr.l2_step_resident(
        p, trd.pad_ref_chw(ref, cfg), cfg, 8)
    assert int(n_dropped) == 0
    np.testing.assert_array_equal(color[12, 10].numpy(), [1.0, 0.0, 0.0])
    for f in FIELDS:
        assert torch.isfinite(getattr(grads, f)).all(), f
    _, trans = trr.forward_resident(
        ttl.bin_splats(p, cfg, 8, ids_only=True),
        trr.resident_table(p, cfg), 3, cfg)
    assert float(trans[12, 10]) == 0.0


def test_moments_to_grads_matches_jax(rng):
    n = 40
    jp = to_params(random_splats(rng, n, W, H))
    jp = jp.replace(opacity=np.where(np.arange(n) % 7 == 0, np.float32(0),
                                     jp.opacity))  # dead slots: op == 0
    m = {f: rng.normal(size=np.shape(getattr(jp, f))).astype(np.float32)
         for f in FIELDS}
    m["opacity"] = np.where(jp.opacity > 0, m["opacity"], np.float32(0))
    fields = np.asarray(jtl.packed_fields(jp, 3.0))
    gj = jrp.moments_to_grads(JaxParams(**m), jnp.asarray(fields))
    gt = trd.moments_to_grads(params_from_numpy(m, "cpu"),
                              torch.tensor(fields))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(gt, f).numpy(),
                                   np.asarray(getattr(gj, f)),
                                   rtol=2e-6, atol=1e-6, err_msg=f)
    assert torch.isfinite(gt.opacity).all()
    assert float(gt.opacity[0]) == 0.0


def test_pad_ref_chw_and_tiles_round_trip(rng):
    cfg_j = JaxConfig(width=W, height=H, tile_h=32)
    cfg_t = SplatConfig(width=W, height=H, tile_h=32)
    ref = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    pt = trd.pad_ref_chw(ref, cfg_t)
    np.testing.assert_array_equal(
        pt.numpy(), np.asarray(jrp.pad_ref_chw(jnp.asarray(ref), cfg_j)))
    np.testing.assert_array_equal(
        trd.from_tiles(trd.to_tiles(pt[0], cfg_t), cfg_t).numpy(),
        pt[0].numpy())


@pytest.mark.parametrize("kw", [
    dict(), dict(n_splats=130, width=64, height=48),
    dict(binning="resident", n_splats=5000),
])
def test_resolve_binning_resident_where_jax_is(kw):
    cfg_j = JaxConfig(tile_h=32, **kw)
    assert jrpf.resolve_binning(cfg_j) == "resident"
    assert trd.resolve_binning(SplatConfig(tile_h=32, **kw)) == "resident"


@pytest.mark.parametrize("kw", [
    dict(n_splats=5000), dict(n_splats=4097), dict(binning="flat"),
])
def test_resolve_binning_flat_where_jax_is(kw):
    assert jrpf.resolve_binning(JaxConfig(tile_h=32, **kw)) == "flat"
    assert trd.resolve_binning(SplatConfig(tile_h=32, **kw)) == "flat"


@pytest.mark.parametrize("kw", [dict(binning="window")])
def test_resolve_binning_other_layouts_raise(kw):
    """The window layout, asked for by name, resolves in both packages."""
    assert jrpf.resolve_binning(JaxConfig(tile_h=32, **kw)) == "window"
    assert trd.resolve_binning(SplatConfig(tile_h=32, **kw)) == "window"


def test_resolve_binning_rejects_unknown():
    with pytest.raises(ValueError):
        trd.resolve_binning(SplatConfig(binning="bogus"))


def test_wrapper_rejects_other_devices(rng):
    cfg = SplatConfig(width=W, height=H, n_splats=4, max_splats_per_tile=8)
    p = params_from_numpy({f: getattr(to_params(random_splats(
        rng, 4, W, H)), f) for f in FIELDS}, "cpu")
    b = ttl.bin_splats(p, cfg, 8, ids_only=True)
    with pytest.raises(ValueError):
        trr.forward_resident(b, trr.resident_table(p, cfg).to("meta"), 4,
                             cfg)
