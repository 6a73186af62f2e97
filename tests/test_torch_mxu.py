"""The MXU-form fused L2 step of the PyTorch port (``ops/render_mxu.py``, the
plain twin of kernel 13) against gs2d_tpu's ``render_pallas_mxu`` (Pallas
in interpret mode) and against the port's dense fused step, on the CPU.

Tolerances. Against gs2d_tpu's MXU kernel: colour atol 5e-5 and gradients
atol 2e-4 * max(1, |g|max). D2's six terms are added in the port's fixed
order and by JAX's float32 dot in its own, which moves alpha by about
1e-6; the combine's cancellation (s_xx = m_xx - 2 ex m_x + ex^2 m_1 with ex
up to the tile's half-width) lifts that to about 4e-5 of a field's scale
here. Against the port's dense step (kernel 4's twin, D2 in the direct
form): tests/test_fused.py's tolerances for the MXU form, colour atol 5e-5,
gradients 2e-3 * max(1, |g|max).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.ops import render_pallas as jrp
from gs2d_tpu.ops import tiles as jtl
from gs2d_tpu.ops.render_pallas_mxu import l2_render_and_grads_mxu as jmxu
from gs2d_tpu.params import GaussianParams as JaxParams
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import render as trd
from gs2d_tpu_torch.ops import render_dense as trdn
from gs2d_tpu_torch.ops import render_mxu as trm
from gs2d_tpu_torch.ops import tiles as ttl
from gs2d_tpu_torch.params import FIELDS, params_from_numpy
from tests.helpers import random_splats, to_params

torch.set_num_threads(1)

H, W = 48, 64


def case(rng, n, tile_h):
    p = {f: np.asarray(getattr(to_params(random_splats(rng, n, W, H)), f))
         for f in FIELDS}
    ref = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return (JaxConfig(width=W, height=H, n_splats=n, tile_h=tile_h),
            SplatConfig(width=W, height=H, n_splats=n, tile_h=tile_h), p,
            ref)


def assert_close(color, grads, want_color, want_grads, catol, gscale):
    np.testing.assert_allclose(color.numpy(), np.asarray(want_color),
                               atol=catol)
    for f in FIELDS:
        w = np.asarray(getattr(want_grads, f))
        np.testing.assert_allclose(
            getattr(grads, f).numpy(), w,
            atol=gscale * max(1.0, np.abs(w).max()), err_msg=f)


@pytest.mark.parametrize("n,tile_h,chunk", [(128, 8, 64), (96, 32, 64)])
def test_mxu_matches_jax_interpret_kernel(rng, n, tile_h, chunk):
    """Colour and gradients of the plain twin against gs2d_tpu's MXU kernel
    on the same splats and target (K = 128 in chunks of 64; 32-row tiles
    reach the image's bottom edge, where T = 1 on the padding keeps every
    chunk live)."""
    cfg_j, cfg_t, p, ref = case(rng, n, tile_h)
    jb = jtl.bin_splats(JaxParams(**p), cfg_j, 128)
    c_j, g_j = jmxu(jb, jrp.pad_ref_chw(jnp.asarray(ref), cfg_j), n, cfg_j,
                    chunk=chunk)
    tb = ttl.bin_splats(params_from_numpy(p, "cpu"), cfg_t, 128)
    before = dict(trm.launches)
    c_t, g_t = trm.l2_render_and_grads_mxu(tb, trd.pad_ref_chw(ref, cfg_t),
                                           n, cfg_t, chunk=chunk)
    assert trm.launches == before  # the CPU path launches no kernel
    assert c_t.shape == (H, W, 3)
    assert_close(c_t, g_t, c_j, g_j, 5e-5, 2e-4)


def test_mxu_close_to_dense_step(rng):
    """The MXU form against the direct form of the dense fused step on the
    same binning (the comparison gs2d_tpu makes against its scan path)."""
    _, cfg, p, ref = case(rng, 128, 8)
    tp = params_from_numpy(p, "cpu")
    b = ttl.bin_splats(tp, cfg, 128)
    refc = trd.pad_ref_chw(ref, cfg)
    c_m, g_m = trm.l2_render_and_grads_mxu(b, refc, 128, cfg, chunk=128)
    c_d, g_d = trdn.l2_render_and_grads(b, refc, 128, cfg, tp)
    assert_close(c_m, g_m, c_d, g_d, 5e-5, 2e-3)


def test_mxu_capacity_must_divide_by_chunk(rng):
    """Both packages refuse a per-tile capacity the chunk does not divide."""
    cfg_j, cfg_t, p, ref = case(rng, 32, 8)
    jb = jtl.bin_splats(JaxParams(**p), cfg_j, 96)
    with pytest.raises(ValueError):
        jmxu(jb, jrp.pad_ref_chw(jnp.asarray(ref), cfg_j), 32, cfg_j,
             chunk=64)
    tb = ttl.bin_splats(params_from_numpy(p, "cpu"), cfg_t, 96)
    with pytest.raises(ValueError):
        trm.l2_render_and_grads_mxu(tb, trd.pad_ref_chw(ref, cfg_t), 32,
                                    cfg_t, chunk=64)
