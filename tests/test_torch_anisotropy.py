"""The population on which gs2d_tpu's own fuzz test
``tests/test_binning_fuzz.py::test_fused_kernel_matches_scan_fuzz`` fails,
written out: 8 splats on a 64 x 48 target of 0.25 at tile_h 32, built as
that test's ``make_params`` builds them (colour 0.5, opacity 1), one of
them extremely anisotropic (sx 61.17, sy 1.0, rot 2.61).

There gs2d_tpu's Pallas fused kernel (interpret mode) and its scan renderer
disagree on the opacity gradient of that splat by 8.7e-4 of its size
(11.923447 against 11.913107), past the 1e-4 that the fuzz test assumes for
colour and opacity. The port's plain resident and dense L2 steps are held
to both JAX paths: to the Pallas path, whose per-(tile, slot) z-moments
they share, within ``TIGHT`` (measured: 2.8e-6 of the rotation gradient's
scale, 5.6e-7 of opacity's), to the scan path at the anisotropy class the
fuzz test documents for the geometry gradients (``CLASS`` of each field's
scale; measured 8.7e-4, on opacity), and to each other bit for bit.

The colour differs from both JAX paths (which agree with each other bit for
bit) by up to 7.1e-6 on 24 pixels along the anisotropic splat, although the
packed rows are bitwise gs2d_tpu's: the per-pixel float32 evaluation of
d2 = a vx^2 + 2 b vx vy + d vy^2 cancels there, and XLA's CPU backend
rounds it differently from PyTorch's and the CUDA kernels' one rounding
per operation. ``COLOR_ATOL`` holds that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.ops import render_pallas as jrp
from gs2d_tpu.ops import tiles as jtl
from gs2d_tpu.ops.render_jax import render_backward, render_forward
from gs2d_tpu.params import GaussianParams
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import render as trd
from gs2d_tpu_torch.ops import render_dense as trdn
from gs2d_tpu_torch.ops import render_resident as trr
from gs2d_tpu_torch.params import FIELDS, params_from_numpy

torch.set_num_threads(1)

N, H, W = 8, 48, 64
POPULATION = {
    "pos": [(5.960464477539063e-08, 47.16844940185547),
            (97.73085021972656, 0.05000000074505806), (-2.0, -0.0),
            (2.4505136013031006, 42.53168869018555), (0.0, 0.0), (0.0, 0.0),
            (0.0, 0.0), (0.0, 0.0)],
    "sx": [1.0, 1.0, 4.0, 61.169647216796875, 1.0, 1.0, 1.0, 1.0],
    "sy": [7.549883842468262, 1.0, 31.13283348083496, 1.0, 1.0, 1.0, 1.0,
           1.0],
    "rot": [0.0, 0.0, 0.0, 2.609990119934082, 0.0, 0.0, 0.0, 0.0],
    "color": [[0.5, 0.5, 0.5]] * N,
    "opacity": [1.0] * N,
}
# Relative to each field's scale, max(1, |g| max).
TIGHT = 1e-5   # the port against the JAX path that shares its sum order
CLASS = 1e-3   # against the other: the fuzz test's anisotropy class
COLOR_ATOL = 1e-5


def arrays() -> dict:
    return {f: np.asarray(v, np.float32) for f, v in POPULATION.items()}


@pytest.fixture(scope="module")
def grads():
    """Gradients of the L2 step by path: the port's plain resident and
    dense steps, gs2d_tpu's Pallas fused kernel and its scan renderer."""
    kw = dict(width=W, height=H, n_splats=N, tile_h=32,
              max_splats_per_tile=8)
    cfg_j, cfg_t = JaxConfig(**kw), SplatConfig(**kw)
    jp = GaussianParams(**{f: jnp.asarray(v) for f, v in arrays().items()})
    tp = params_from_numpy(arrays(), "cpu")
    ref = np.full((H, W, 3), 0.25, np.float32)
    refc = trd.pad_ref_chw(ref, cfg_t)
    out = {}
    c_r, out["resident"], _ = trr.l2_step_resident(tp, refc, cfg_t, 8)
    c_d, out["dense"], _ = trdn.l2_step_dense(
        tp, refc, cfg_t.replace(binning="dense"), 8)
    c_p, out["pallas"] = jrp.l2_render_and_grads(
        jtl.bin_splats(jp, cfg_j, 8), jrp.pad_ref_chw(jnp.asarray(ref), cfg_j),
        N, cfg_j, jp)
    c_s, _ = render_forward(jp, cfg_j)
    out["scan"] = render_backward(jp, c_s, c_s - jnp.asarray(ref), cfg_j)
    assert torch.equal(c_r, c_d)
    assert np.array_equal(np.asarray(c_p), np.asarray(c_s))
    np.testing.assert_allclose(c_r.numpy(), np.asarray(c_p), atol=COLOR_ATOL)
    return {k: {f: np.asarray(getattr(g, f)) for f in FIELDS}
            for k, g in out.items()}


def rel_err(got: dict, want: dict) -> dict:
    return {f: float(np.abs(got[f] - want[f]).max()
                     / max(1.0, float(np.abs(want[f]).max())))
            for f in FIELDS}


def test_the_jax_paths_disagree_on_opacity_past_1e4(grads):
    """The fuzz test's premise (opacity within 1e-4 between the Pallas and
    the scan path) fails here: 8.7e-4 of the opacity gradient's scale, on
    the anisotropic splat."""
    err = rel_err(grads["pallas"], grads["scan"])
    assert 5e-4 < err["opacity"] < CLASS
    gap = np.abs(grads["pallas"]["opacity"] - grads["scan"]["opacity"])
    assert int(gap.argmax()) == 3


def test_port_resident_and_dense_agree_bit_for_bit(grads):
    for f in FIELDS:
        assert np.array_equal(grads["resident"][f], grads["dense"][f]), f


@pytest.mark.parametrize("path", ["resident", "dense"])
def test_port_holds_to_both_jax_paths(grads, path):
    """Tight against the Pallas path (the same per-(tile, slot) z-moments,
    reduced over the tile's pixels, combined on the splat axis), and at the
    anisotropy class against the scan path."""
    to_pallas = rel_err(grads[path], grads["pallas"])
    to_scan = rel_err(grads[path], grads["scan"])
    assert max(to_pallas.values()) <= TIGHT, to_pallas
    assert max(to_scan.values()) <= CLASS, to_scan
    assert to_scan["opacity"] > 10 * TIGHT  # the scan path's own order
