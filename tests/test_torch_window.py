"""The window layout of the PyTorch port (``ops/render_window.py``, the plain
twin of kernel 12) against gs2d_tpu's (``render_pallas_window.py``, Pallas
in interpret mode) and against the port's resident and dense steps, on the
CPU.

The port adds each splat's per-(tile, slot) partials in tile order over the
tiles whose window holds it, so with no escapes the window step equals the
resident step bit for bit (gs2d_tpu's two differ by about 1 ulp in the
order of their cross-tile sums, tests/test_window.py). Against gs2d_tpu the
tolerances are tests/test_torch_render.py's: colour atol 3e-7, gradients
atol 1e-4 * max(1, |g|max) (float32 reassociation across programs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.ops import render_pallas as jrp
from gs2d_tpu.ops import render_pallas_window as jrw
from gs2d_tpu.ops import tiles as jtl
from gs2d_tpu.params import GaussianParams as JaxParams
from gs2d_tpu.train import loop as jloop
from gs2d_tpu.train import reorder as jro
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.io.image import synthetic_target
from gs2d_tpu_torch.ops import render as trd
from gs2d_tpu_torch.ops import render_dense as trdn
from gs2d_tpu_torch.ops import render_resident as trr
from gs2d_tpu_torch.ops import render_window as trw
from gs2d_tpu_torch.ops import tiles as ttl
from gs2d_tpu_torch.params import FIELDS, params_from_numpy
from gs2d_tpu_torch.train import loop as tloop
from gs2d_tpu_torch.train import reorder as tro
from tests.helpers import random_splats, to_params

torch.set_num_threads(1)

H, W = 48, 64


def case(rng, n, **kw):
    """Seeded splats and target, as numpy, with both packages' configs."""
    p = {f: np.asarray(getattr(to_params(random_splats(rng, n, W, H)), f))
         for f in FIELDS}
    ref = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return (JaxConfig(width=W, height=H, n_splats=n, **kw),
            SplatConfig(width=W, height=H, n_splats=n, **kw), p, ref)


def assert_grads_equal(got, want):
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def assert_grads_close(got, want, scale=1e-4):
    for f in FIELDS:
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(
            getattr(got, f).numpy(), w,
            atol=scale * max(1.0, np.abs(w).max()), err_msg=f)


@pytest.mark.parametrize("width", [128, 256])
def test_window_bases_and_span_match_jax(rng, width):
    """Bases, escaped counts and the measured span integer-equal to
    gs2d_tpu's on the same binning."""
    n = 600
    cfg_j, cfg_t, p, _ = case(rng, n, tile_h=8, max_splats_per_tile=256)
    jb = jtl.bin_splats(JaxParams(**p), cfg_j, 256, ids_only=True)
    tb = ttl.bin_splats(params_from_numpy(p, "cpu"), cfg_t, 256,
                        ids_only=True)
    jbase, jesc = jrw.window_bases(jb, n, width)
    tbase, tesc = trw.window_bases(tb, n, width)
    np.testing.assert_array_equal(tbase.numpy(), np.asarray(jbase))
    assert int(tesc) == int(jesc) > 0
    assert int(trw.measure_window_span(tb, n)) \
        == int(jrw.measure_window_span(jb, n))


@pytest.mark.parametrize("n", [128, 130])
def test_full_width_matches_resident(rng, n):
    """W = n_pad: no escapes, and the step equals the resident step bit for
    bit (n = 130: the pad id N lands inside a top-edge window)."""
    _, cfg, p, ref = case(rng, n, max_splats_per_tile=64)
    cfg = cfg.replace(binning="window", window_width=trw._n_pad(n))
    tp = params_from_numpy(p, "cpu")
    refc = trd.pad_ref_chw(ref, cfg)
    before = dict(trw.launches)
    c_w, g_w, nd_w = trw.l2_step_window(tp, refc, cfg, 64)
    c_r, g_r, nd_r = trr.l2_step_resident(tp, refc, cfg, 64)
    assert trw.launches == before  # the CPU path launches no kernel
    assert torch.equal(c_w, c_r)
    assert int(nd_w) == int(nd_r)  # capacity drops alike, no escape
    assert_grads_equal(g_w, g_r)


def test_tuned_window_on_reordered_population_matches_dense():
    """gs2d_tpu's Morton-ordered pcg3d population, handed to both: the
    tuned window is gs2d_tpu's and narrower than the splat axis, nothing
    escapes, and the window step's colour equals the port's dense step's
    bit for bit, its gradients within 1e-6 * max(1, |g|max) (one float32
    program per pixel; the dense sum adds a splat's tile partials in the
    same tile order, the plain resident twin with one index_add_)."""
    kw = dict(width=256, height=192, n_splats=2048, max_splats_per_tile=512,
              tile_h=8, binning="window")
    cfg_j, cfg_t = JaxConfig(**kw), SplatConfig(**kw)
    js = jro.reorder_state(jloop.init_train_state(cfg_j), cfg_j)
    tp = params_from_numpy({f: np.asarray(getattr(js.params, f))
                            for f in FIELDS}, "cpu")
    cfg_t = trw.tune_window(tp, cfg_t)
    assert cfg_t.window_width == jrw.tune_window(js.params, cfg_j) \
        .window_width < trw._n_pad(2048)
    refc = trd.pad_ref_chw(synthetic_target(192, 256), cfg_t)
    c_w, g_w, nd = trw.l2_step_window(tp, refc, cfg_t, 512)
    b = ttl.bin_splats(tp, cfg_t, 512)
    c_d, g_d = trdn.l2_render_and_grads(b, refc, 2048, cfg_t, tp)
    assert torch.equal(c_w, c_d) and int(nd) == int(b.n_dropped) == 0
    for f in FIELDS:
        want = getattr(g_d, f)
        torch.testing.assert_close(
            getattr(g_w, f), want, rtol=0,
            atol=1e-6 * max(1.0, float(want.abs().max())))


def test_escaped_pairs_counted_and_dropped(rng):
    """W = 128 at 256 splats: every live id past its tile's window counts
    as escaped (cross-checked in numpy), the colour is the resident one,
    and the gradients lose exactly what gs2d_tpu's window kernel loses."""
    cfg_j, cfg_t, p, ref = case(rng, 256, max_splats_per_tile=128)
    cfg_j = cfg_j.replace(binning="window", window_width=128)
    cfg_t = cfg_t.replace(binning="window", window_width=128)
    tp = params_from_numpy(p, "cpu")
    b = ttl.bin_splats(tp, cfg_t, 128, ids_only=True)
    ids = b.ids.numpy()
    live = ids >= 0
    min_id = np.where(live, ids, 256).min(axis=1)
    base = np.clip((min_id // 128) * 128, 0, trw._n_pad(256) - 128)
    want = int((live & (ids >= base[:, None] + 128)).sum())
    assert want > 0, "case too easy: nothing escapes"
    refc = trd.pad_ref_chw(ref, cfg_t)
    c_w, g_w, nd = trw.l2_step_window(tp, refc, cfg_t, 128)
    assert int(nd) == want + int(b.n_dropped)
    c_r, g_r, _ = trr.l2_step_resident(tp, refc, cfg_t, 128)
    assert torch.equal(c_w, c_r)
    assert not torch.equal(g_w.pos, g_r.pos)
    c_j, g_j, nd_j = jrw.l2_step_window(
        JaxParams(**p), jrp.pad_ref_chw(jnp.asarray(ref), cfg_j), cfg_j, 128)
    assert int(nd_j) == int(nd)
    np.testing.assert_allclose(c_w.numpy(), np.asarray(c_j), atol=3e-7)
    assert_grads_close(g_w, g_j)


def test_fused_step_dispatch_equals_resident_step():
    """make_train_step_fused routes binning="window" through the window
    step; at W = n_pad the whole step (MSE, parameters, moments) equals
    the resident step bit for bit."""
    n = 128
    cfg_w = SplatConfig(width=W, height=H, n_splats=n,
                        max_splats_per_tile=64, tile_h=32, binning="window",
                        window_width=trw._n_pad(n))
    cfg_r = cfg_w.replace(binning="resident", window_width=None)
    refc = trd.pad_ref_chw(synthetic_target(H, W), cfg_w)
    state0 = tloop.init_train_state(cfg_w, "cpu")
    s_w, aux_w = tloop.make_train_step_fused(cfg_w)(state0, refc)
    s_r, aux_r = tloop.make_train_step_fused(cfg_r)(state0, refc)
    assert float(aux_w.mse) == float(aux_r.mse)
    for a, b in ((s_w.params, s_r.params), (s_w.opt.m, s_r.opt.m),
                 (s_w.opt.v, s_r.opt.v)):
        assert_grads_equal(a, b)


def test_tune_window_narrows_after_reorder():
    """The port's own reorder narrows the tuned window as gs2d_tpu's does;
    on the unordered population it tunes to n_pad."""
    kw = dict(width=256, height=192, n_splats=2048, max_splats_per_tile=512,
              tile_h=8, binning="window")
    cfg_j, cfg_t = JaxConfig(**kw), SplatConfig(**kw)
    s0 = tloop.init_train_state(cfg_t, "cpu")
    tuned = trw.tune_window(tro.reorder_state(s0, cfg_t).params, cfg_t)
    want = jrw.tune_window(
        jro.reorder_state(jloop.init_train_state(cfg_j), cfg_j).params, cfg_j)
    assert tuned.window_width == want.window_width < trw._n_pad(2048)
    assert trw.tune_window(s0.params, cfg_t).window_width \
        == trw._n_pad(2048)
