"""PyTorch port SSIM objective vs the JAX package on the CPU: ``ssim`` and
``mixed_loss``, the gradient of the mixed loss through ``production_render``
on each production layout (the JAX side's Pallas kernels in interpret
mode), the resident backward kernel's plain version under a random
cotangent and carry-in, five modular fit steps, and the CLI's ``--ssim``.

Tolerances: SSIM values rtol 1e-5 (float32 sums in another order);
gradients atol 1e-4 * max(1, |g|max), as
tests/test_ssim.py::TestSsimProductionKernels holds the JAX kernels.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.ops import render_pallas_flat as jrpf
from gs2d_tpu.ops import render_pallas_resident as jrr
from gs2d_tpu.ops import tiles as jtl
from gs2d_tpu.params import init_params as jinit
from gs2d_tpu.train import loop as jloop
from gs2d_tpu.train import ssim as jssim
from gs2d_tpu_torch import cli
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.io.image import synthetic_target
from gs2d_tpu_torch.ops import render_flat as trf
from gs2d_tpu_torch.ops import render_resident as trr
from gs2d_tpu_torch.ops import tiles as ttl
from gs2d_tpu_torch.params import FIELDS, GaussianParams, init_params
from gs2d_tpu_torch.params import params_from_numpy
from gs2d_tpu_torch.train import loop as tloop
from gs2d_tpu_torch.train import ssim as tssim
from tests.helpers import random_splats, to_params

torch.set_num_threads(1)

H, W = 48, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "assets", "squirrel_cls_mini.npy")


def assert_grads_close(g_port, g_ref):
    for f in FIELDS:
        want = np.asarray(getattr(g_ref, f))
        atol = 1e-4 * max(1.0, np.abs(want).max())
        np.testing.assert_allclose(getattr(g_port, f).numpy(), want,
                                   atol=atol, err_msg=f)


@pytest.mark.parametrize("window,sigma", [(11, 1.5), (7, 1.0)])
def test_ssim_and_mixed_loss_match_jax(rng, window, sigma):
    a = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    want = float(jssim.ssim(jnp.asarray(a), jnp.asarray(b), window, sigma))
    got = float(tssim.ssim(torch.tensor(a), torch.tensor(b), window, sigma))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert 0.0 < got < 1.0
    np.testing.assert_allclose(
        float(tssim.mixed_loss(torch.tensor(a), torch.tensor(b), 0.2)),
        float(jssim.mixed_loss(jnp.asarray(a), jnp.asarray(b), 0.2)),
        rtol=1e-5)
    # The head's cotangent dL/dC, autograd against jax.grad.
    ta = torch.tensor(a, requires_grad=True)
    (g,) = torch.autograd.grad(tssim.mixed_loss(ta, torch.tensor(b), 0.2),
                               ta)
    gj = np.asarray(jax.grad(lambda x: jssim.mixed_loss(
        x, jnp.asarray(b), 0.2))(jnp.asarray(a)))
    np.testing.assert_allclose(g.numpy(), gj,
                               atol=1e-5 * max(1.0, np.abs(gj).max()))


def test_gauss_window_cached_on_host():
    k = tssim._gauss_kernel_np(11, 1.5)
    assert isinstance(k, np.ndarray) and k.dtype == np.float32
    np.testing.assert_array_equal(k, jssim._gauss_kernel_np(11, 1.5))
    assert tssim._gauss_kernel_np(11, 1.5) is k


def layout_cfgs(binning):
    kw = dict(width=W, height=H, n_splats=32, binning=binning, tile_h=32)
    if binning == "flat":
        kw["flat_chunk"] = 32
    else:
        kw["max_splats_per_tile"] = 32
    cfg_j, cfg_t = JaxConfig(**kw), SplatConfig(**kw)
    if binning == "flat":
        cfg_j = jrpf.tune_flat_config(jinit(cfg_j), cfg_j)
        cfg_t = trf.tune_flat_config(init_params(cfg_t, "cpu"), cfg_t)
    return cfg_j, cfg_t


@pytest.mark.parametrize("binning", ["resident", "flat", "dense"])
def test_mixed_loss_grad_through_production_render(binning):
    """The parameter gradient through the port's differentiable render
    against gs2d_tpu's production_render, twice: under one shared
    cotangent (JAX's SSIM head at lambda 0.3, as TestSsimProductionKernels
    takes it), which isolates the render's VJP; and end to end, each side's
    own head at lambda 0.2 (the fits' objective) and jax.grad. The two
    heads' cotangents differ by float32 rounding scaled by npix (4e-5 of
    their max here), which near alpha = 1 moves an opacity moment by up to
    1.3e-4 of its scale at lambda 0.3: so the end-to-end check runs at 0.2."""
    cfg_j, cfg_t = layout_cfgs(binning)
    ref = synthetic_target(H, W)
    jp = jinit(cfg_j)
    col_j, vjp = jax.vjp(lambda q: jrpf.production_render(q, cfg_j), jp)
    g_col = jax.grad(lambda c: jssim.mixed_loss(c, jnp.asarray(ref), 0.3))(
        col_j)
    tp = init_params(cfg_t, "cpu")
    leaves = [getattr(tp, f).requires_grad_() for f in FIELDS]
    color, n_dropped = trf.production_render(
        GaussianParams(**dict(zip(FIELDS, leaves))), cfg_t)
    assert color.shape == (H, W, 3) and int(n_dropped) == 0
    np.testing.assert_allclose(color.detach().numpy(), np.asarray(col_j),
                               atol=1e-6)
    shared = torch.autograd.grad(color, leaves,
                                 torch.tensor(np.asarray(g_col)),
                                 retain_graph=True)
    assert_grads_close(GaussianParams(**dict(zip(FIELDS, shared))),
                       vjp(g_col)[0])

    # jax.grad of the composition is this VJP of the head's cotangent.
    want = vjp(jax.grad(lambda c: jssim.mixed_loss(
        c, jnp.asarray(ref), 0.2))(col_j))[0]
    own = torch.autograd.grad(
        tssim.mixed_loss(color, torch.tensor(ref), 0.2), leaves)
    assert_grads_close(GaussianParams(**dict(zip(FIELDS, own))), want)


def test_backward_resident_carry_and_cotangent_match_jax(rng):
    """Plain kernel 3 from a non-identity carry-in (another population's
    composite) under a random cotangent; both sides get the same binning,
    table, final colour, carry and cotangent."""
    n = 130
    kw = dict(width=W, height=H, n_splats=n, tile_h=32,
              max_splats_per_tile=128)
    cfg_j, cfg_t = JaxConfig(**kw), SplatConfig(**kw)
    jp = to_params(random_splats(rng, n, W, H))
    jb = jtl.bin_splats(jp, cfg_j, 128, ids_only=True)
    jtab = jrr.resident_table(jp, cfg_j)
    tb = ttl.TileBinning(ids=torch.tensor(np.asarray(jb.ids)),
                         count=torch.tensor(np.asarray(jb.count)),
                         n_dropped=torch.tensor(int(jb.n_dropped)))
    ttab = torch.tensor(np.asarray(jtab))
    fin, _ = trr.forward_resident(tb, ttab, n, cfg_t)
    pre = params_from_numpy({f: getattr(random_splats(rng, 60, W, H), f)
                             for f in FIELDS}, "cpu")
    cfg_pre = cfg_t.replace(n_splats=60)
    c_in, t_in = trr.forward_resident(
        ttl.bin_splats(pre, cfg_pre, 128, ids_only=True),
        trr.resident_table(pre, cfg_pre), 60, cfg_pre)
    g = rng.normal(size=(H, W, 3)).astype(np.float32)
    before = dict(trr.launches)
    gt = trr.backward_resident(tb, ttab, fin, torch.tensor(g), n, cfg_t,
                               carry_in=(c_in, t_in))
    assert trr.launches == before  # the CPU path launches no kernel
    gj = jrr.backward_resident(jb, jtab, jnp.asarray(fin.numpy()),
                               jnp.asarray(g), n, cfg_j,
                               carry_in=(jnp.asarray(c_in.numpy()),
                                         jnp.asarray(t_in.numpy())))
    assert_grads_close(gt, gj)
    # The identity carry is the default.
    ident = trr.backward_resident(
        tb, ttab, fin, torch.tensor(g), n, cfg_t,
        carry_in=(torch.zeros((H, W, 3)), torch.ones((H, W))))
    default = trr.backward_resident(tb, ttab, fin, torch.tensor(g), n, cfg_t)
    for f in FIELDS:
        assert torch.equal(getattr(default, f), getattr(ident, f)), f


def test_five_step_ssim_fit_matches_jax():
    """Five modular steps at lambda 0.2 on the resident layout against
    gs2d_tpu's fit through production_render: per-step MSE within rtol
    1e-5."""
    kw = dict(width=W, height=H, n_splats=64, tile_h=32, binning="resident")
    ref = synthetic_target(H, W)
    _, hist_j = jloop.fit(jnp.asarray(ref), JaxConfig(**kw), 5,
                          render_fn=jrpf.production_render, log_every=1,
                          log_fn=None, ssim_lambda=0.2)
    _, hist_t = tloop.fit(ref, SplatConfig(**kw), 5, "cpu", log_every=1,
                          log_fn=None, ssim_lambda=0.2)
    got = [rec["mse"] for rec in hist_t]
    np.testing.assert_allclose(got, [rec["mse"] for rec in hist_j],
                               rtol=1e-5)
    assert got[-1] < got[0]


def test_cli_ssim_fit_on_cpu(tmp_path, capsys):
    rc = cli.main([MINI, "--splats", "16", "--iters", "2", "--log-every",
                   "1", "--device", "cpu", "--ssim", "0.2", "--out",
                   str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "0 itr, mse" in out and "1 itr, mse" in out
    assert (tmp_path / "render_final.png").read_bytes()[:8] \
        == b"\x89PNG\r\n\x1a\n"
