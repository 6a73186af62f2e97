"""PyTorch port dense layout vs the JAX package on the CPU: the pregathered
tile_params of the binning, the plain versions of the dense kernels
(forward, backward with carry-in and any cotangent, the fused L2 step)
against the JAX dense Pallas kernels in interpret mode at K = 64 (kernels
4, 6, 8) and K = 512 (the chunked kernels 5, 7, 9), five fit steps, the CLI
and the layout policy.

Kernel inputs (the dense binning) are built by the JAX package and handed
to both sides where a test isolates a kernel. Tolerances follow
tests/test_torch_flat.py: colour and T atol 1e-6, gradients atol
1e-4 * max(1, |g|max) (float32 sums in another order; the JAX fused kernel
at K = 64 also caches the Gaussian term, <= 1 ulp).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.ops import render_pallas as jrp
from gs2d_tpu.ops import render_pallas_flat as jrpf
from gs2d_tpu.ops import tiles as jtl
from gs2d_tpu.train import loop as jloop
from gs2d_tpu_torch import cli
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.io.image import synthetic_target
from gs2d_tpu_torch.ops import render as trd
from gs2d_tpu_torch.ops import render_dense as trdn
from gs2d_tpu_torch.ops import tiles as ttl
from gs2d_tpu_torch.params import FIELDS, params_from_numpy
from gs2d_tpu_torch.train import loop as tloop
from tests.helpers import random_splats, to_params

torch.set_num_threads(1)

H, W = 48, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "assets", "squirrel_cls_mini.npy")


def case(rng, n, k, tile_h=16):
    kw = dict(width=W, height=H, n_splats=n, tile_h=tile_h,
              max_splats_per_tile=k, binning="dense")
    jp = to_params(random_splats(rng, n, W, H))
    tp = params_from_numpy({f: np.asarray(getattr(jp, f)) for f in FIELDS},
                           "cpu")
    return JaxConfig(**kw), SplatConfig(**kw), jp, tp


def to_torch(jb) -> ttl.TileBinning:
    return ttl.TileBinning(
        ids=torch.tensor(np.asarray(jb.ids)),
        count=torch.tensor(np.asarray(jb.count)),
        n_dropped=torch.tensor(int(jb.n_dropped)),
        tile_params=torch.tensor(np.asarray(jb.tile_params)))


def assert_grads_close(g_port, g_ref):
    for f in FIELDS:
        want = np.asarray(getattr(g_ref, f))
        atol = 1e-4 * max(1.0, np.abs(want).max())
        np.testing.assert_allclose(getattr(g_port, f).numpy(), want,
                                   atol=atol, err_msg=f)


# (n, K, tile_h): K = 64 (the unchunked JAX kernels) and
# K = 512 with lists longer than one 256-row chunk (the chunked kernels).
CASES = [(40, 64, 16), (300, 512, 16)]


@pytest.mark.parametrize("n,k,tile_h", [(40, 64, 8), (300, 16, 16)])
def test_tile_params_bitwise(rng, monkeypatch, n, k, tile_h):
    """Same packed fields: ids, counts, n_dropped and the pregathered
    tile_params, padding rows included, are bitwise equal. Both sides
    gather from one packed-field array (the fields themselves differ by an
    ulp between XLA and libm, see test_torch_tiles.test_packed_fields)."""
    cfg_j, cfg_t, jp, tp = case(rng, n, k, tile_h)
    fields = np.asarray(jtl.packed_fields(jp, 3.0))
    monkeypatch.setattr(jtl, "packed_fields",
                        lambda p, bounds=3.0: jnp.asarray(fields))
    monkeypatch.setattr(ttl, "packed_fields",
                        lambda p, bounds=3.0: torch.tensor(fields))
    jb = jtl.bin_splats(jp, cfg_j, k)
    tb = ttl.bin_splats(tp, cfg_t, k)
    if k == 64:
        assert (np.asarray(jb.ids) < 0).any()  # padded slots exist
    else:
        assert int(jb.n_dropped) > 0  # the capacity really overflows
    np.testing.assert_array_equal(tb.ids.numpy(), np.asarray(jb.ids))
    np.testing.assert_array_equal(tb.count.numpy(), np.asarray(jb.count))
    assert int(tb.n_dropped) == int(jb.n_dropped)
    assert tb.tile_params.shape == (cfg_t.n_tiles_x * cfg_t.n_tiles_y, k,
                                    ttl.N_FIELDS)
    np.testing.assert_array_equal(tb.tile_params.numpy(),
                                  np.asarray(jb.tile_params))
    assert ttl.bin_splats(tp, cfg_t, k, ids_only=True).tile_params is None


@pytest.mark.parametrize("n,k,tile_h", CASES)
def test_forward_tiled_matches_jax(rng, n, k, tile_h):
    cfg_j, cfg_t, jp, _ = case(rng, n, k, tile_h)
    jb = jtl.bin_splats(jp, cfg_j, k)
    if k > 256:
        assert int(np.asarray(jb.count).max()) > 256  # two chunks
    Cj, Tj = jrp.forward_tiled(jb, cfg_j)
    before = dict(trdn.launches)
    Ct, Tt = trdn.forward_tiled(to_torch(jb), cfg_t)
    assert trdn.launches == before  # the CPU path launches no kernel
    assert Ct.shape == (H, W, 3)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), atol=1e-6)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-6)
    Cp, Tp = trdn.forward_tiled(to_torch(jb), cfg_t, crop=False)
    assert Cp.shape == (cfg_t.padded_height, cfg_t.padded_width, 3)
    assert float(Tp[:, W:].abs().max()) == 0.0  # padding never composites


@pytest.mark.parametrize("n,k,tile_h", CASES)
def test_backward_tiled_carry_and_cotangent_match_jax(rng, n, k, tile_h):
    """Plain kernels 8/9 from a non-identity carry-in (another population's
    composite) under a random cotangent; both sides get the same binning,
    final colour, carry and cotangent."""
    cfg_j, cfg_t, jp, tp = case(rng, n, k, tile_h)
    jb = jtl.bin_splats(jp, cfg_j, k)
    tb = to_torch(jb)
    fin, _ = trdn.forward_tiled(tb, cfg_t)
    pre = params_from_numpy({f: getattr(random_splats(rng, 30, W, H), f)
                             for f in FIELDS}, "cpu")
    c_in, t_in = trdn.forward_tiled(ttl.bin_splats(pre, cfg_t, k), cfg_t)
    g = rng.normal(size=(H, W, 3)).astype(np.float32)
    gj = jrp.backward_tiled(jb, jnp.asarray(fin.numpy()), jnp.asarray(g), n,
                            cfg_j, jp, carry_in=(jnp.asarray(c_in.numpy()),
                                                 jnp.asarray(t_in.numpy())))
    before = dict(trdn.launches)
    gt = trdn.backward_tiled(tb, fin, torch.tensor(g), n, cfg_t, tp,
                             carry_in=(c_in, t_in))
    assert trdn.launches == before
    assert_grads_close(gt, gj)


@pytest.mark.parametrize("n,k,tile_h", CASES)
def test_l2_render_and_grads_matches_jax(rng, n, k, tile_h):
    cfg_j, cfg_t, jp, tp = case(rng, n, k, tile_h)
    ref = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    jb = jtl.bin_splats(jp, cfg_j, k)
    Cj, gj = jrp.l2_render_and_grads(
        jb, jrp.pad_ref_chw(jnp.asarray(ref), cfg_j), n, cfg_j, jp)
    Ct, gt = trdn.l2_render_and_grads(to_torch(jb),
                                      trd.pad_ref_chw(ref, cfg_t), n, cfg_t,
                                      tp)
    assert Ct.shape == (H, W, 3)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), atol=1e-6)
    assert_grads_close(gt, gj)
    # The fused path is the forward plus the backward under C - ref.
    gm = trdn.backward_tiled(to_torch(jb), Ct, Ct - torch.tensor(ref), n,
                             cfg_t, tp)
    for f in FIELDS:
        assert torch.equal(getattr(gm, f), getattr(gt, f)), f


def test_segment_grads_tile_order(rng):
    """_segment_grads adds each splat's (tile, slot) partials in tile order
    and drops padded slots."""
    _, cfg_t, _, tp = case(rng, 40, 64, 16)
    b = ttl.bin_splats(tp, cfg_t, 64)
    partial = torch.tensor(rng.normal(size=(b.ids.shape[0], 64, 9)),
                           dtype=torch.float32)
    got = trdn._segment_grads(b, partial, 40)
    want = np.zeros((40, 9), np.float32)
    ids, count = b.ids.numpy(), b.count.numpy()
    for t in range(ids.shape[0]):
        for s in range(count[t]):
            want[ids[t, s]] += partial[t, s].numpy()
    np.testing.assert_array_equal(got.opacity.numpy(), want[:, 8])
    np.testing.assert_array_equal(got.pos.numpy(), want[:, :2])


def test_five_step_dense_fit_matches_jax():
    """Five steps of the port's dense fit against gs2d_tpu's fit with the
    fused dense step on the same pcg3d init and target: per-step MSE within
    rtol 1e-5."""
    kw = dict(width=W, height=H, n_splats=64, tile_h=16, binning="dense")
    ref = synthetic_target(H, W)
    _, hist_j = jloop.fit(jnp.asarray(ref), JaxConfig(**kw), 5, log_every=1,
                          log_fn=None, use_fused=True)
    _, hist_t = tloop.fit(ref, SplatConfig(**kw), 5, "cpu", log_every=1,
                          log_fn=None)
    got = [rec["mse"] for rec in hist_t]
    np.testing.assert_allclose(got, [rec["mse"] for rec in hist_j],
                               rtol=1e-5)
    assert got[-1] < got[0]


@pytest.mark.parametrize("argv", [[], ["--ssim", "0.2"]])
def test_cli_dense_fit_on_cpu(tmp_path, capsys, argv):
    rc = cli.main([MINI, "--splats", "40", "--iters", "2", "--log-every",
                   "1", "--device", "cpu", "--binning", "dense", "--out",
                   str(tmp_path), *argv])
    assert rc == 0
    out = capsys.readouterr().out
    assert "0 itr, mse" in out and "1 itr, mse" in out
    assert (tmp_path / "render_final.png").read_bytes()[:8] \
        == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("kw", [
    dict(binning="dense"),
    dict(width=3840, height=2160, n_splats=1024),
    dict(width=1920, height=1080, n_splats=2000),
])
def test_resolve_binning_dense_where_jax_is(kw):
    """--binning dense, and "auto" for small populations whose resident
    table does not fit (the 3840x2160 fit with 1024 splats)."""
    assert jrpf.resolve_binning(JaxConfig(tile_h=32, **kw)) == "dense"
    assert trd.resolve_binning(SplatConfig(tile_h=32, **kw)) == "dense"


def test_dense_wrapper_rejects_other_devices_and_ids_only(rng):
    _, cfg_t, _, tp = case(rng, 16, 64, 16)
    b = ttl.bin_splats(tp, cfg_t, 64)
    with pytest.raises(ValueError):
        trdn.forward_tiled(b._replace(tile_params=b.tile_params.to("meta")),
                           cfg_t)
    with pytest.raises(ValueError):
        trdn.forward_tiled(ttl.bin_splats(tp, cfg_t, 64, ids_only=True),
                           cfg_t)
