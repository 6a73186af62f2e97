"""PyTorch port training path vs the JAX package on the CPU: Adam, a short
fit against gs2d_tpu's fused train step (resident layout, Pallas kernel in
interpret mode), the fit loop's tripwires, and the CLI."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.ops import render_pallas as jrp
from gs2d_tpu.params import GaussianParams as JaxParams
from gs2d_tpu.train import adam as jadam
from gs2d_tpu.train import loop as jloop
from gs2d_tpu_torch import cli
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.io.image import synthetic_target
from gs2d_tpu_torch.params import FIELDS, params_from_numpy
from gs2d_tpu_torch.train import adam as tadam
from gs2d_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

H, W = 48, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "assets", "squirrel_cls_mini.npy")


def _rand_tree(rng, n):
    d = {"pos": rng.uniform(-2, 70, (n, 2)), "sx": rng.uniform(0.5, 12, n),
         "sy": rng.uniform(0.5, 12, n), "rot": rng.uniform(-1, 4, n),
         "color": rng.uniform(-0.2, 1.2, (n, 3)),
         "opacity": rng.uniform(0, 1, n)}
    return {k: v.astype(np.float32) for k, v in d.items()}


@pytest.mark.parametrize("kw", [
    dict(), dict(optimize_opacity=True),
    dict(lr_decay_iters=4, learning_rate=0.1, lr_final=0.01),
])
def test_adam_update_matches_jax(rng, kw):
    """Three chained updates with random grads: parameters, moments, bias
    powers and step equal the JAX update (dead slot 2 stays frozen)."""
    n = 33
    cfg_j = JaxConfig(width=W, height=H, **kw)
    cfg_t = SplatConfig(width=W, height=H, **kw)
    p = _rand_tree(rng, n)
    p["pos"][2, 0] = -1e6
    jp, tp = JaxParams(**p), params_from_numpy(p, "cpu")
    js, ts = jadam.init_adam_state(jp), tadam.init_adam_state(tp)
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in p.items()}
        jp, js = jadam.adam_update(jp, JaxParams(**g), js, cfg_j)
        tp, ts = tadam.adam_update(tp, params_from_numpy(g, "cpu"), ts,
                                   cfg_t)
    # The same float32 program, except that XLA's CPU backend may contract
    # a*b + c into one FMA (1 ulp) and rounds pow (the lr decay) its own way.
    rtol = 2e-6 if kw.get("lr_decay_iters") else 3e-7
    for f in FIELDS:
        for a, b in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            np.testing.assert_allclose(getattr(a, f).numpy(),
                                       np.asarray(getattr(b, f)),
                                       rtol=rtol, atol=0, err_msg=f)
    assert float(ts.beta1t) == float(js.beta1t)
    assert float(ts.beta2t) == float(js.beta2t)
    assert int(ts.step) == int(js.step) == 3
    assert float(tp.pos[2, 0]) == -1e6


def test_five_step_fit_matches_jax_fused_step():
    """Five steps of the port's fit against gs2d_tpu's make_train_step_fused
    on the same pcg3d init and target: per-step MSE within rtol 1e-5."""
    kw = dict(width=W, height=H, n_splats=64, tile_h=32,
              max_splats_per_tile=64)
    cfg_j, cfg_t = JaxConfig(**kw), SplatConfig(**kw)
    ref = synthetic_target(H, W)
    step = jloop.make_train_step_fused(cfg_j)
    state = jloop.init_train_state(cfg_j)
    ref_chw = jrp.pad_ref_chw(jnp.asarray(ref), cfg_j)
    want = []
    for _ in range(5):
        state, aux = step(state, ref_chw)
        want.append(float(aux.mse))
    _, hist = tloop.fit(ref, cfg_t, 5, "cpu", log_every=1, log_fn=None)
    got = [rec["mse"] for rec in hist]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_fit_tunes_capacity_and_warns_once_on_overflow():
    cfg = SplatConfig(width=W, height=H, n_splats=64, tile_h=8,
                      max_splats_per_tile=4)
    lines = []
    state, hist = tloop.fit(synthetic_target(H, W), cfg, 3, "cpu",
                            log_every=1, log_fn=lines.append)
    warns = [x for x in lines if x.startswith("WARNING: binning capacity")]
    assert len(warns) == 1 and len(hist) == 3
    assert int(state.opt.step) == 3


def test_fit_nan_tripwire():
    cfg = SplatConfig(width=W, height=H, n_splats=16, tile_h=8,
                      max_splats_per_tile=16)
    state = tloop.init_train_state(cfg, "cpu")
    state.params.color[3, 0] = float("nan")
    with pytest.raises(FloatingPointError):
        tloop.fit(synthetic_target(H, W), cfg, 2, "cpu", state=state,
                  log_every=1, log_fn=None)


def test_fit_window_layout_on_cpu():
    """fit with binning="window" tunes K and the window width itself and
    trains through the window step: its MSE trajectory equals the resident
    fit's bit for bit, with no pair dropped or escaped."""
    kw = dict(width=W, height=H, n_splats=64, tile_h=32)
    ref = synthetic_target(H, W)
    _, h_w = tloop.fit(ref, SplatConfig(binning="window", **kw), 3, "cpu",
                       log_every=1, log_fn=None)
    _, h_r = tloop.fit(ref, SplatConfig(binning="resident", **kw), 3, "cpu",
                       log_every=1, log_fn=None)
    assert [r["mse"] for r in h_w] == [r["mse"] for r in h_r]
    assert [r["n_dropped"] for r in h_w] == [0, 0, 0]


def test_cli_cpu_fit_on_mini_asset(tmp_path, capsys):
    rc = cli.main([MINI, "--splats", "16", "--iters", "2", "--log-every",
                   "1", "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "0 itr, mse" in out and "1 itr, mse" in out
    assert (tmp_path / "render_final.png").read_bytes()[:8] \
        == b"\x89PNG\r\n\x1a\n"
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3  # two logged steps and the summary


def test_cli_cuda_without_gpu_exits_2(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is visible")
    rc = cli.main([MINI, "--iters", "1", "--out", str(tmp_path)])
    assert rc == 2
    assert "no CUDA GPU" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--mesh", "1,2,2"],
                                  ["--renderer", "pallas"]])
def test_cli_rejects_flags_of_later_slices(tmp_path, argv):
    with pytest.raises(SystemExit) as e:
        cli.main([MINI, "--device", "cpu", "--out", str(tmp_path), *argv])
    assert e.value.code == 2


def test_cli_rejects_unported_layout(tmp_path, capsys):
    """The window layout is no --binning choice, in gs2d_tpu's CLI or the
    port's: argparse exits 2 (it is reached through train.loop.fit)."""
    with pytest.raises(SystemExit) as e:
        cli.main([MINI, "--splats", "8192", "--binning", "window",
                  "--device", "cpu", "--out", str(tmp_path)])
    assert e.value.code == 2
    assert "invalid choice: 'window'" in capsys.readouterr().err
