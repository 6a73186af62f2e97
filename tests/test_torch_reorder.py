"""Morton reordering of the PyTorch port (``train/reorder.py``) against
gs2d_tpu's on the same numpy inputs, and the CLI's ``--reorder-every``."""

import os

import jax.numpy as jnp
import numpy as np
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.ops import render_pallas as jrp
from gs2d_tpu.params import DEAD_POS
from gs2d_tpu.params import GaussianParams as JaxParams
from gs2d_tpu.train import adam as jadam
from gs2d_tpu.train import loop as jloop
from gs2d_tpu.train import reorder as jro
from gs2d_tpu_torch import cli
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.io.image import synthetic_target
from gs2d_tpu_torch.params import FIELDS, params_from_numpy
from gs2d_tpu_torch.train import loop as tloop
from gs2d_tpu_torch.train import reorder as tro
from gs2d_tpu_torch.train.adam import adam_state_from_numpy
from tests.helpers import random_splats, to_params

torch.set_num_threads(1)

H, W = 48, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "assets", "squirrel_cls_mini.npy")


def _numpy_params(rng, n):
    """Seeded splats with centres off both image edges (the clip), on
    shared grid points (ties for the stable sort) and two dead slots."""
    p = {f: np.asarray(getattr(to_params(random_splats(rng, n, W, H)), f))
         for f in FIELDS}
    p["pos"][:4] = [[-5.0, 3.0], [70.0, 60.0], [10.0, 10.0], [10.0, 10.0]]
    p["pos"][7, 0] = DEAD_POS
    p["pos"][11, 0] = DEAD_POS
    return p


def test_morton_codes_and_perm_equal_jax(rng):
    """Codes integer-equal (int64 against gs2d_tpu's uint32) and the same
    stable permutation, dead slots last."""
    n = 96
    p = _numpy_params(rng, n)
    cfg_j, cfg_t = JaxConfig(width=W, height=H), SplatConfig(width=W, height=H)
    tp = params_from_numpy(p, "cpu")
    want = np.asarray(jro.morton_codes(JaxParams(**p), cfg_j)).astype(
        np.int64)
    np.testing.assert_array_equal(tro.morton_codes(tp, cfg_t).numpy(), want)
    perm = tro.reorder_perm(tp, cfg_t).numpy()
    np.testing.assert_array_equal(
        perm, np.asarray(jro.reorder_perm(JaxParams(**p), cfg_j)))
    assert set(perm[-2:]) == {7, 11}


def test_reorder_state_moves_adam_moments(rng):
    """Parameters and Adam's m and v follow the permutation exactly as in
    gs2d_tpu; the bias powers and the step count do not move."""
    n = 64
    p = _numpy_params(rng, n)
    mv = {k: {f: rng.normal(size=v.shape).astype(np.float32)
              for f, v in p.items()} for k in ("m", "v")}
    cfg_j, cfg_t = JaxConfig(width=W, height=H), SplatConfig(width=W, height=H)
    js = jadam.init_adam_state(JaxParams(**p)).replace(
        m=JaxParams(**mv["m"]), v=JaxParams(**mv["v"]),
        beta1t=jnp.float32(0.5), beta2t=jnp.float32(0.25),
        step=jnp.int32(7))
    want = jro.reorder_state(jloop.TrainState(params=JaxParams(**p), opt=js),
                             cfg_j)
    opt = adam_state_from_numpy({"m": mv["m"], "v": mv["v"], "beta1t": 0.5,
                                 "beta2t": 0.25, "step": 7}, "cpu")
    got = tro.reorder_state(
        tloop.TrainState(params=params_from_numpy(p, "cpu"), opt=opt), cfg_t)
    for f in FIELDS:
        for a, b in ((got.params, want.params), (got.opt.m, want.opt.m),
                     (got.opt.v, want.opt.v)):
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)))
    assert float(got.opt.beta1t) == 0.5 and float(got.opt.beta2t) == 0.25
    assert int(got.opt.step) == 7


def test_fit_reorder_fit_matches_jax():
    """Two fused steps, a reorder, two more: per-step MSE within rtol 1e-5
    of gs2d_tpu's fused step (resident, Pallas in interpret mode) on the
    same pcg3d init; the reorder changes the compositing order, so the
    steps after it differ from an unreordered fit."""
    kw = dict(width=W, height=H, n_splats=48, tile_h=32,
              max_splats_per_tile=64)
    cfg_j, cfg_t = JaxConfig(**kw), SplatConfig(**kw)
    ref = synthetic_target(H, W)
    step = jloop.make_train_step_fused(cfg_j)
    ref_chw = jrp.pad_ref_chw(jnp.asarray(ref), cfg_j)
    state = jloop.init_train_state(cfg_j)
    want = []
    for i in range(4):
        if i == 2:
            state = jro.reorder_state(state, cfg_j)
        state, aux = step(state, ref_chw)
        want.append(float(aux.mse))
    st, h0 = tloop.fit(ref, cfg_t, 2, "cpu", log_every=1, log_fn=None)
    st = tro.reorder_state(st, cfg_t)
    _, h1 = tloop.fit(ref, cfg_t, 2, "cpu", state=st, log_every=1,
                      log_fn=None, iter_offset=2)
    assert [r["iter"] for r in h0 + h1] == [0, 1, 2, 3]
    np.testing.assert_allclose([r["mse"] for r in h0 + h1], want, rtol=1e-5)
    _, plain = tloop.fit(ref, cfg_t, 4, "cpu", log_every=1, log_fn=None)
    assert plain[3]["mse"] != h1[1]["mse"]


def test_cli_reorder_every(tmp_path, capsys):
    """--reorder-every 2 over 5 iterations: blocks of 2, 2 and 1, a reorder
    after the first two, global iteration numbers in the log."""
    rc = cli.main([MINI, "--splats", "12", "--iters", "5", "--log-every",
                   "1", "--reorder-every", "2", "--device", "cpu", "--out",
                   str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert [x for x in out if x.startswith("morton")] == [
        "morton reorder at iter 2", "morton reorder at iter 4"]
    logged = [int(x.split()[0]) for x in out if " itr, mse" in x]
    assert logged == [0, 1, 2, 3, 4]
    assert out.index("morton reorder at iter 2") == 2
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 6  # five logged steps and the summary
