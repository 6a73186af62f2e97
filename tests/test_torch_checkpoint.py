"""Checkpoints of the PyTorch port on the CPU: the npz format against
gs2d_tpu's own (a file written by either package loads into the other, leaf
for leaf), retention, resume equal to an uninterrupted fit, recovery from an
injected fault, and the CLI's --checkpoint-every / --resume / --recover /
--save-render-every.

Tolerances: none. A checkpoint carries bits, and a resumed fit repeats the
uninterrupted one bit for bit (the runs are deterministic).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.io import checkpoint as jck
from gs2d_tpu.train import loop as jloop
from gs2d_tpu_torch import cli
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.io import checkpoint as tck
from gs2d_tpu_torch.io.image import synthetic_target
from gs2d_tpu_torch.params import FIELDS
from gs2d_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

H, W = 32, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "assets", "squirrel_cls_mini.npy")
KW = dict(width=W, height=H, n_splats=16, learning_rate=0.07)


def _leaves(state):
    return [x.numpy() for x in tck._leaves(state)]


def _assert_states_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_leaf_order_is_jax_tree_flatten_order():
    state = jloop.init_train_state(JaxConfig(**KW))
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(state)[0]]
    assert paths == [f".{g}.{f}" for g, f in tck.LEAF_ORDER]
    like = tloop.init_train_state(SplatConfig(**KW), "cpu")
    for leaf, x in zip(jax.tree.leaves(state), tck._leaves(like)):
        assert leaf.shape == tuple(x.shape)
        assert np.asarray(leaf).dtype == x.numpy().dtype


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    cfg_j = JaxConfig(**KW)
    ref = jnp.asarray(synthetic_target(H, W))
    state, _ = jloop.fit(ref, cfg_j, iterations=2)
    path = str(tmp_path / "jax.npz")
    jck.save_npz(path, state, cfg_j)
    cfg_t = tck.load_npz_config(path)
    assert cfg_t == SplatConfig(**KW)
    got = tck.load_npz(path, tloop.init_train_state(cfg_t, "cpu"))
    want = [np.asarray(x) for x in jax.tree.leaves(state)]
    assert len(want) == len(tck.LEAF_ORDER) == 21
    for x, y in zip(_leaves(got), want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert int(got.opt.step) == 2 and got.opt.step.dtype == torch.int32
    assert all(getattr(got.params, f).device.type == "cpu" for f in FIELDS)
    # The restored state trains on.
    ref_t = synthetic_target(H, W)
    cont, _ = tloop.fit(ref_t, cfg_t, 1, "cpu", state=got)
    assert int(cont.opt.step) == 3
    assert all(np.isfinite(x).all() for x in _leaves(cont))


def test_port_checkpoint_loads_into_jax(tmp_path):
    cfg_t = SplatConfig(**KW)
    state, _ = tloop.fit(synthetic_target(H, W), cfg_t, 2, "cpu")
    path = str(tmp_path / "torch.npz")
    tck.save_npz(path, state, cfg_t)
    assert os.listdir(tmp_path) == ["torch.npz"]  # no temporary file left
    cfg_j = jck.load_npz_config(path)
    assert cfg_j == JaxConfig(**KW)
    got = jck.load_npz(path, jloop.init_train_state(cfg_j))
    for x, y in zip(jax.tree.leaves(got), _leaves(state)):
        assert np.asarray(x).dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), y)
    # Key for key the file gs2d_tpu writes.
    other = str(tmp_path / "jax.npz")
    jck.save_npz(other, got, cfg_j)
    with np.load(path) as a, np.load(other) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_config_roundtrip_and_missing_config(tmp_path):
    cfg = SplatConfig(**KW, init_color=(0.1, 0.2, 0.3), binning="flat")
    state = tloop.init_train_state(cfg, "cpu")
    p = str(tmp_path / "s.npz")
    tck.save_npz(p, state, cfg)
    assert tck.load_npz_config(p) == cfg
    _assert_states_equal(tck.load_npz(p, state), state)
    tck.save_npz(p, state)
    assert tck.load_npz_config(p) is None


def test_roundtrip_and_retention(tmp_path):
    cfg = SplatConfig(**KW)
    state, _ = tloop.fit(synthetic_target(H, W), cfg, 3, "cpu")
    ck = tck.Checkpointer(str(tmp_path / "ck"), keep=2)
    assert ck.latest_step() is None
    like = tloop.init_train_state(cfg, "cpu")
    assert ck.restore_latest(like) == (None, like)
    for s in (1, 2, 3, 4):
        ck.save(s, state, cfg)
    (tmp_path / "ck" / "notes.txt").write_text("not a checkpoint")
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    _assert_states_equal(ck.restore(3, like), state)
    step, restored = ck.restore_latest(like)
    assert step == 4
    _assert_states_equal(restored, state)


@pytest.mark.parametrize("kw", [dict(), dict(use_fused=False),
                                dict(ssim_lambda=0.2)])
def test_resume_equals_continuous(tmp_path, kw):
    """fit(6) == fit(3) -> checkpoint -> restore -> fit(3), bit for bit:
    the fused L2 step, the modular L2 step and the SSIM step."""
    cfg = SplatConfig(**KW)
    ref = synthetic_target(H, W)
    cont, _ = tloop.fit(ref, cfg, 6, "cpu", **kw)
    half, _ = tloop.fit(ref, cfg, 3, "cpu", **kw)
    ck = tck.Checkpointer(str(tmp_path / "ck"))
    ck.save(3, half, cfg)
    step, restored = ck.restore_latest(tloop.init_train_state(cfg, "cpu"))
    assert step == 3
    resumed, _ = tloop.fit(ref, cfg, 3, "cpu", state=restored, **kw)
    _assert_states_equal(cont, resumed)


def test_checkpoint_hook_gets_block_relative_steps():
    cfg = SplatConfig(**KW)
    seen = []
    tloop.fit(synthetic_target(H, W), cfg, 7, "cpu", checkpoint_every=3,
              checkpoint_fn=lambda s, it: seen.append((it, int(s.opt.step))),
              iter_offset=100)
    assert seen == [(3, 3), (6, 6)]


def test_modular_l2_step_matches_fused_step():
    """use_fused=False trains the same objective through the forward and
    backward kernels' plain versions: the same MSEs to the moments' sum
    order (1e-5 relative over three steps)."""
    cfg = SplatConfig(**KW, max_splats_per_tile=64)
    ref = synthetic_target(H, W)
    _, fused = tloop.fit(ref, cfg, 3, "cpu", log_every=1, log_fn=None)
    _, modular = tloop.fit(ref, cfg, 3, "cpu", log_every=1, log_fn=None,
                           use_fused=False)
    np.testing.assert_allclose([r["mse"] for r in modular],
                               [r["mse"] for r in fused], rtol=1e-5)


def test_raise_on_nonfinite_can_be_left_to_the_caller():
    cfg = SplatConfig(**KW)
    state = tloop.init_train_state(cfg, "cpu")
    state.params.sx[3] = float("nan")
    ref = synthetic_target(H, W)
    with pytest.raises(FloatingPointError):
        tloop.fit(ref, cfg, 1, "cpu", state=state, log_every=1, log_fn=None)
    out, _ = tloop.fit(ref, cfg, 1, "cpu", state=state, log_every=1,
                       log_fn=None, raise_on_nonfinite=False)
    assert not np.isfinite(out.params.sx.numpy()).all()


@pytest.mark.parametrize("raise_on_nonfinite", [True, False])
def test_no_checkpoint_of_a_nonfinite_state(tmp_path, raise_on_nonfinite):
    """A NaN injected into the state after the checkpoint at step 2 makes
    step 3 non-finite: fit saves steps 1 and 2 only, and raises at the
    checkpoint of step 3 (or, leaving the tripwire to the caller, logs and
    skips the saves of steps 3 and 4). Every file written holds finite
    leaves, so fit_with_recovery can never restore a non-finite state."""
    cfg = SplatConfig(**KW)
    ck = tck.Checkpointer(str(tmp_path / "ck"))
    lines = []

    def save(state, it):
        ck.save(it, state, cfg)
        if it == 2:
            state.params.sx[3] = float("nan")

    def run():
        return tloop.fit(synthetic_target(H, W), cfg, 4, "cpu",
                         checkpoint_every=1, checkpoint_fn=save,
                         log_fn=lines.append,
                         raise_on_nonfinite=raise_on_nonfinite)

    if raise_on_nonfinite:
        with pytest.raises(FloatingPointError, match="checkpoint 3 not saved"):
            run()
    else:
        out, _ = run()
        assert not np.isfinite(out.params.sx.numpy()).all()
        assert sum("checkpoint 3 not saved" in x for x in lines) == 1
        assert sum("checkpoint 4 not saved" in x for x in lines) == 1
    assert ck.all_steps() == [1, 2]
    for step in ck.all_steps():
        with np.load(str(tmp_path / "ck" / f"step_{step}.npz")) as z:
            assert all(np.isfinite(z[key]).all() for key in z.files
                       if key.startswith("leaf_"))


def test_recovers_from_injected_fault(tmp_path):
    """The counterpart of gs2d_tpu's TestElasticRecovery: the first call of
    loop.fit runs 3 real iterations, checkpointing, then faults; the recovery
    loop restores the checkpoint, halves the learning rate and completes."""
    cfg = SplatConfig(**KW)
    ref = synthetic_target(H, W)
    ck = tck.Checkpointer(str(tmp_path / "ck"))
    calls = {"n": 0}
    orig_fit = tloop.fit

    def sabotaged_fit(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            orig_fit(args[0], args[1], 3, *args[3:], **kw)
            raise FloatingPointError("injected")
        return orig_fit(*args, **kw)

    lines = []
    tloop.fit = sabotaged_fit
    try:
        state, hist, n_rec = tloop.fit_with_recovery(
            ref, cfg, 6, ck, "cpu", checkpoint_every=2, log_every=1,
            log_fn=lines.append)
    finally:
        tloop.fit = orig_fit
    assert n_rec == 1 and calls["n"] == 2
    assert ck.latest_step() == 6
    assert any("restored checkpoint 2" in x for x in lines)
    assert [r["iter"] for r in hist] == [2, 3, 4, 5]  # global numbers
    saved = tck.load_npz_config(str(tmp_path / "ck" / "step_6.npz"))
    assert saved.learning_rate == KW["learning_rate"] * 0.5
    assert int(state.opt.step) == 6
    assert all(np.isfinite(x).all() for x in _leaves(state))
    # A second call finds the run complete and only saves again.
    again, hist, n_rec = tloop.fit_with_recovery(ref, cfg, 6, ck, "cpu",
                                                 log_fn=None)
    assert n_rec == 0 and hist == []
    _assert_states_equal(again, state)


def test_recovery_gives_up_after_max_recoveries(tmp_path):
    cfg = SplatConfig(**{**KW, "learning_rate": float("inf")})
    ck = tck.Checkpointer(str(tmp_path / "ck"))
    with pytest.raises(FloatingPointError):
        tloop.fit_with_recovery(synthetic_target(H, W), cfg, 4, ck, "cpu",
                                max_recoveries=2, log_every=1, log_fn=None)


def _steps(out):
    return sorted(int(f[len("step_"):-len(".npz")])
                  for f in os.listdir(os.path.join(out, "checkpoints")))


def _iters(out):
    recs = [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))]
    return [r["iter"] for r in recs if "iter" in r]


def test_cli_checkpoints_hold_global_steps_and_resume(tmp_path, capsys):
    out = str(tmp_path / "run")
    base = [MINI, "--splats", "12", "--device", "cpu", "--log-every", "1",
            "--checkpoint-every", "4", "--reorder-every", "8", "--out", out]
    assert cli.main(base + ["--iters", "12"]) == 0
    assert _steps(out) == [4, 8, 12]
    assert "morton reorder at iter 8" in capsys.readouterr().out
    assert cli.main(base + ["--iters", "4", "--resume"]) == 0
    printed = capsys.readouterr().out
    assert "resumed from checkpoint step 12" in printed
    assert "12 itr, mse" in printed and "15 itr, mse" in printed
    assert _steps(out) == [8, 12, 16]  # the newest three
    assert _iters(out) == list(range(16))
    # Resumed and uninterrupted fits agree bit for bit through the CLI too.
    whole = str(tmp_path / "whole")
    assert cli.main(base[:-1] + [whole, "--iters", "16"]) == 0
    with np.load(os.path.join(out, "checkpoints", "step_16.npz")) as a, \
            np.load(os.path.join(whole, "checkpoints", "step_16.npz")) as b:
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])


def test_cli_resume_without_checkpoint_exits_2(tmp_path, capsys):
    out = str(tmp_path / "empty")
    rc = cli.main([MINI, "--splats", "12", "--iters", "2", "--device", "cpu",
                   "--resume", "--out", out])
    assert rc == 2
    assert (f"error: --resume found no checkpoint under "
            f"{os.path.join(out, 'checkpoints')}") in capsys.readouterr().out
    assert not os.path.exists(os.path.join(out, "render_final.png"))


def test_cli_recover_and_render_dumps(tmp_path, capsys):
    out = str(tmp_path / "rec")
    rc = cli.main([MINI, "--splats", "12", "--iters", "4", "--device", "cpu",
                   "--recover", "--checkpoint-every", "2", "--log-every", "2",
                   "--out", out])
    assert rc == 0
    assert "done (0 recoveries)" in capsys.readouterr().out
    assert _steps(out) == [2, 4]
    assert os.path.exists(os.path.join(out, "render_final.png"))
    out = str(tmp_path / "dumps")
    rc = cli.main([MINI, "--splats", "12", "--iters", "5", "--device", "cpu",
                   "--save-render-every", "2", "--out", out])
    assert rc == 0
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    assert pngs == ["render_000002.png", "render_000004.png",
                    "render_final.png"]
    assert not os.path.exists(os.path.join(out, "checkpoints"))


@pytest.mark.parametrize("flag", ["--checkpoint-every",
                                  "--save-render-every"])
def test_cli_refuses_negative_cadence(tmp_path, flag):
    with pytest.raises(SystemExit) as e:
        cli.main([MINI, "--device", "cpu", "--out", str(tmp_path), flag,
                  "-1"])
    assert e.value.code == 2
