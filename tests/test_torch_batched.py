"""The port's several-image fitting on the CPU, against gs2d_tpu's (its
Pallas kernels in interpret mode) and against the port's own one-image fits:

- ``parallel.sharded.init_batched_state`` / ``pad_ref_batch`` bitwise
  gs2d_tpu's, the images in memory of their own;
- ``make_batched_train_step_fused`` against gs2d_tpu's on the resident and
  flat layouts (tests/test_fused.py:158-182, 337-365), and image by image
  against the port's one-image step bit for bit on every layout;
- ``make_fit_scan_batched`` against the batched eager step bit for bit,
  with the images in either order and the signal's sum continued across
  calls, and its lazy flat case against gs2d_tpu's (tests/test_fused.py:
  367-400, its 1e-4 / 2e-4);
- ``densify_and_prune_batched`` bitwise gs2d_tpu's ``vmap``;
  ``fit_adaptive_batched`` against gs2d_tpu's in both configurations of
  tests/test_densify.py:194-230 (live counts equal, MSEs within 1e-4), and
  each image bit for bit the port's ``fit_adaptive`` on that image;
- the CLI's several-image route on the CPU, its refusals and its refusal
  of images of unequal sizes.

Every state starts from gs2d_tpu's, carried across as numpy
(``loop.state_from_numpy``); every target is ``synthetic_target`` of a
seed, every population a seeded numpy generator's.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.io.image import synthetic_target as jax_target
from gs2d_tpu.ops import render_pallas as jrp
from gs2d_tpu.ops import render_pallas_flat as jrpf
from gs2d_tpu.parallel import sharded as jsharded
from gs2d_tpu.params import init_params as jinit_params
from gs2d_tpu.train import adam as jadam
from gs2d_tpu.train import densify as jdensify
from gs2d_tpu.train import loop as jloop
from gs2d_tpu_torch import cli
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.io.image import synthetic_target
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_flat as rf
from gs2d_tpu_torch.ops import render_window as rw
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.params import DEAD_POS, FIELDS
from gs2d_tpu_torch.parallel import sharded as tsharded
from gs2d_tpu_torch.train import densify as tdensify
from gs2d_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

H, W = 48, 64


def _np_leaves(state):
    if isinstance(state, tloop.TrainState):
        return [t.detach().cpu().numpy() for t in tloop.state_leaves(state)]
    return [np.asarray(x) for x in jax.tree.leaves(state)]


def _to_torch(jstate):
    return tloop.state_from_numpy(_np_leaves(jstate), "cpu")


def _refs(seeds, h=H, w=W):
    return [synthetic_target(h, w, seed=s) for s in seeds]


def _pad(refs, cfg):
    return torch.stack([rd.pad_ref_chw(r, cfg, "cpu") for r in refs])


def _jax_pad(refs, cfg):
    return jnp.stack([jrp.pad_ref_chw(jnp.asarray(r), cfg) for r in refs])


# --- batched init ------------------------------------------------------------

def test_init_batched_state_matches_jax():
    """gs2d_tpu's init_batched_state is its one-image init broadcast over
    the batch: the port's equals that of gs2d_tpu's ``init_params`` bitwise
    (tests/test_torch_numerics.py holds the init itself), and gs2d_tpu's
    own within 1 ulp (its jitted init lets XLA fuse the init's
    multiply-adds on the CPU). The padded targets are bitwise its. Each
    image's leaves are memory of their own (Adam writes them)."""
    kw = dict(width=W, height=H, n_splats=24)
    js = jsharded.init_batched_state(JaxConfig(**kw), 3)
    p = jinit_params(JaxConfig(**kw))
    eager = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (3,) + x.shape),
                         jloop.TrainState(params=p, opt=jadam.init_adam_state(
                             p)))
    ts = tsharded.init_batched_state(SplatConfig(**kw), 3, "cpu")
    for a, b, c in zip(_np_leaves(ts), _np_leaves(eager), _np_leaves(js)):
        assert a.shape == b.shape == c.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_max_ulp(a, c, maxulp=1)
    for t in tloop.state_leaves(ts):
        assert t.is_contiguous() and t.stride(0) == t[0].numel()
    pos = ts.params.pos
    before = pos[1].clone()
    pos[0] += 1.0
    assert torch.equal(pos[1], before)
    refs = np.stack(_refs((0, 1, 2), 40, 60))
    cfg = SplatConfig(width=60, height=40)
    np.testing.assert_array_equal(
        tsharded.pad_ref_batch(refs, cfg, "cpu").numpy(),
        np.asarray(jsharded.pad_ref_batch(
            refs, JaxConfig(width=60, height=40))))


# --- the batched step --------------------------------------------------------

LAYOUTS = {
    "resident": dict(n_splats=32, max_splats_per_tile=32),
    "flat": dict(n_splats=96, binning="flat", flat_chunk=32),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_batched_step_matches_jax(layout):
    """gs2d_tpu's tests/test_fused.py batched cases (two targets of seeds 0
    and 2): one batched step from the same numbers, the MSEs within 1e-6
    relative and every parameter within 1e-6."""
    kw = dict(width=W, height=H, **LAYOUTS[layout])
    cfg_j, cfg_t = JaxConfig(**kw), SplatConfig(**kw)
    if layout == "flat":
        cfg_j = jrpf.tune_flat_config(jinit_params(cfg_j), cfg_j)
        cfg_t = cfg_t.replace(flat_capacity=cfg_j.flat_capacity,
                              flat_max_chunks=cfg_j.flat_max_chunks)
    refs = _refs((0, 2))
    js = jsharded.init_batched_state(cfg_j, 2)
    js2, ja = jloop.make_batched_train_step_fused(cfg_j)(
        js, _jax_pad(refs, cfg_j))
    ts2, ta = tloop.make_batched_train_step_fused(cfg_t)(
        _to_torch(js), _pad(refs, cfg_t))
    assert ta.mse.shape == ta.psnr.shape == ta.all_finite.shape == (2,)
    np.testing.assert_allclose(ta.mse.numpy(), np.asarray(ja.mse), rtol=1e-6)
    assert bool(ta.all_finite.all()) and int(ta.n_dropped) == 0
    for f in FIELDS:
        np.testing.assert_allclose(getattr(ts2.params, f).numpy(),
                                   np.asarray(getattr(js2.params, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


def _port_cfg(layout, n=40):
    cfg = SplatConfig(width=W, height=H, n_splats=n, tile_h=32,
                      binning=layout)
    p = tloop.init_train_state(cfg, "cpu").params
    if layout == "flat":
        return rf.tune_flat_config(p, cfg)
    cfg = tl.tune_tile_capacity(p, cfg)
    return rw.tune_window(p, cfg) if layout == "window" else cfg


@pytest.mark.parametrize("layout", ["resident", "flat", "dense", "window"])
def test_batched_step_equals_single_bitwise(layout):
    """Two batched steps of two images equal two one-image steps on each
    image bit for bit: every leaf, the MSEs and PSNRs; n_dropped summed,
    one finite flag broadcast to (B,)."""
    cfg = _port_cfg(layout)
    refs = _pad(_refs((0, 2)), cfg)
    state = tsharded.init_batched_state(cfg, 2, "cpu")
    bstep = tloop.make_batched_train_step_fused(cfg)
    sstep = tloop.make_train_step_fused(cfg)
    singles = [tloop.state_index(state, i) for i in range(2)]
    for _ in range(2):
        state, aux = bstep(state, refs)
        outs = [sstep(singles[i], refs[i]) for i in range(2)]
        singles = [o[0] for o in outs]
        assert torch.equal(aux.mse, torch.stack([o[1].mse for o in outs]))
        assert torch.equal(aux.psnr, torch.stack([o[1].psnr for o in outs]))
        assert aux.all_finite.tolist() == [True, True]
        assert int(aux.n_dropped) == sum(int(o[1].n_dropped) for o in outs)
    for i in range(2):
        for a, b in zip(tloop.state_leaves(tloop.state_index(state, i)),
                        tloop.state_leaves(singles[i])):
            assert torch.equal(a, b)


# --- the batched scan --------------------------------------------------------

@pytest.mark.parametrize("layout,margin", [("resident", 0.0),
                                           ("resident", 2.0),
                                           ("flat", 2.0)])
def test_batched_scan_equals_eager_bitwise(layout, margin):
    """5 scanned steps (a block of 2, then one of 3 continuing the signal's
    sum) equal 5 batched eager steps bit for bit; with the images in the
    order (1, 0) the same bits come out swapped; each image's signal sum
    equals the one-image scanned fitter's."""
    cfg = _port_cfg(layout).replace(rebin_margin=margin)
    refs = _pad(_refs((0, 2)), cfg)
    state0 = tsharded.init_batched_state(cfg, 2, "cpu")
    # Different populations, so that swapping the images changes the input.
    state0.params.pos[1] += 1.5
    s_e, mse_e = state0, []
    bstep = tloop.make_batched_train_step_fused(cfg)
    for _ in range(5):
        s_e, aux = bstep(s_e, refs)
        mse_e.append(aux.mse)
    fit_k = tloop.make_fit_scan_batched(cfg, True)

    def scanned(state, refs):
        s1, a1 = fit_k(state, refs, 2)
        s2, a2 = fit_k(s1, refs, 3, grad_mag_sum=a1.pos_grad_mag)
        assert a2.mse.shape == (3, 2) and a2.n_dropped.shape == (3,)
        assert a2.pos_grad_mag.shape == (2, cfg.n_splats)
        return s2, torch.cat([a1.mse, a2.mse]), a2.pos_grad_mag

    s_s, mse_s, g_s = scanned(state0, refs)
    assert torch.equal(mse_s, torch.stack(mse_e))
    for a, b in zip(tloop.state_leaves(s_s), tloop.state_leaves(s_e)):
        assert torch.equal(a, b)
    swap = [1, 0]
    s_w, mse_w, g_w = scanned(tloop.state_from_leaves(
        [t[swap] for t in tloop.state_leaves(state0)]), refs[swap])
    assert torch.equal(mse_w, mse_s[:, swap]) and torch.equal(g_w, g_s[swap])
    for a, b in zip(tloop.state_leaves(s_w), tloop.state_leaves(s_s)):
        assert torch.equal(a, b[swap])
    one = tloop.make_fit_scan_fused(cfg, True)
    _, a1 = one(tloop.state_index(state0, 1), refs[1], 5)
    assert torch.equal(a1.pos_grad_mag, g_s[1])


def test_lazy_flat_batched_scan_matches_jax():
    """gs2d_tpu's tests/test_fused.py lazy flat case: 4 scanned steps at
    rebin margin 2 from the same numbers, every parameter within its
    rtol 1e-4 / atol 2e-4, the rebin flags equal."""
    kw = dict(width=W, height=H, n_splats=96, binning="flat", flat_chunk=32)
    cfg0 = jrpf.tune_flat_config(jinit_params(JaxConfig(**kw)),
                                 JaxConfig(**kw))
    cfg_j = cfg0.replace(rebin_margin=2.0)
    cfg_t = SplatConfig(**kw, rebin_margin=2.0,
                        flat_capacity=cfg0.flat_capacity,
                        flat_max_chunks=cfg0.flat_max_chunks)
    refs = _refs((0, 2))
    js = jsharded.init_batched_state(cfg_j, 2)
    js2, ja = jloop.make_fit_scan_batched(cfg_j)(js, _jax_pad(refs, cfg_j), 4)
    ts2, ta = tloop.make_fit_scan_batched(cfg_t)(_to_torch(js),
                                                _pad(refs, cfg_t), 4)
    assert ta.rebinned.shape == (4,)
    np.testing.assert_array_equal(ta.rebinned.numpy(),
                                  np.asarray(ja.rebinned))
    np.testing.assert_allclose(ta.mse.numpy(), np.asarray(ja.mse), rtol=1e-4)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(ts2.params, f).numpy(),
                                   np.asarray(getattr(js2.params, f)),
                                   rtol=1e-4, atol=2e-4, err_msg=f)


# --- batched densify ---------------------------------------------------------

def _population(seed, n):
    """Seeded splats with dead, degenerate, transparent and big ones, and
    strictly positive Adam moments, as gs2d_tpu pytree leaves (numpy)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p = {"pos": np.stack([rng.uniform(0, W - 1, n), rng.uniform(0, H - 1, n)],
                         -1),
         "sx": rng.uniform(1.0, 40.0, n), "sy": rng.uniform(1.0, 20.0, n),
         "rot": rng.uniform(0, np.pi, n), "color": rng.uniform(0, 1, (n, 3)),
         "opacity": rng.uniform(0.1, 1.0, n)}
    p = {f: v.astype(f32) for f, v in p.items()}
    p["sx"][:4] = p["sy"][:4] = 1.0
    p["opacity"][4:8] = 0.1
    p["pos"][-4:] = DEAD_POS
    moments = [rng.uniform(0.1, 1.0, p[f].shape).astype(f32)
               for _ in range(2) for f in FIELDS]
    return ([p[f] for f in FIELDS] + moments
            + [f32(0.9 ** 5), f32(0.99 ** 5), np.int32(5)])


@pytest.mark.parametrize("optimize_opacity", [True, False])
def test_densify_batched_matches_jax(optimize_opacity):
    """Two populations and signals (one with ties, where the stable sorts
    decide), the same seed for both: every leaf bitwise gs2d_tpu's vmap."""
    n = 48
    leaves = [np.stack(x) for x in zip(_population(1, n), _population(2, n))]
    rng = np.random.default_rng(3)
    g = np.stack([rng.exponential(1.0, n),
                  rng.integers(0, 3, n).astype(np.float64)]).astype(
                      np.float32)
    kw = dict(width=W, height=H, n_splats=n,
              optimize_opacity=optimize_opacity)
    jstate = jax.tree.unflatten(
        jax.tree.structure(jsharded.init_batched_state(JaxConfig(**kw), 2)),
        [jnp.asarray(x) for x in leaves])
    want = jdensify.densify_and_prune_batched(
        jstate, jnp.asarray(g), JaxConfig(**kw), seed=40)
    got = tdensify.densify_and_prune_batched(
        tloop.state_from_numpy(leaves, "cpu"), torch.from_numpy(g),
        SplatConfig(**kw), seed=40)
    for a, b in zip(_np_leaves(got), _np_leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(_np_leaves(got)[0][0], leaves[0][0])


ADAPTIVE = {
    # tests/test_densify.py::test_fit_adaptive_batched_multi_image
    "flat, lazy": (dict(n_splats=32, binning="flat", rebin_margin=2.0),
                   (0, 3), dict(iterations=30, densify_every=10,
                                scan_chunk=5)),
    # tests/test_densify.py::test_fit_adaptive_batched_resident_with_reset
    "resident, resets": (dict(n_splats=32, binning="resident",
                              max_splats_per_tile=32, optimize_opacity=True),
                         (1, 2), dict(iterations=24, densify_every=8,
                                      scan_chunk=4, opacity_reset_every=8)),
}


@pytest.mark.parametrize("name", list(ADAPTIVE))
def test_fit_adaptive_batched_matches_jax(name):
    """gs2d_tpu's two batched adaptive fits at H, W = 32, 64: the live
    count of each image after every window equal (read by wrapping
    gs2d_tpu's densify), every logged MSE within 1e-4 relative, each MSE
    falling; and each image equal bit for bit to the port's fit_adaptive
    on that image alone."""
    cfg_kw, seeds, run = ADAPTIVE[name]
    h = 32
    kw = dict(width=W, height=h, **cfg_kw)
    live_j = []
    orig = jdensify.densify_and_prune_batched

    def spy(state, *a, **k):
        new = orig(state, *a, **k)
        live_j.append([int(jdensify.n_live(jax.tree.map(
            lambda x: x[i], new.params))) for i in range(2)])
        return new

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdensify, "densify_and_prune_batched", spy)
        _, hist_j = jdensify.fit_adaptive_batched(
            [jax_target(h, W, seed=s) for s in seeds], JaxConfig(**kw),
            log_every=1, log_fn=None, **run)
    refs = [synthetic_target(h, W, seed=s) for s in seeds]
    iters, every = run["iterations"], run["densify_every"]
    rest = {k: v for k, v in run.items()
            if k not in ("iterations", "densify_every")}
    state, hist, _ = tdensify.fit_adaptive_batched(
        refs, SplatConfig(**kw), iters, every, "cpu", log_every=1,
        log_fn=None, **rest)
    steps = [r for r in hist if "iter" in r]
    assert [e["n_live"] for e in hist if e.get("event") == "densify"] \
        == live_j
    assert [r["iter"] for r in steps] == list(range(iters))
    np.testing.assert_allclose([r["mse"] for r in steps],
                               [r["mse"] for r in hist_j], rtol=1e-4)
    assert all(steps[-1]["mse"][i] < steps[0]["mse"][i] for i in range(2))
    for i in range(2):
        s_i, h_i = tdensify.fit_adaptive(
            refs[i], SplatConfig(**kw), iters, every, "cpu", log_every=1,
            log_fn=None, **rest)
        assert [r["mse"] for r in h_i if "iter" in r] == \
            [r["mse"][i] for r in steps]
        for a, b in zip(tloop.state_leaves(tloop.state_index(state, i)),
                        tloop.state_leaves(s_i)):
            assert torch.equal(a, b)


def test_fit_adaptive_batched_refusal_and_final_window():
    """densify_every < 1 is refused; an overflow in the final window is
    reported (gs2d_tpu's batched fit skips it) and counted in the history's
    end record."""
    cfg = SplatConfig(width=W, height=32, n_splats=32, max_splats_per_tile=4)
    refs = _refs((0, 1), 32)
    with pytest.raises(ValueError, match="densify_every"):
        tdensify.fit_adaptive_batched(refs, cfg, 4, 0, "cpu")
    lines = []
    _, hist, _ = tdensify.fit_adaptive_batched(refs, cfg, 3, 10, "cpu",
                                               log_fn=lines.append)
    warn = [x for x in lines if x.startswith("WARNING")]
    assert len(warn) == 1 and "final window, ending at 3" in warn[0]
    assert hist[-1]["event"] == "end" and hist[-1]["window_drops"] > 0


def test_fit_adaptive_batched_returns_the_retuned_cfg():
    """A window that overflows re-tunes the shared statics (the max over
    images) before the next, and the fit returns the last window's cfg,
    the one the CLI renders with; a fit that never overflows returns its
    tuned cfg unchanged."""
    cfg = SplatConfig(width=W, height=32, n_splats=32, max_splats_per_tile=4)
    refs = _refs((0, 1), 32)
    lines = []
    _, hist, got = tdensify.fit_adaptive_batched(
        refs, cfg, 6, 3, "cpu", scan_chunk=3, log_fn=lines.append)
    first = next(e for e in hist if e.get("event") == "densify")
    assert first["window_drops"] > 0
    assert any("re-tuning capacities" in x for x in lines)
    assert got.max_splats_per_tile > cfg.max_splats_per_tile
    assert got.replace(max_splats_per_tile=4,
                       max_tiles_per_splat=cfg.max_tiles_per_splat) == cfg
    tuned = tdensify._retune_batched(
        tloop.init_batched_state(cfg.replace(max_splats_per_tile=None), 2,
                                 "cpu").params,
        cfg.replace(max_splats_per_tile=None))
    _, hist, same = tdensify.fit_adaptive_batched(
        refs, tuned, 6, 3, "cpu", scan_chunk=3, log_fn=None)
    assert sum(e.get("window_drops", 0) for e in hist) == 0 and same == tuned


# --- the CLI -----------------------------------------------------------------

def _images(tmp_path, shapes=((H, W), (H, W))):
    paths = []
    for i, (h, w) in enumerate(shapes):
        path = str(tmp_path / f"target_{i}.npy")
        np.save(path, (synthetic_target(h, w, seed=i) * 255).astype(np.uint8))
        paths.append(path)
    return paths


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _steps(out):
    return [json.loads(x) for x in open(os.path.join(out, "metrics.jsonl"))
            if '"iter"' in x]


def test_cli_several_images(tmp_path):
    """Two images on one command line: both renders written; image 0's MSEs
    equal the one-image fit's bit for bit; --scan-chunk equals the eager
    batch; --densify-every takes fit_adaptive_batched; no pair dropped."""
    a, b = _images(tmp_path)
    base = ["--splats", "16", "--iters", "4", "--log-every", "1",
            "--device", "cpu"]
    runs = {}
    for name, extra in (("eager", []), ("scan", ["--scan-chunk", "3"]),
                        ("densify", ["--densify-every", "2"])):
        out = str(tmp_path / name)
        rc, printed = _cli([a, b, *base, *extra, "--out", out])
        assert rc == 0
        assert sorted(x for x in os.listdir(out) if x.endswith(".png")) == \
            ["render_final_00.png", "render_final_01.png"]
        assert "4 iters in" in printed and "0 splat-tile pairs dropped" \
            in printed
        runs[name] = (_steps(out), printed)
    eager = runs["eager"][0]
    assert [len(r["mse"]) for r in eager] == [2] * 4
    assert [r["mse"] for r in runs["scan"][0]] == [r["mse"] for r in eager]
    assert "densify/prune at iter 2: 16, 16 of 16 splats live" in \
        runs["densify"][1]
    rc, _ = _cli([a, *base, "--out", str(tmp_path / "one")])
    one = _steps(str(tmp_path / "one"))
    assert rc == 0 and [r["mse"] for r in one] == [r["mse"][0] for r in eager]


@pytest.mark.parametrize("argv", [
    ["--resume"], ["--recover"], ["--checkpoint-every", "2"],
    ["--ssim", "0.2"], ["--reorder-every", "2"],
    ["--save-render-every", "2"]])
def test_cli_batch_refusals(tmp_path, capsys, argv):
    """gs2d_tpu's batch route refuses these (cli.py:129-136): exit 2."""
    a, b = _images(tmp_path)
    with pytest.raises(SystemExit) as e:
        cli.main([a, b, "--device", "cpu", "--iters", "1", "--out",
                  str(tmp_path / "out"), *argv])
    assert e.value.code == 2
    assert "not supported with several images" in capsys.readouterr().err


def test_cli_refuses_unequal_sizes(tmp_path):
    a, b = _images(tmp_path, ((H, W), (H, W + 8)))
    rc, printed = _cli([a, b, "--device", "cpu", "--iters", "1", "--out",
                        str(tmp_path / "out")])
    assert rc == 2 and "requires equal dimensions" in printed
