"""The port's adaptive density control on the CPU, against gs2d_tpu's
(``gs2d_tpu/train/densify.py``; its Pallas kernels in interpret mode):
``densify_and_prune`` (decisions integer-equal, the new state bitwise),
``opacity_reset`` (bitwise), the fused step's densify signal
``pos_grad_mag`` (``with_grad_mag``), ``fit_adaptive`` (the live count of
every window, the MSEs), the scanned fit against the eager one bit for bit,
the refusals, the overflow report of the final window, and the CLI's two
densify routes. Every input comes from a seeded numpy generator; no test
draws anything else at random (``test_inputs_are_seeded``)."""

import ast
import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gs2d_tpu import params as jparams
from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.ops import render_pallas as jrp
from gs2d_tpu.train import adam as jadam
from gs2d_tpu.train import densify as jdensify
from gs2d_tpu.train import loop as jloop
from gs2d_tpu_torch import cli
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.io.image import synthetic_target
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.params import DEAD_POS, FIELDS, params_from_numpy
from gs2d_tpu_torch.train import adam as tadam
from gs2d_tpu_torch.train import densify as tdensify
from gs2d_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "assets", "squirrel_cls_mini.npy")
H, W = 32, 64


# --- densify_and_prune / opacity_reset against gs2d_tpu ----------------------

def _population(seed, n, *, big=0.2, dead=4):
    """Seeded splats and Adam state as numpy: some dead slots, some
    degenerate (both sigmas at the floor), some transparent (opacity at the
    floor), some above the split threshold; m and v strictly positive, so
    a zeroed row marks a touched slot."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p = {
        "pos": np.stack([rng.uniform(0, W - 1, n), rng.uniform(0, H - 1, n)],
                        -1).astype(f32),
        "sx": rng.uniform(1.0, 20.0, n).astype(f32),
        "sy": rng.uniform(1.0, 20.0, n).astype(f32),
        "rot": rng.uniform(0, np.pi, n).astype(f32),
        "color": rng.uniform(0, 1, (n, 3)).astype(f32),
        "opacity": rng.uniform(0.1, 1.0, n).astype(f32),
    }
    k = rng.permutation(n)
    nb = int(big * n)
    p["sx"][k[:nb]] = rng.uniform(24.5, 60.0, nb)
    p["sx"][k[nb:nb + 5]] = 1.0                      # degenerate
    p["sy"][k[nb:nb + 5]] = rng.choice([1.0, 1.005, 3.0], 5)
    p["opacity"][k[nb + 5:nb + 10]] = rng.choice([0.1, 0.105, 0.2], 5)
    dead_k = k[n - dead:]
    p["pos"][dead_k] = DEAD_POS
    p["sx"][dead_k] = p["sy"][dead_k] = 1.0
    p["rot"][dead_k] = p["opacity"][dead_k] = 0.0
    p["color"][dead_k] = 0.0
    mom = {f: rng.uniform(0.1, 1.0, v.shape).astype(f32) for f, v in p.items()}
    var = {f: rng.uniform(0.1, 1.0, v.shape).astype(f32) for f, v in p.items()}
    opt = {"m": mom, "v": var, "beta1t": f32(0.9 ** 7),
           "beta2t": f32(0.99 ** 7), "step": np.int32(7)}
    return p, opt


def _jax_state(p, opt):
    return jloop.TrainState(
        params=jparams.GaussianParams(**{f: jnp.asarray(v)
                                         for f, v in p.items()}),
        opt=jadam.AdamState(
            m=jparams.GaussianParams(**{f: jnp.asarray(v)
                                        for f, v in opt["m"].items()}),
            v=jparams.GaussianParams(**{f: jnp.asarray(v)
                                        for f, v in opt["v"].items()}),
            beta1t=jnp.asarray(opt["beta1t"]),
            beta2t=jnp.asarray(opt["beta2t"]),
            step=jnp.asarray(opt["step"])))


def _torch_state(p, opt, device="cpu"):
    return tloop.TrainState(params=params_from_numpy(p, device),
                            opt=tadam.adam_state_from_numpy(opt, device))


def _leaves_np(state):
    """The 21 leaves of either package's TrainState as numpy, in gs2d_tpu's
    pytree order."""
    if isinstance(state, tloop.TrainState):
        return [t.detach().cpu().numpy() for t in tloop.state_leaves(state)]
    return [np.asarray(x) for x in jax.tree.leaves(state)]


def _decisions(before_pos, leaves):
    """Per slot, from a densify's output leaves: touched (every m and v
    entry zeroed), kill (alive before and touched: a live slot is a target
    only if it was killed) and filled (touched and alive after)."""
    n = len(FIELDS)
    moments = leaves[n:3 * n]
    touched = np.ones(before_pos.shape[0], bool)
    for x in moments:
        touched &= (x.reshape(x.shape[0], -1) == 0).all(axis=1)
    alive_before = before_pos[:, 0] > DEAD_POS * 0.5
    alive_after = leaves[0][:, 0] > DEAD_POS * 0.5
    return (touched.astype(int), (alive_before & touched).astype(int),
            (touched & alive_after).astype(int))


def _signal(seed, n, kind):
    rng = np.random.default_rng(seed + 1000)
    if kind == "zero":
        return np.zeros(n, np.float32)
    if kind == "ties":
        # Few distinct values: the stable sort's index order decides.
        return rng.integers(0, 4, n).astype(np.float32)
    return rng.exponential(1.0, n).astype(np.float32)


@pytest.mark.parametrize("case,seed,n,signal,opacity,big", [
    ("random", 0, 64, "random", True, 0.2),
    ("ties", 1, 64, "ties", True, 0.2),
    ("all-zero signal", 2, 64, "zero", True, 0.2),
    ("clone only", 3, 64, "random", True, 0.0),
    ("mostly split", 4, 64, "random", True, 0.75),
    ("opacity frozen", 5, 64, "ties", False, 0.3),
    ("no free slot", 6, 64, "random", False, 0.2),
])
def test_densify_matches_jax(case, seed, n, signal, opacity, big):
    """Decisions integer-equal (touched, kill, filled, per slot) and the
    params and Adam state bitwise gs2d_tpu's on the same inputs."""
    p, opt = _population(seed, n, big=big, dead=0 if case == "no free slot"
                         else 4)
    if case == "no free slot":
        p["sx"] = np.maximum(p["sx"], 2.0)  # nothing degenerate: no kill
    g = _signal(seed, n, signal)
    kw = dict(width=W, height=H, n_splats=n, optimize_opacity=opacity)
    seed_d = 10 * seed + 3
    want = _leaves_np(jdensify.densify_and_prune(
        _jax_state(p, opt), jnp.asarray(g), JaxConfig(**kw), seed=seed_d))
    got = _leaves_np(tdensify.densify_and_prune(
        _torch_state(p, opt), torch.as_tensor(g), SplatConfig(**kw),
        seed=seed_d))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and np.array_equal(a, b), f"leaf {i}"
    touched, kill, filled = _decisions(p["pos"], got)
    for x, y in zip((touched, kill, filled), _decisions(p["pos"], want)):
        np.testing.assert_array_equal(x, y)
    # Each case exercises what it names.
    if case == "all-zero signal":
        assert filled.sum() == 0 and kill.sum() > 0
    elif case == "no free slot":
        assert touched.sum() == 0
    else:
        assert filled.sum() > 0
    if case == "mostly split":
        assert (got[1] < p["sx"]).any()  # donors shrunk in place
    if case == "clone only":
        assert np.array_equal(got[1][~touched.astype(bool)],
                              p["sx"][~touched.astype(bool)])


@pytest.mark.parametrize("value", [0.3, 0.05])
def test_opacity_reset_matches_jax(value):
    p, opt = _population(7, 48)
    cfg = dict(width=W, height=H, n_splats=48, optimize_opacity=True)
    want = _leaves_np(jdensify.opacity_reset(_jax_state(p, opt),
                                             JaxConfig(**cfg), value))
    got = _leaves_np(tdensify.opacity_reset(_torch_state(p, opt),
                                            SplatConfig(**cfg), value))
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert (got[5] <= np.float32(value)).all()


def test_live_count_matches_jax():
    p, _ = _population(8, 64)
    assert int(tdensify.n_live(params_from_numpy(p, "cpu"))) == int(
        jdensify.n_live(jparams.GaussianParams(
            **{f: jnp.asarray(v) for f, v in p.items()}))) == 60


# --- the densify signal in the fused step ------------------------------------

@pytest.mark.parametrize("jit", [True, False])
def test_grad_mag_is_bitwise_jnp_norm(jit):
    """loop.grad_mag equals gs2d_tpu's jnp.linalg.norm(g, axis=-1) bit for
    bit, jitted and eager, over 30 decades of magnitude and zeros. (Where
    a square is subnormal, below 1e-19, XLA's CPU flushes it to zero and
    PyTorch keeps it; such a signal ranks last either way.)"""
    rng = np.random.default_rng(11)
    g = (rng.uniform(-1.0, 1.0, (4096, 2))
         * 10.0 ** rng.uniform(-15, 15, (4096, 1))).astype(np.float32)
    g[:8] = [[0, 0], [0, -0.0], [1e-18, 0], [3, 4], [-3, 4], [1e18, 1e18],
             [0, 5e-18], [1.5, -1e-3]]
    norm = lambda x: jnp.linalg.norm(x, axis=-1)  # noqa: E731
    want = np.asarray((jax.jit(norm) if jit else norm)(jnp.asarray(g)))
    got = tloop.grad_mag(torch.as_tensor(g)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_sqrt_is_rounded_to_nearest():
    """loop._sqrt_rn is numpy's (IEEE) float32 square root over 60 decades,
    where torch.sqrt on the CPU misses it by an ulp now and then."""
    rng = np.random.default_rng(12)
    a = (10.0 ** rng.uniform(-44, 38, 200_000)).astype(np.float32)
    a[:4] = [0.0, 93557188722688.0, np.inf, 1.0]
    got = tloop._sqrt_rn(torch.as_tensor(a)).numpy()
    assert np.array_equal(got, np.sqrt(a))


@pytest.fixture(scope="module")
def signal_case():
    cfg_kw = dict(width=W, height=H, n_splats=32, max_splats_per_tile=32)
    ref = synthetic_target(H, W)
    js = jloop.init_train_state(JaxConfig(**cfg_kw))
    _, aux = jloop.make_train_step_fused(JaxConfig(**cfg_kw), True)(
        js, jrp.pad_ref_chw(jnp.asarray(ref), JaxConfig(**cfg_kw)))
    return cfg_kw, ref, np.asarray(aux.pos_grad_mag)


def test_step_signal_matches_jax(signal_case):
    """pos_grad_mag of the port's fused step (plain kernels) against
    gs2d_tpu's make_train_step_fused(cfg, True), Pallas in interpret mode,
    at 32 splats on 32x64: within 1e-5 relative, and 1e-5 of the largest
    signal (the components of dL/d pos are cancelling sums; the smallest
    signals differ up to 3.6e-5 of themselves)."""
    cfg_kw, ref, want = signal_case
    cfg = SplatConfig(**cfg_kw)
    state = tloop.init_train_state(cfg, "cpu")
    _, aux = tloop.make_train_step_fused(cfg, True)(
        state, rd.pad_ref_chw(ref, cfg, "cpu"))
    got = aux.pos_grad_mag.numpy()
    assert got.shape == (32,) and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.max()))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("binning,margin", [("resident", 0.0),
                                            ("flat", 2.0)])
def test_signal_off_leaves_the_step_unchanged(binning, margin):
    """with_grad_mag=False runs the operations of the step without the
    argument and gives its bits; True adds exactly the operations of
    ``loop.grad_mag`` to a
    step, and a scanned block adds one in-place sum a step, and changes
    no other bit."""
    cfg = SplatConfig(width=64, height=48, n_splats=40, tile_h=32,
                      binning=binning, rebin_margin=margin)
    state = tloop.init_train_state(cfg, "cpu")
    cfg = tdensify._retune(state.params, cfg)
    ref = rd.pad_ref_chw(synthetic_target(48, 64), cfg, "cpu")
    runs = {}
    for name, fn in (("default", lambda: tloop.make_train_step_fused(cfg)),
                     ("off", lambda: tloop.make_train_step_fused(cfg, False)),
                     ("on", lambda: tloop.make_train_step_fused(cfg, True))):
        with _Ops() as rec:
            s, aux = fn()(state, ref)
        runs[name] = (rec.ops, s, aux)
    g0 = torch.zeros((40, 2))
    with _Ops() as rec:
        tloop.grad_mag(g0)
    signal = sorted(rec.ops)
    assert runs["off"][0] == runs["default"][0]
    extra = list(runs["on"][0])
    for op in runs["off"][0]:
        extra.remove(op)
    assert sorted(extra) == signal
    for name in ("off", "on"):
        for a, b in zip(tloop.state_leaves(runs[name][1]),
                        tloop.state_leaves(runs["default"][1])):
            assert torch.equal(a, b)
        assert torch.equal(runs[name][2].mse, runs["default"][2].mse)
    assert runs["off"][2].pos_grad_mag == 0
    # The scanned block: the same ops a step, plus the signal and its sum.
    scans = {}
    for on in (False, True):
        with _Ops() as rec:
            s, aux = tloop.make_fit_scan_fused(cfg, on)(state, ref, 2)
        scans[on] = (rec.ops, s, aux)
    extra = list(scans[True][0])
    for op in scans[False][0]:
        extra.remove(op)
    assert sorted(extra) == sorted(["aten.zeros_like"]
                                   + 2 * (signal + ["aten.add_"]))
    assert torch.equal(scans[True][2].mse, scans[False][2].mse)


# --- fit_adaptive against gs2d_tpu -------------------------------------------

def _adaptive_start(opacity=False):
    """32 splats on 32x64 with splats 0-9 dead (parked at DEAD_POS, reset
    as a prune resets them), so the first densify refills 8 (a quarter of
    N) and the second the other 2. (gs2d_tpu's own test collapses them to
    the scale floor instead; they regrow above the prune threshold within
    ten steps, and no densify acts.)"""
    kw = dict(width=W, height=H, n_splats=32, max_splats_per_tile=32,
              optimize_opacity=opacity)
    return kw, synthetic_target(H, W)


def _kill_jax(state):
    p = state.params
    d = jnp.arange(p.sx.shape[0]) < 10
    return state.replace(params=p.replace(
        pos=jnp.where(d[:, None], DEAD_POS, p.pos),
        sx=jnp.where(d, 1.0, p.sx), sy=jnp.where(d, 1.0, p.sy),
        rot=jnp.where(d, 0.0, p.rot), opacity=jnp.where(d, 0.0, p.opacity),
        color=jnp.where(d[:, None], 0.0, p.color)))


def _kill_torch(state):
    p = state.params
    p.pos[:10] = DEAD_POS
    p.sx[:10] = p.sy[:10] = 1.0
    p.rot[:10] = p.opacity[:10] = 0.0
    p.color[:10] = 0.0
    return state


ADAPTIVE = {"eager": dict(scan_chunk=0), "scan 5": dict(scan_chunk=5),
            "opacity reset": dict(scan_chunk=5, opacity_reset_every=20)}


@pytest.fixture(scope="module")
def jax_adaptive():
    """gs2d_tpu's fit_adaptive in the three variants: (history, the live
    count after every densify, the first window's signal), recorded by
    wrapping its densify_and_prune."""
    out = {}
    for name, kw in ADAPTIVE.items():
        cfg_kw, ref = _adaptive_start(opacity="opacity_reset_every" in kw)
        cfg = JaxConfig(**cfg_kw)
        seen = []
        orig = jdensify.densify_and_prune

        def spy(state, g, *a, **k):
            new = orig(state, g, *a, **k)
            seen.append((int(jdensify.n_live(new.params)), np.asarray(g)))
            return new

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jdensify, "densify_and_prune", spy)
            _, hist = jdensify.fit_adaptive(
                jnp.asarray(ref), cfg, iterations=40, densify_every=10,
                state=_kill_jax(jloop.init_train_state(cfg)),
                log_every=1, log_fn=None, **kw)
        out[name] = (hist, [s[0] for s in seen], seen[0][1])
    return out


def _torch_adaptive(scan_chunk=0, opacity_reset_every=0, iters=40,
                    every=10, **kw):
    cfg_kw, ref = _adaptive_start(opacity=bool(opacity_reset_every))
    cfg = SplatConfig(**{**cfg_kw, **kw.pop("cfg", {})})
    lines = []
    state, hist = tdensify.fit_adaptive(
        ref, cfg, iters, every, "cpu",
        state=_kill_torch(tloop.init_train_state(cfg, "cpu")),
        scan_chunk=scan_chunk, opacity_reset_every=opacity_reset_every,
        log_every=1, log_fn=lines.append, **kw)
    steps = [r for r in hist if "iter" in r]
    events = [r for r in hist if r.get("event") == "densify"]
    return state, steps, events, lines


@pytest.mark.parametrize("name", list(ADAPTIVE))
def test_fit_adaptive_matches_jax(jax_adaptive, name):
    """32 splats, 40 iterations, densify every 10 (eager, scan_chunk 5, and
    with an opacity reset at 20): the live count after every window equal
    to gs2d_tpu's, every MSE within 1e-4 relative, the first window's
    signal within 1e-4 relative; the dead slots are refilled."""
    want_hist, want_live, want_g = jax_adaptive[name]
    seen = []
    orig = tdensify.densify_and_prune

    def spy(state, g, *a, **k):
        seen.append(g.clone())
        return orig(state, g, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdensify, "densify_and_prune", spy)
        _, steps, events, _ = _torch_adaptive(**ADAPTIVE[name])
    assert [e["n_live"] for e in events] == want_live
    assert [e["at"] for e in events] == [10, 20, 30]
    assert want_live == [30, 32, 32]  # 22 live, refilled 8 then 2
    assert [r["iter"] for r in steps] == [r["iter"] for r in want_hist] \
        == list(range(40))
    np.testing.assert_allclose([r["mse"] for r in steps],
                               [r["mse"] for r in want_hist], rtol=1e-4)
    np.testing.assert_allclose(seen[0].numpy(), want_g, rtol=1e-4)


def test_fit_adaptive_improves_on_the_plain_fit():
    """gs2d_tpu's rule (test_fit_adaptive_refills_and_improves): the
    adaptive fit ends at most 1.02x the MSE of the same 40 steps without
    densify, from the same start (22 live splats)."""
    cfg_kw, ref = _adaptive_start()
    cfg = SplatConfig(**cfg_kw)
    _, steps, _, _ = _torch_adaptive()
    _, hist = tloop.fit(ref, cfg, 40, "cpu", log_every=39, log_fn=None,
                        state=_kill_torch(
                            tloop.init_train_state(cfg, "cpu")))
    assert steps[-1]["mse"] < hist[-1]["mse"] * 1.02


@pytest.mark.parametrize("binning,margin,chunk", [
    ("resident", 0.0, 3), ("resident", 2.0, 4), ("flat", 2.0, 3)])
def test_scanned_adaptive_equals_eager_bitwise(binning, margin, chunk):
    """24 iterations, densify every 8: the scanned fit (blocks of
    ``chunk``, which need not divide the
    window) equals the eager one bit for bit: every MSE, every live count,
    the final state. With big splats (init sigmas 18-30) densify splits as
    well as clones; under a margin each block bins afresh from the
    densified params, so a split or clone right after a cached block drops
    no pair, and the lazy blocks equal the eager steps, which bin exactly
    every step."""
    extra = dict(cfg=dict(binning=binning, rebin_margin=margin, tile_h=32,
                          init_scale_min=18.0, init_scale_max=30.0,
                          max_splats_per_tile=None))
    s_e, st_e, ev_e, _ = _torch_adaptive(0, iters=24, every=8, **extra)
    s_s, st_s, ev_s, _ = _torch_adaptive(chunk, iters=24, every=8, **extra)
    assert [r["mse"] for r in st_s] == [r["mse"] for r in st_e]
    assert [(e["n_live"], e["window_drops"]) for e in ev_s] == \
        [(e["n_live"], e["window_drops"]) for e in ev_e]
    assert all(r["n_dropped"] == 0 for r in st_s)
    assert all(e["window_drops"] == 0 for e in ev_s)
    for a, b in zip(tloop.state_leaves(s_s), tloop.state_leaves(s_e)):
        assert torch.equal(a, b)
    if margin:
        assert sum(r["rebinned"] for r in st_s) < len(st_s)


def test_split_after_a_cached_block():
    """Right after a cached lazy block, densify splits and clones into the
    dead slots, outside the block's cache; the next block bins afresh
    from the densified params: its first step's cache holds, and no pair
    is dropped."""
    cfg = SplatConfig(width=64, height=48, n_splats=40, tile_h=32,
                      rebin_margin=2.0, init_scale_min=18.0,
                      init_scale_max=30.0)
    state = _kill_torch(tloop.init_train_state(cfg, "cpu"))
    cfg = tl.tune_tile_capacity(state.params, cfg)
    ref = rd.pad_ref_chw(synthetic_target(48, 64), cfg, "cpu")
    fit_k = tloop.make_fit_scan_fused(cfg, True)
    state, aux = fit_k(state, ref, 4)
    assert int(aux.rebinned.sum()) == 0  # the cache held
    new = tdensify.densify_and_prune(state, aux.pos_grad_mag, cfg, seed=4)
    assert int(tdensify.n_live(new.params)) == 40
    assert (new.params.sx[10:] < state.params.sx[10:]).any()  # split donors
    stale = tloop._fused_step_body(cfg).make_bin_cache(state.params)
    assert not bool(tl.pairs_covered_by(new.params, tloop.GaussianParams(
        **dict(zip(FIELDS, stale[3:]))), cfg, cfg.rebin_margin))
    _, aux = fit_k(new, ref, 4)
    assert int(aux.rebinned[0]) == 0 and int(aux.n_dropped.sum()) == 0


def test_fit_adaptive_repeats_bit_for_bit():
    runs = [_torch_adaptive(5)[1] for _ in range(2)]
    assert [r["mse"] for r in runs[0]] == [r["mse"] for r in runs[1]]


# --- refusals, overflow reports, one fitter per cfg --------------------------

def test_fit_adaptive_refuses_a_window_below_one():
    cfg = SplatConfig(width=W, height=H, n_splats=8)
    for every in (0, -3):
        with pytest.raises(ValueError, match="densify_every"):
            tdensify.fit_adaptive(synthetic_target(H, W), cfg, 10, every,
                                  "cpu")


def test_overflow_in_the_final_window_is_reported():
    """One window, no densify after it: gs2d_tpu never reads its drops."""
    cfg = SplatConfig(width=W, height=H, n_splats=32, max_splats_per_tile=4)
    lines = []
    _, hist = tdensify.fit_adaptive(synthetic_target(H, W), cfg, 6, 10,
                                    "cpu", log_fn=lines.append)
    warn = [x for x in lines if x.startswith("WARNING")]
    assert len(warn) == 1 and "final window, ending at 6" in warn[0]
    assert not any(r.get("event") == "densify" for r in hist)


@pytest.mark.parametrize("scan_chunk", [0, 5])
def test_overflow_retunes_and_one_fitter_per_cfg(scan_chunk):
    """A window that drops pairs is reported and re-tunes the capacity; the
    fit builds one step or scanned fitter per cfg, not one per window."""
    made = []
    orig = (tloop.make_fit_scan_fused if scan_chunk
            else tloop.make_train_step_fused)

    def spy(cfg, *a):
        made.append(cfg.max_splats_per_tile)
        return orig(cfg, *a)

    name = "make_fit_scan_fused" if scan_chunk else "make_train_step_fused"
    cfg = SplatConfig(width=W, height=H, n_splats=32, max_splats_per_tile=4)
    lines = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdensify, name, spy)
        _, hist = tdensify.fit_adaptive(
            synthetic_target(H, W), cfg, 30, 10, "cpu",
            scan_chunk=scan_chunk, log_fn=lines.append)
    warn = [x for x in lines if "re-tuning" in x]
    assert len(warn) == 1 and "window ending at 10" in warn[0]
    assert made[0] == 4 and len(made) == 2 and made[1] > 4
    events = [r for r in hist if r.get("event") == "densify"]
    assert [e["window_drops"] > 0 for e in events] == [True, False]


# --- the CLI's two routes ----------------------------------------------------

def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("argv,msg", [
    (["--densify-every", "-1"], "--densify-every must be >= 0"),
    (["--opacity-reset-every", "-2"], "--opacity-reset-every must be >= 0"),
    (["--opacity-reset-every", "4", "--densify-every", "2"],
     "needs --optimize-opacity"),
    (["--opacity-reset-every", "4", "--optimize-opacity"],
     "needs --densify-every"),
    (["--opacity-reset-every", "4", "--optimize-opacity", "--densify-every",
      "2", "--ssim", "0.2"], "modular densify route"),
    (["--densify-every", "2", "--recover"], "--recover fits without"),
    (["--densify-every", "2", "--save-render-every", "2"],
     "fit_adaptive route"),
])
def test_cli_refusals(tmp_path, capsys, argv, msg):
    with pytest.raises(SystemExit) as e:
        cli.main([MINI, "--device", "cpu", "--iters", "1", "--out",
                  str(tmp_path), *argv])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


def test_cli_adaptive_route(tmp_path):
    """The default route is fit_adaptive: live counts after each window,
    global iteration numbers on a resumed run, no note line."""
    out = str(tmp_path)
    rc, printed = _cli([MINI, "--device", "cpu", "--splats", "24",
                        "--iters", "8", "--log-every", "1",
                        "--densify-every", "3", "--optimize-opacity",
                        "--opacity-reset-every", "5", "--scan-chunk", "2",
                        "--out", out])
    assert rc == 0 and "note:" not in printed
    lines = [x for x in printed.splitlines() if x.startswith("densify/")]
    assert lines == [f"densify/prune at iter {i}: 24 of 24 splats live"
                     for i in (3, 6)]
    rc, printed = _cli([MINI, "--device", "cpu", "--splats", "24",
                        "--iters", "8", "--log-every", "4",
                        "--densify-every", "3", "--checkpoint-every", "4",
                        "--out", out + "/ck"])
    rc, printed = _cli([MINI, "--device", "cpu", "--splats", "24",
                        "--iters", "4", "--log-every", "1",
                        "--densify-every", "3", "--resume",
                        "--out", out + "/ck"])
    assert rc == 0 and "resumed from checkpoint step 8" in printed
    assert "8 itr" in printed and "11 itr" in printed
    assert "densify/prune at iter 11: " in printed


def test_cli_modular_route(tmp_path):
    """--checkpoint-every (or --ssim) takes the block route: gs2d_tpu's note
    line, densify at block boundaries, checkpoints at global steps."""
    out = str(tmp_path)
    rc, printed = _cli([MINI, "--device", "cpu", "--splats", "24",
                        "--iters", "12", "--log-every", "4",
                        "--densify-every", "4", "--checkpoint-every", "4",
                        "--out", out])
    assert rc == 0
    lines = printed.splitlines()
    assert lines[0].startswith("note: --densify-every with --ssim/"
                               "--checkpoint-every uses the modular")
    assert [x for x in lines if x.startswith("densify/")] == [
        "densify/prune at iter 4", "densify/prune at iter 8"]
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == [
        "step_12.npz", "step_4.npz", "step_8.npz"]
    rc, printed = _cli([MINI, "--device", "cpu", "--splats", "24",
                        "--iters", "4", "--log-every", "2", "--ssim", "0.2",
                        "--densify-every", "2", "--out", out + "/ssim"])
    assert rc == 0 and "note:" in printed
    assert "densify/prune at iter 2" in printed


def test_modular_signal_is_the_l2_gradient():
    """The modular route's signal: |dL/d pos| of 0.5 * sum((C - ref)^2)
    through production_render, against gs2d_tpu's Pallas fused step's
    signal at the same state (the same function; 1e-5 relative)."""
    cfg_kw = dict(width=W, height=H, n_splats=32, max_splats_per_tile=32)
    cfg = SplatConfig(**cfg_kw)
    ref = synthetic_target(H, W)
    state = tloop.init_train_state(cfg, "cpu")
    got = tdensify.l2_grad_mag(state.params, torch.as_tensor(ref), cfg)
    js = jloop.init_train_state(JaxConfig(**cfg_kw))
    _, aux = jloop.make_train_step_fused(JaxConfig(**cfg_kw), True)(
        js, jrp.pad_ref_chw(jnp.asarray(ref), JaxConfig(**cfg_kw)))
    want = np.asarray(aux.pos_grad_mag)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(want.max()))


# --- determinism guard -------------------------------------------------------

def test_inputs_are_seeded():
    """This file draws nothing unseeded: no hypothesis, no global numpy or
    torch generator, and every numpy generator gets a seed."""
    tree = ast.parse(open(__file__).read())
    names = {a.name for n in ast.walk(tree)
             if isinstance(n, (ast.Import, ast.ImportFrom))
             for a in n.names} | {n.module for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)}
    assert not any("hypothesis" in (x or "") for x in names)
    for n in ast.walk(tree):
        if not isinstance(n, ast.Call):
            continue
        fn = ast.unparse(n.func)
        if fn.startswith("np.random.") or fn.startswith("torch.rand"):
            assert fn == "np.random.default_rng" and len(n.args) == 1, fn
