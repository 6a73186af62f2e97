"""The port's scanned fit on the CPU: ``make_fit_scan_fused`` with lazy
rebinning against gs2d_tpu's (its Pallas kernels in interpret mode), and
the scanned fit against the port's own eager fit bit for bit, with
``_fit_scanned``'s rules (global iteration numbers, a chunk that does not
divide the iterations, checkpoints at block ends, the non-finite abort,
the all-rebin warning, the split-step rule), and the CLI's
``--scan-chunk``, ``--rebin-margin`` and ``--opacity-cull``. On the CPU the
scanned step body runs in a Python loop; tests/test_torch_cuda.py holds the
CUDA graph to the eager step on the card."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.ops import render_pallas as jrp
from gs2d_tpu.ops import render_pallas_flat as jrpf
from gs2d_tpu.train import loop as jloop
from gs2d_tpu_torch import cli
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.io.image import synthetic_target
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_flat as rf
from gs2d_tpu_torch.params import FIELDS
from gs2d_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "assets", "squirrel_cls_mini.npy")


@pytest.mark.parametrize("layout,h,w,margin,lr", [
    ("resident", 48, 64, 4.0, 0.05), ("resident", 48, 64, 0.25, 0.5),
    ("flat", 64, 128, 4.0, 0.05)])
def test_lazy_scan_matches_jax(layout, h, w, margin, lr):
    """gs2d_tpu's tests/test_resident.py and test_lazy_flat.py scans, 12
    steps of 64 splats from the same init: MSE within 1e-5 and the
    rebinned flags equal step by step (margin 0.25 at lr 0.5 makes the
    cache miss)."""
    kw = dict(width=w, height=h, n_splats=64, tile_h=32, binning=layout,
              rebin_margin=margin, learning_rate=lr)
    if layout == "resident":
        kw["max_splats_per_tile"] = 64
    cfg_j, cfg_t = JaxConfig(**kw), SplatConfig(**kw)
    js = jloop.init_train_state(cfg_j)
    ts = tloop.init_train_state(cfg_t, "cpu")
    if layout == "flat":
        cfg_j = jrpf.tune_flat_config(js.params, cfg_j)
        cfg_t = rf.tune_flat_config(ts.params, cfg_t)
        assert (cfg_t.flat_capacity, cfg_t.max_tiles_per_splat) == \
            (cfg_j.flat_capacity, cfg_j.max_tiles_per_splat)
    ref = synthetic_target(h, w)
    _, ja = jloop.make_fit_scan_fused(cfg_j)(
        js, jrp.pad_ref_chw(jnp.asarray(ref), cfg_j), 12)
    _, ta = tloop.make_fit_scan_fused(cfg_t)(
        ts, rd.pad_ref_chw(ref, cfg_t, "cpu"), 12)
    np.testing.assert_allclose(ta.mse.numpy(), np.asarray(ja.mse),
                               rtol=1e-5)
    np.testing.assert_array_equal(ta.rebinned.numpy(),
                                  np.asarray(ja.rebinned))
    assert int(ta.rebinned.sum()) < 12
    if margin < 1.0:
        assert int(ta.rebinned.sum()) > 0


def _fit(cfg, iters, **kw):
    ckpts = []
    state, hist = tloop.fit(
        synthetic_target(cfg.height, cfg.width), cfg, iters, "cpu",
        log_every=1, log_fn=None, checkpoint_every=3,
        checkpoint_fn=lambda s, it: ckpts.append(
            (it, [getattr(s.params, f).clone() for f in FIELDS])), **kw)
    return state, hist, ckpts


@pytest.mark.parametrize("binning,margin,lr", [
    ("resident", 0.0, 0.05), ("resident", 2.0, 0.05),
    ("resident", 0.25, 0.5), ("flat", 2.0, 0.05), ("flat", 0.25, 0.5),
    ("dense", 2.0, 0.05), ("window", 0.0, 0.05)])
def test_scan_equals_eager_bitwise(binning, margin, lr):
    """8 iterations in blocks of 3 (3, 3, 2) from iteration 7 equal the
    eager fit bit for bit: MSEs, checkpointed and final params; history
    and checkpoints carry global iteration numbers and block-relative
    steps. Margined lists add only pairs that cover no pixel."""
    cfg = SplatConfig(width=64, height=48, n_splats=40, tile_h=32,
                      binning=binning, rebin_margin=margin,
                      learning_rate=lr)
    s_e, h_e, c_e = _fit(cfg, 8, iter_offset=7)
    s_s, h_s, c_s = _fit(cfg, 8, iter_offset=7, scan_chunk=3)
    assert [r["iter"] for r in h_s] == list(range(7, 15))
    assert [r["mse"] for r in h_s] == [r["mse"] for r in h_e]
    assert [r["n_dropped"] for r in h_s] == [0] * 8
    assert [it for it, _ in c_s] == [it for it, _ in c_e] == [3, 6]
    for (_, a), (_, b) in zip(c_s, c_e):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for f in FIELDS:
        assert torch.equal(getattr(s_s.params, f), getattr(s_e.params, f))
    rebins = sum(r["rebinned"] for r in h_s)
    if binning in ("resident", "flat") and margin == 0.25:
        assert rebins > 0
    if margin == 0.0 or binning in ("dense", "window"):
        assert rebins == 0


def test_scan_ssim_equals_eager_bitwise():
    """The modular step (SSIM objective) scanned equals its eager fit."""
    cfg = SplatConfig(width=64, height=48, n_splats=32, tile_h=32)
    _, h_e, _ = _fit(cfg, 5, ssim_lambda=0.2)
    _, h_s, _ = _fit(cfg, 5, ssim_lambda=0.2, scan_chunk=2)
    assert [r["mse"] for r in h_s] == [r["mse"] for r in h_e]


def test_scan_nonfinite_abort_names_the_iteration():
    """A divergent fit (lr 1e38) aborts at the same global iteration
    scanned as eager: the first non-finite one, inside its block."""
    cfg = SplatConfig(width=64, height=48, n_splats=32, tile_h=32,
                      learning_rate=1e38)
    msgs = []
    for chunk in (0, 4):
        with pytest.raises(FloatingPointError) as e:
            tloop.fit(synthetic_target(48, 64), cfg, 12, "cpu", log_every=1,
                      log_fn=None, scan_chunk=chunk, iter_offset=100)
        msgs.append(str(e.value).split(" (")[0])
    assert msgs[0] == msgs[1] == \
        "non-finite splat parameters at iteration 106"


def test_scan_warns_when_every_step_rebins():
    """A slot grid smaller than the splats' footprints fails the tripwire
    on every step: one warning for an 8-step block, results unchanged."""
    cfg = SplatConfig(width=64, height=48, n_splats=32, tile_h=8,
                      rebin_margin=2.0, max_tiles_per_splat=2,
                      max_splats_per_tile=64)
    logs = []
    _, hist = tloop.fit(synthetic_target(48, 64), cfg, 8, "cpu",
                        log_every=1, log_fn=logs.append, scan_chunk=8)
    assert [r["rebinned"] for r in hist] == [1] * 8
    warn = [x for x in logs if "rebinned on every step" in x]
    assert len(warn) == 1 and "8-step block" in warn[0]


def test_scan_chunk_ignored_for_the_split_step(monkeypatch):
    """Where the flat capacity needs gs2d_tpu's split step (every flat
    capacity, with SPLIT_STEP_ROWS at 0), scan_chunk is ignored with its
    message and the fit runs the split step from the eager loop."""
    monkeypatch.setattr(tloop, "SPLIT_STEP_ROWS", 0)
    cfg = SplatConfig(width=64, height=48, n_splats=64, binning="flat")
    logs = []
    _, hist = tloop.fit(synthetic_target(48, 64), cfg, 2, "cpu",
                        log_every=1, log_fn=logs.append, scan_chunk=4)
    assert logs[0] == ("scan_chunk ignored: flat capacity exceeds the "
                       "single-program memory budget (split steps)")
    assert [r["iter"] for r in hist] == [0, 1]
    assert "rebinned" not in hist[0]  # the eager loop's records


def _metrics(out):
    return [json.loads(x) for x in (out / "metrics.jsonl").read_text()
            .splitlines()]


@pytest.mark.parametrize("argv", [
    ["--scan-chunk", "4", "--rebin-margin", "2"],
    ["--scan-chunk", "4", "--opacity-cull"],
    ["--scan-chunk", "3", "--rebin-margin", "-1"]])
def test_cli_scanned_fit(tmp_path, capsys, argv):
    """The CLI's scanned fits on the CPU: 6 iterations logged with global
    numbers and rebin flags, and the fit of the eager CLI bit for bit
    (the opacity cull and the auto margin as well)."""
    base = [MINI, "--splats", "16", "--iters", "6", "--log-every", "1",
            "--device", "cpu"]
    assert cli.main(base + ["--out", str(tmp_path / "eager"),
                            *[a for a in argv if a not in ("--scan-chunk",
                                                           "4", "3")]]) == 0
    assert cli.main(base + ["--out", str(tmp_path / "scan"), *argv]) == 0
    out = capsys.readouterr().out
    eager, scan = _metrics(tmp_path / "eager"), _metrics(tmp_path / "scan")
    assert [r["iter"] for r in scan[:-1]] == list(range(6))
    assert [r["mse"] for r in scan[:-1]] == [r["mse"] for r in eager[:-1]]
    assert all(r["rebinned"] in (0, 1) for r in scan[:-1])
    if "-1" in argv:
        assert out.count("rebin margin 2.0 (auto)") == 2


def test_cli_flag_defaults():
    """gs2d_tpu's defaults: no scan, margin 0, no cull; a bare
    --opacity-cull is the reference's 1/256."""
    p = cli.build_parser()
    a = p.parse_args([MINI])
    assert (a.scan_chunk, a.rebin_margin, a.opacity_cull) == (0, 0.0, 0.0)
    assert p.parse_args([MINI, "--opacity-cull"]).opacity_cull == 1 / 256
    assert p.parse_args([MINI, "--opacity-cull", "0.01"]).opacity_cull \
        == 0.01
