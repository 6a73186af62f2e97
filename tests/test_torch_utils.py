"""Support modules of the PyTorch port on the CPU: visualization and the
eigen helpers against gs2d_tpu's, profiling, and the hardware guard (the
counterparts of tests/test_utils.py TestVisualize / TestProfiling and of
tests/test_hardware_guard.py).

Tolerances: the eigen helpers are the same float32 program as gs2d_tpu's
but for XLA's FMA contraction and its sqrt: 1e-6 relative (of the larger
eigenvalue where the smaller one cancels); the overlays are
drawn from them on an integer grid and must agree on all but a few pixels
(a line end that rounds the other way).
"""

import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.ops import geometry as jgeo
from gs2d_tpu.params import init_params as jax_init_params
from gs2d_tpu.utils.visualize import overlay_splats as jax_overlay
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import geometry as tgeo
from gs2d_tpu_torch.params import init_params
from gs2d_tpu_torch.utils import hardware
from gs2d_tpu_torch.utils.profiling import (JsonlLogger, ThroughputCounter,
                                            device_trace)
from gs2d_tpu_torch.utils.visualize import overlay_splats


def test_eigen_helpers_match_jax():
    rng = np.random.default_rng(5)
    n = 257
    sx = rng.uniform(0.5, 40.0, n).astype(np.float32)
    sy = rng.uniform(0.5, 40.0, n).astype(np.float32)
    sy[:8] = sx[:8]  # isotropic: a repeated eigenvalue
    rot = rng.uniform(-4.0, 4.0, n).astype(np.float32)
    cov_j = jgeo.cov_of(jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(rot))
    # Both packages from the same covariance entries.
    cov_t = tuple(torch.as_tensor(np.array(v)) for v in cov_j)
    want = jgeo.eigenvalues_2x2(*cov_j)
    got = tgeo.eigenvalues_2x2(*cov_t)
    # lambda1 = mean - d cancels: 1e-6 of the larger eigenvalue.
    scale = float(np.asarray(want[0]).max())
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6 * scale)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5)
    assert (got[0] >= got[1]).all()
    e_want = jgeo.eigenvectors_of_cov(*cov_j, want[0])
    e_got = tgeo.eigenvectors_of_cov(*cov_t, torch.as_tensor(
        np.array(want[0])))
    for g, w in zip(e_got, e_want):
        assert g.shape == (n, 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(e_got[0].norm(dim=-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose((e_got[0] * e_got[1]).sum(-1).numpy(), 0.0,
                               atol=1e-6)


class TestVisualize:
    def test_overlay_draws_within_bounds(self):
        cfg = SplatConfig(width=64, height=48, n_splats=8)
        p = init_params(cfg, "cpu")
        base = np.zeros((48, 64, 3), np.float32)
        img = overlay_splats(base, p, cfg)
        assert img.shape == base.shape
        assert img.max() > 0.0  # something was drawn
        assert img.min() >= 0.0 and img.max() <= 1.0

    def test_overlay_flags(self):
        cfg = SplatConfig(width=64, height=48, n_splats=4)
        p = init_params(cfg, "cpu")
        base = np.zeros((48, 64, 3), np.float32)
        none = overlay_splats(base, p, cfg, draw_axes=False,
                              draw_ellipse=False, draw_bbox=False)
        np.testing.assert_array_equal(none, base)
        two = overlay_splats(base, p, cfg, max_splats=2)
        assert 0 < (two != base).sum() < (overlay_splats(base, p, cfg)
                                          != base).sum()

    def test_overlay_info_text(self):
        """show_info draws the per-splat index:opacity readout (the
        reference's showSplatInfo toggle, main.cpp:479-484)."""
        cfg = SplatConfig(width=64, height=48, n_splats=4)
        p = init_params(cfg, "cpu")
        base = np.zeros((48, 64, 3), np.float32)
        geo = overlay_splats(base, p, cfg, draw_axes=False,
                             draw_ellipse=False, draw_bbox=False)
        txt = overlay_splats(base, p, cfg, draw_axes=False,
                             draw_ellipse=False, draw_bbox=False,
                             show_info=True)
        assert (txt != geo).any()  # glyph pixels were added
        assert txt.max() <= 1.0

    def test_overlay_matches_jax(self):
        kw = dict(width=96, height=64, n_splats=12)
        base = np.full((64, 96, 3), 0.25, np.float32)
        want = jax_overlay(base, jax_init_params(JaxConfig(**kw)),
                           JaxConfig(**kw), show_info=True)
        got = overlay_splats(base, init_params(SplatConfig(**kw), "cpu"),
                             SplatConfig(**kw), show_info=True)
        differ = (np.abs(got - want).max(axis=-1) > 0).sum()
        assert (want != base).any(axis=-1).sum() > 500
        assert differ <= 8, differ


class TestProfiling:
    def test_throughput_counter(self):
        tc = ThroughputCounter(100, 200, 1000)
        r = tc.rates(0.5)
        assert r["iters_per_s"] == 2.0
        assert r["pixels_per_s"] == 2 * 100 * 200 * 2
        assert r["gaussians_per_s"] == 2 * 1000 * 2

    def test_jsonl_logger(self, tmp_path):
        path = str(tmp_path / "m.jsonl")
        lg = JsonlLogger(path)
        lg.log(iter=1, mse=2.0)
        lg.log(iter=2, mse=1.0)
        lg.close()
        recs = [json.loads(line) for line in open(path)]
        assert [r["iter"] for r in recs] == [1, 2]
        assert all("t" in r for r in recs)

    def test_jsonl_logger_null(self):
        lg = JsonlLogger(None)
        lg.log(x=1)  # no-op, no crash
        lg.close()

    def test_device_trace_writes_a_chrome_trace(self, tmp_path):
        log_dir = str(tmp_path / "trace")
        with device_trace(log_dir) as prof:
            torch.ones(64, 64) @ torch.ones(64, 64)
        trace = json.load(open(os.path.join(log_dir, "trace.json")))
        assert trace["traceEvents"]
        assert any("mm" in ev.key for ev in prof.key_averages())


def _run(kind):
    hardware.warn_if_untuned.cache_clear()
    orig = hardware._device_kind
    hardware._device_kind = lambda: kind
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            ok = hardware.warn_if_untuned.__wrapped__()
        return ok, [str(x.message) for x in w]
    finally:
        hardware._device_kind = orig
        hardware.warn_if_untuned.cache_clear()


class TestHardwareGuard:
    def test_cpu_silent(self):
        ok, msgs = _run("cpu")
        assert ok and not msgs

    def test_h100_silent(self):
        for kind in ("nvidia h100 80gb hbm3", "nvidia h100 pcie"):
            ok, msgs = _run(kind)
            assert ok and not msgs, kind

    def test_other_cuda_device_warns_once(self):
        ok, msgs = _run("nvidia a100-sxm4-80gb")
        assert not ok
        assert len(msgs) == 1
        assert "re-sweep" in msgs[0] and "a100" in msgs[0]
        for name in ("RESIDENT_THRESHOLD", "FLAT_THRESHOLD",
                     "SAT_WALK_THRESHOLD", "tune_tile_height"):
            assert name in msgs[0]

    def test_real_backend_does_not_warn_on_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is visible")
        hardware._device_kind.cache_clear()
        hardware.warn_if_untuned.cache_clear()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert hardware.warn_if_untuned()
            # The policies that consult the guard stay silent too.
            from gs2d_tpu_torch.ops import render as rd
            from gs2d_tpu_torch.ops import tiles as tl

            cfg = SplatConfig(width=64, height=48, n_splats=9000)
            assert rd.resolve_binning(cfg) == "flat" and rd._sat_walk(cfg)
            tl.tune_tile_height(cfg.replace(n_splats=8), init_params(
                cfg.replace(n_splats=8), "cpu"))
        assert not w
        assert hardware.card_line("cpu") == "cpu"

    def test_resolve_budget(self, monkeypatch):
        orig = hardware._device_kind
        try:
            for kind, want in (("cpu", 1000), ("nvidia h100 80gb hbm3", 1000),
                               ("nvidia h100 nvl", 300_000)):
                hardware._device_kind = lambda kind=kind: kind
                assert hardware.resolve_budget("smem_per_block", want) == want
            # Another card: the smaller of its own figure and the H100's,
            # with the warning.
            hardware._device_kind = lambda: "nvidia a100-sxm4-80gb"
            hardware.warn_if_untuned.cache_clear()
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                assert hardware.resolve_budget("smem_per_block",
                                               166_912) == 166_912
                assert hardware.resolve_budget("smem_per_block",
                                               10 ** 6) == 232_448
            assert len(w) == 1
            monkeypatch.setenv("GS2D_SMEM_PER_BLOCK", "4096")
            assert hardware.resolve_budget("smem_per_block", 1000) == 4096
        finally:
            hardware._device_kind = orig
            hardware.warn_if_untuned.cache_clear()
