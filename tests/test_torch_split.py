"""The port's train step at flat capacities above ``SPLIT_STEP_ROWS`` on
the CPU, where gs2d_tpu takes its split step (``_make_split_step_fused``)
and the port the same step as at every other capacity (the binner's
temporaries are freed before kernel 11 allocates, so gs2d_tpu's reason to
split has no counterpart). ``SPLIT_STEP_ROWS`` is set to 0 in both
packages, so a small flat cfg counts as one (gs2d_tpu's ``lru_cache``s
cleared before and after, as tests/test_flat.py does):

- the port's step there equals its fused flat step bit for bit, with and
  without the densify signal;
- it equals gs2d_tpu's split step within gs2d_tpu's own tolerance of its
  split against its fused step (tests/test_flat.py: 1e-6);
- ``fit`` and ``fit_adaptive`` with ``scan_chunk`` on such a cfg log
  gs2d_tpu's message and equal their eager fits: nothing of that size is
  captured;
- the batched steps refuse such a cfg.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.ops import render_pallas as jrp
from gs2d_tpu.ops import render_pallas_flat as jrpf
from gs2d_tpu.train import loop as jloop
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.io.image import synthetic_target
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_flat as rf
from gs2d_tpu_torch.params import FIELDS
from gs2d_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

H, W = 48, 64
KW = dict(width=W, height=H, n_splats=64, tile_h=32, flat_chunk=16,
          binning="flat")
MESSAGE = ("scan_chunk ignored: flat capacity exceeds the single-program "
           "memory budget (split steps)")


def _clear_jax_caches():
    jloop.make_train_step_fused.cache_clear()
    jloop._make_split_step_fused.cache_clear()


@pytest.fixture
def split(monkeypatch):
    """Every flat cfg needs the split step, in both packages."""
    _clear_jax_caches()
    monkeypatch.setattr(jloop, "SPLIT_STEP_ROWS", 0)
    monkeypatch.setattr(tloop, "SPLIT_STEP_ROWS", 0)
    yield
    _clear_jax_caches()


def _port_case():
    cfg = SplatConfig(**KW)
    state = tloop.init_train_state(cfg, "cpu")
    cfg = rf.tune_flat_config(state.params, cfg)
    return cfg, state, rd.pad_ref_chw(synthetic_target(H, W), cfg, "cpu")


@pytest.mark.parametrize("with_grad_mag", [False, True])
def test_split_equals_fused_bitwise(split, with_grad_mag):
    """Three steps above the split threshold equal three fused flat steps
    bit for bit: every leaf of the state and every aux field (the signal
    included)."""
    cfg, state, ref = _port_case()
    assert tloop._needs_split(cfg)
    step = tloop.make_train_step_fused(cfg, with_grad_mag)
    fused = tloop._fused_step_body(cfg, with_grad_mag)
    s_a = s_b = state
    for _ in range(3):
        s_a, a = step(s_a, ref)
        s_b, b = fused(s_b, ref)
        for f in ("mse", "psnr", "all_finite", "n_dropped", "pos_grad_mag"):
            assert torch.equal(torch.as_tensor(getattr(a, f)),
                               torch.as_tensor(getattr(b, f))), f
    for x, y in zip(tloop.state_leaves(s_a), tloop.state_leaves(s_b)):
        assert torch.equal(x, y)


def test_split_matches_jax_split(split):
    """One split step from gs2d_tpu's init state (carried across as numpy)
    against gs2d_tpu's split step: the statics equal, the MSE and every
    parameter within 1e-6 (gs2d_tpu's split-against-fused tolerance)."""
    cfg_j = JaxConfig(**KW)
    js = jloop.init_train_state(cfg_j)
    cfg_j = jrpf.tune_flat_config(js.params, cfg_j)
    ts = tloop.state_from_numpy([np.asarray(x) for x in jax.tree.leaves(js)],
                                "cpu")
    cfg_t = rf.tune_flat_config(ts.params, SplatConfig(**KW))
    assert (cfg_t.flat_capacity, cfg_t.flat_max_chunks) == \
        (cfg_j.flat_capacity, cfg_j.flat_max_chunks)
    assert jloop._needs_split(cfg_j) and tloop._needs_split(cfg_t)
    ref = synthetic_target(H, W)
    js2, ja = jloop.make_train_step_fused(cfg_j)(
        js, jrp.pad_ref_chw(jnp.asarray(ref), cfg_j))
    ts2, ta = tloop.make_train_step_fused(cfg_t)(
        ts, rd.pad_ref_chw(ref, cfg_t, "cpu"))
    assert np.isclose(float(ta.mse), float(ja.mse), rtol=1e-6)
    assert int(ta.n_dropped) == int(ja.n_dropped) == 0
    for f in FIELDS:
        np.testing.assert_allclose(getattr(ts2.params, f).numpy(),
                                   np.asarray(getattr(js2.params, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


def test_fit_ignores_scan_chunk_on_a_split_cfg(split):
    """gs2d_tpu's rule: scan_chunk is ignored with its message, and the fit
    is the eager one, bit for bit."""
    cfg, _, _ = _port_case()
    ref = synthetic_target(H, W)
    logs = []
    _, h_s = tloop.fit(ref, cfg, 4, "cpu", log_every=1, log_fn=logs.append,
                       scan_chunk=3)
    _, h_e = tloop.fit(ref, cfg, 4, "cpu", log_every=1, log_fn=None)
    assert logs[0] == MESSAGE
    assert [r["mse"] for r in h_s] == [r["mse"] for r in h_e]
    assert "rebinned" not in h_s[0]  # the eager loop's records


def test_fit_adaptive_ignores_scan_chunk_on_a_split_cfg(split):
    """fit's rule holds in fit_adaptive: with scan_chunk on such a cfg it
    logs gs2d_tpu's message once, captures nothing and equals the eager
    adaptive fit bit for bit, densify included."""
    from gs2d_tpu_torch.train import densify as tdensify

    cfg, _, _ = _port_case()
    ref = synthetic_target(H, W)
    logs = []
    s_s, h_s = tdensify.fit_adaptive(ref, cfg, 6, 3, "cpu", scan_chunk=2,
                                     log_every=1, log_fn=logs.append)
    s_e, h_e = tdensify.fit_adaptive(ref, cfg, 6, 3, "cpu", log_every=1,
                                     log_fn=None)
    assert logs.count(MESSAGE) == 1 and logs[0] == MESSAGE
    assert not [x for x in logs if x.startswith("captured")]
    assert [r.get("mse") for r in h_s] == [r.get("mse") for r in h_e]
    assert "rebinned" not in h_s[0]  # the eager loop's records
    for x, y in zip(tloop.state_leaves(s_s), tloop.state_leaves(s_e)):
        assert torch.equal(x, y)


def test_batched_steps_refuse_a_split_cfg(split):
    cfg, _, _ = _port_case()
    for make in (tloop.make_batched_train_step_fused,
                 tloop.make_fit_scan_batched):
        with pytest.raises(ValueError, match="SPLIT_STEP_ROWS"):
            make(cfg)
