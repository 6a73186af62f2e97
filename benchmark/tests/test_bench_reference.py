"""The reference agrees with the program's CPU path on one fitting step."""

import math

import numpy as np
import pytest
import torch

from reference import splats as ref_lib


@pytest.mark.parametrize("binning,n", [("resident", 200), ("flat", 300),
                                       ("dense", 150)])
def test_reference_step_matches_program_cpu_step(binning, n):
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import GaussianParams
    from gs2d_tpu_torch.train import loop
    from gs2d_tpu_torch.train.adam import init_adam_state

    w, h = 150, 90
    g = torch.Generator().manual_seed(7)
    u = torch.rand((5, n), generator=g)
    p = {"pos": torch.stack([u[0] * (w - 1), u[1] * (h - 1)], -1),
         "sx": 6 + 4 * u[2], "sy": 6 + 4 * u[3], "rot": math.pi * u[4],
         "color": torch.rand((n, 3), generator=g), "opacity": torch.ones(n)}
    target = torch.rand((h, w, 3), generator=g)
    cfg = SplatConfig(width=w, height=h, n_splats=n, binning=binning)
    gp = GaussianParams(**{f: p[f].clone() for f in ref_lib.FIELDS})
    cfg = tl.tune_tile_height(cfg, gp)
    cfg = rf.tune_flat_config(gp, cfg) if binning == "flat" \
        else tl.tune_tile_capacity(gp, cfg)
    state = loop.TrainState(params=gp, opt=init_adam_state(gp))
    new, hist = loop.fit(target, cfg, 1, "cpu", state=state, log_every=1,
                         log_fn=None)
    s = ref_lib.Settings(width=w, height=h, tile_h=cfg.tile_h, chunk=32)
    ref_state, mse, grads = ref_lib.step(ref_lib.init_state(p), target, s)
    assert abs(hist[0]["mse"] - mse) <= 1e-6 * mse
    one_b1 = float(np.float32(1.0) - np.float32(0.9))
    for f in ("pos", "sx", "sy", "rot", "color"):
        got = getattr(new.opt.m, f) / one_b1
        assert float((got - grads[f]).norm()) <= 1e-5 * float(
            grads[f].norm()), f
        assert torch.allclose(getattr(new.params, f),
                              ref_state["params"][f], rtol=0, atol=1e-5), f
