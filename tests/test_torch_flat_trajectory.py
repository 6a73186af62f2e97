"""The port's flat path against gs2d_tpu's scan path, on the CPU.

Above 4096 splats both packages pick the flat layout, as they do at the
1080p/100k workload, whose trajectory no JAX run can reach on a CPU. This
cut holds the flat fit itself there: 4200 splats on a 64 x 128 synthetic
target, three steps of the port's fused flat step (the plain versions of
kernels 10 and 11) against three of gs2d_tpu's modular step over its scan
renderer (``ops/render_jax.py``), from the same pcg3d init. Per-step MSE
within 1e-4 relative: the same float32 per-pixel program, the moments
summed in another order (measured: 3.3e-7 at most).
"""

import jax.numpy as jnp
import numpy as np
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.ops import render_jax
from gs2d_tpu.ops import render_pallas_flat as jrpf
from gs2d_tpu.train import loop as jloop
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.io.image import synthetic_target
from gs2d_tpu_torch.ops import render as trd
from gs2d_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

H, W, N = 64, 128, 4200


def test_flat_fit_follows_the_jax_scan_path():
    kw = dict(width=W, height=H, n_splats=N)
    assert trd.resolve_binning(SplatConfig(**kw)) == "flat"
    assert jrpf.resolve_binning(JaxConfig(**kw)) == "flat"
    ref = synthetic_target(H, W)
    _, hist_j = jloop.fit(jnp.asarray(ref), JaxConfig(**kw), 3,
                          render_fn=render_jax.render, log_every=1,
                          log_fn=None)
    _, hist_t = tloop.fit(ref, SplatConfig(**kw), 3, "cpu", log_every=1,
                          log_fn=None)
    got = [rec["mse"] for rec in hist_t]
    np.testing.assert_allclose(got, [rec["mse"] for rec in hist_j],
                               rtol=1e-4)
    assert [rec["n_dropped"] for rec in hist_t] == [0, 0, 0]
    assert got[2] < got[0]
