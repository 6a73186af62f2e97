"""The frozen work model counts what the program's roofline script counts:
``gs2d_tpu_torch/scripts/roofline.py::live_work`` over the program's own
binning, against the reference's composite, which bins and tests liveness
itself."""

import math

import pytest
import torch

from reference import splats as ref_lib


def _population(n, w, h, seed):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((5, n), generator=g)
    return {"pos": torch.stack([u[0] * (w - 1), u[1] * (h - 1)], -1),
            "sx": 6 + 4 * u[2], "sy": 6 + 4 * u[3], "rot": math.pi * u[4],
            "color": torch.full((n, 3), 0.5), "opacity": torch.ones(n)}


@pytest.mark.parametrize("n,w,h,tile_h,seed", [
    (150, 150, 90, 32, 1), (300, 200, 70, 32, 2), (400, 130, 150, 64, 3),
    (60, 268, 213, 32, 4)])
def test_work_model_counts_what_live_work_counts(n, w, h, tile_h, seed):
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import GaussianParams
    from gs2d_tpu_torch.scripts import roofline

    p = _population(n, w, h, seed)
    cfg = SplatConfig(width=w, height=h, n_splats=n, tile_h=tile_h)
    gp = GaussianParams(**{f: p[f].clone() for f in ref_lib.FIELDS})
    b = tl.bin_splats(gp, cfg, n)
    assert int(b.n_dropped) == 0
    want = roofline.live_work(tl.pregather_rows(b.ids, gp, cfg), b.count,
                              cfg)
    _, _, got = ref_lib.composite(
        p, ref_lib.Settings(width=w, height=h, tile_h=tile_h, chunk=32),
        count_work=True)
    assert {k: got[k] for k in want} == want
    assert 0 < got["pairs"] <= int(b.count.sum())
