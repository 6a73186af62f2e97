"""The measurement probes of the port (gs2d_tpu_torch/ops/probes.py and
gs2d_tpu_torch/scripts/) on the CPU: the plain PyTorch versions against the
Pallas kernels of scripts/probe_mxu_moments.py run in interpret mode, the
FMA probe against a numpy statement of scripts/roofline.py:96-104, and the
operation model moved out of chip_smoke.py against the numbers it gave
there.

Tolerances. The moment probes sum the same float32 terms in another order
than the Pallas kernels (XLA's reductions against torch's): 1e-5 of the
largest output (measured 4e-7 and 8e-7). The FMA probe's plain version and
the numpy statement are the same arithmetic: bit for bit.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import probes
from gs2d_tpu_torch.ops import render_resident as rr
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.params import params_from_numpy
from gs2d_tpu_torch.scripts import probe_mxu_moments, roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUM_ORDER_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_probe():
    """scripts/probe_mxu_moments.py as a module (nothing in it changes)."""
    spec = importlib.util.spec_from_file_location(
        "jax_probe_mxu_moments",
        os.path.join(ROOT, "scripts", "probe_mxu_moments.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret(jax_probe, kernel, n_k, scratch=()):
    call = pl.pallas_call(
        functools.partial(kernel, n_k=n_k),
        out_shape=jax.ShapeDtypeStruct((1, jax_probe.TW), jnp.float32),
        scratch_shapes=list(scratch), interpret=True)
    return np.asarray(call())


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SUM_ORDER_RTOL * scale)


@pytest.mark.parametrize("kind,n_k", [("vpu", 24), ("vpu", 512),
                                      ("mxu", 24), ("mxu", 512)])
def test_moment_probe_plain_matches_pallas(jax_probe, kind, n_k):
    kernel = jax_probe.kernel_vpu if kind == "vpu" else jax_probe.kernel_mxu
    want = _interpret(jax_probe, kernel, n_k)
    _, wrapper, plain = probes.MOMENT_PROBES[kind]
    got = plain(n_k, 1, "cpu").numpy()
    assert got.shape == (1, 128) and np.isfinite(got).all()
    _close(got, want)
    # On the CPU the wrapper runs the plain version and counts no launch.
    before = dict(probes.launches)
    np.testing.assert_array_equal(wrapper("cpu", n_k=n_k).numpy(), got)
    assert probes.launches == before


def test_scratch_contraction_plain_matches_pallas(jax_probe):
    """kernel_mxu2 folds with the module's K, so it runs at n_k = K = 512;
    interpret mode takes its VMEM scratch."""
    k = jax_probe.K
    want = _interpret(
        jax_probe, jax_probe.kernel_mxu2, k,
        scratch=[pltpu.VMEM((k, jax_probe.TH, jax_probe.TW), jnp.float32)])
    got = probes.moments_scratch_contraction("cpu", n_k=k).numpy()
    assert got.shape == (1, 128)
    _close(got, want)


def test_scratch_contraction_fold_against_numpy():
    """The fold at another n_k: out[j] = sum_i M.flat[i * (n_k 9 / 4) + j],
    M = Z @ V in float64."""
    n_k = 64
    vy, vx = np.meshgrid(np.arange(32.0) - 16.0, np.arange(128.0) - 64.0,
                         indexing="ij")
    v = np.stack([np.ones_like(vx), vx, vy, vx * vx, vx * vy, vy * vy, vx,
                  vy, vx], -1).reshape(4096, 9)
    carry = np.full((32, 128), 0.5, np.float32)
    zs = []
    for k in range(n_k):
        z = carry * (np.float32(1e-6) * np.float32(k + 1)) + np.float32(1e-3)
        zs.append(z.reshape(-1))
        carry = carry * np.float32(0.999) + z * np.float32(1e-4)
    m = np.stack(zs).astype(np.float64) @ v
    want = m.reshape(4, n_k * 9 // 4).sum(0)[None, :128]
    got = probes.moments_mxu2_plain(n_k, 3, "cpu").numpy()
    assert got.shape == (3, 128)
    _close(got[:1], want)
    np.testing.assert_array_equal(got[1:], np.repeat(got[:1], 2, 0))
    # The sizes its outputs' errors are measured against: the same fold of
    # |Z| @ |V|; the other probes' one scalar stands for itself.
    sizes = np.abs(np.stack(zs)).astype(np.float64) @ np.abs(v)
    sizes = sizes.reshape(4, n_k * 9 // 4).sum(0)[None, :128]
    got_t = torch.from_numpy(got)
    np.testing.assert_allclose(
        probes.moments_output_sizes("mxu2", got_t, n_k).numpy(),
        np.repeat(np.maximum(sizes, 1.0), 3, 0), rtol=1e-5)
    assert (sizes >= np.abs(want)).all() and sizes[0, 1] > 50 * -want[0, 1]
    assert torch.equal(probes.moments_output_sizes("vpu", -3 * got_t, n_k),
                       (3 * got_t).abs().clamp(min=1.0))


@pytest.mark.parametrize("n_k", [0, 6, 12])
def test_scratch_contraction_refuses_steps_the_fold_cannot_take(n_k):
    with pytest.raises(ValueError):
        probes.moments_scratch_contraction("cpu", n_k=n_k)


@pytest.mark.parametrize("chains", [1, 2, 8, 32])
def test_fma_peak_plain_rounds_once_a_step(chains):
    """scripts/roofline.py:96-104 (its `kernel` is a closure that only a TPU
    reaches): chains accumulators from 1, 2, ...; a = a * c + 1e-9 as a
    fused multiply-add, 256 times; their sum. In numpy: the product in
    float64 is exact, one rounding to float32 a step."""
    c, b = np.float32(1.0000001), np.float32(1e-9)
    assert c == np.float32(1.0) + np.float32(2.0 ** -23)
    acc = [np.float32(1.0 + i) for i in range(chains)]
    for _ in range(256):
        acc = [np.float32(np.float64(a) * np.float64(c) + np.float64(b))
               for a in acc]
    want = np.float32(0.0)
    for a in acc:
        want = np.float32(want + a)
    got = probes.fma_peak(chains, "cpu", grid=3)
    assert got.shape == (3, 256) and got.dtype == torch.float32
    assert (got.numpy() == want).all()


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError):
        probes.fma_peak(2, "meta")
    with pytest.raises(ValueError):
        probes.moments_cuda_cores("meta")


def test_operation_counts():
    assert probes.fma_peak_flops(16, 256, 10) == 10 * (2 * 16 * 256 + 15)
    per_px = {"vpu": 16, "mxu": 9, "mxu2": 5}
    for kind, n in per_px.items():
        # Every count is linear in the steps but for mxu2's fold.
        one, two = (probes.moments_flops(kind, k) for k in (64, 128))
        fold = 3 * 128 if kind == "mxu2" else 0
        assert two - fold == 2 * (one - fold)
        assert one > 64 * 4096 * n
    # A step of each, pinned. 15b's product counts the three columns of Vx
    # that are not zero, 2 * 32 * 128 * 3, and its stage 2 those (32, 3):
    # 5 * 32 * 3 + 32 + 3 * 2 = 518.
    assert probes.moments_flops("vpu", 1) == 4096 * 16 + 128 * 12 + 9
    assert probes.moments_flops("mxu", 1) == 4096 * 9 + 24576 + 518 + 5
    assert probes.moments_flops("mxu", 512) == 512 * 61963
    assert probes.moments_flops("mxu2", 1) == 4096 * 5 + 2 * 4096 * 9 + 384
    with pytest.raises(ValueError):
        probes.moments_flops("mxu3", 8)


def _population(seed, n, width, height):
    rng = np.random.default_rng(seed)
    d = {"pos": np.stack([rng.uniform(-3, width + 3, n),
                          rng.uniform(-3, height + 3, n)], -1),
         "sx": rng.uniform(1.5, 12.0, n), "sy": rng.uniform(1.5, 12.0, n),
         "rot": rng.uniform(0.0, np.pi, n),
         "color": rng.uniform(0.0, 1.0, (n, 3)),
         "opacity": rng.uniform(0.3, 1.0, n)}
    return {k: v.astype(np.float32) for k, v in d.items()}


# What chip_smoke.py's own live_work and bound gave for this binning before
# they moved into scripts/roofline.py (40 seeded splats on 200x48, 16-row
# tiles, 110 pairs; 12 345 bytes).
FROZEN_WORK = {"pixels": 38851, "rows": 1336, "columns": 3328}
FROZEN_BOUND_MS = {"fwd": 1.561489552238806e-05,
                   "bwd": 2.9820970149253733e-05,
                   "l2": 3.475319402985075e-05,
                   "mxu": 4.631329850746269e-05}


def test_moved_operation_model_gives_the_same_numbers():
    w, h, n, k = 200, 48, 40, 64
    cfg = SplatConfig(width=w, height=h, n_splats=n, tile_h=16,
                      max_splats_per_tile=k)
    p = params_from_numpy(_population(7, n, w, h), "cpu")
    b = tl.bin_splats(p, cfg, k, ids_only=True)
    assert int(b.count.sum()) == 110
    table = rr.resident_table(p, cfg)
    rows = table.reshape(-1, tl.N_FIELDS)[rr._remap_ids(b, n).long()]
    work = roofline.live_work(rows, b.count, cfg)
    assert work == FROZEN_WORK
    for kind, want in FROZEN_BOUND_MS.items():
        ms, by = roofline.bound(kind, work, cfg, 12345)
        assert by == "operations" and ms == pytest.approx(want, rel=1e-12)
    assert roofline.bound("fwd", work, cfg, 10 ** 9) == (
        pytest.approx(1e3 * 1e9 / 3.35e12, rel=1e-12), "bytes")
    # Another ceiling scales the bound; the published one is the default.
    half, _ = roofline.bound("l2", work, cfg, 12345, f32_peak=33.5e12)
    assert half == pytest.approx(2 * FROZEN_BOUND_MS["l2"], rel=1e-12)
    assert (roofline.F32_PEAK, roofline.HBM_RATE) == (67e12, 3.35e12)


@pytest.mark.parametrize("mod", [roofline, probe_mxu_moments])
def test_scripts_exit_2_without_a_card(mod):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    lines = []
    assert mod.main([], log=lines.append) == 2
    assert "no CUDA GPU" in lines[0]


@pytest.mark.parametrize("mod,flag", [
    (roofline, "--splats"), (roofline, "--workload"), (roofline, "--reps"),
    (probe_mxu_moments, "--steps"), (probe_mxu_moments, "--reps")])
def test_scripts_take_no_flag_that_shrinks_the_measurement(mod, flag):
    """As gs2d_tpu's scripts: the sizes are the measurement's own."""
    with pytest.raises(SystemExit):
        mod.main(["--device", "cpu", flag, "1"], log=lambda _: None)


def test_probe_script_rehearses_on_the_cpu():
    lines, got = [], {}
    assert probe_mxu_moments.main(
        ["--device", "cpu"], collect=got, log=lines.append, n_k=64,
        reps=1) == 0
    assert sorted(got) == [("mxu", 1), ("mxu2", 1), ("vpu", 1)]
    assert len(lines) == 4 and all("[cpu]" in x for x in lines[1:])
    assert all("host time" in x for x in lines[1:])


@pytest.mark.parametrize("name,kernels", [
    ("mini 1k resident", "kernel 1"), ("mini 1k dense", "kernel 4/5"),
    ("10k flat", "kernels 10 + 11")])
def test_roofline_rehearses_on_the_cpu(name, kernels):
    lines, got = [], {}
    (w,) = [w for w in roofline.WORKLOADS if w[0] == name]
    assert roofline.main(
        ["--device", "cpu"], collect=got, log=lines.append,
        workloads=[w[:4] + (48,) + w[5:]], reps=1) == 0
    assert lines[0] == "ceilings: not measured"
    (r,) = got["workloads"]
    assert r["kernels"] == kernels and r["pair_steps"] > 0
    assert 0 < r["work"]["pixels"] and "share_published" not in r
    assert got["hbm_gbps"] is None and got["fma_per_s"] is None
    assert "host time of the plain versions" in lines[1]
    # On the card the share is the kernels' summed bound over their time.
    r["kernel_ms"] = 1.0
    share, by = roofline.share(r, roofline.F32_PEAK, roofline.HBM_RATE)
    want = sum(roofline.bound(kind, r["work"], r["cfg"], n)[0]
               for kind, n in r["parts"])
    assert share == pytest.approx(want) and 0 < share < 1
    assert by.count("+") == len(r["parts"]) - 1
