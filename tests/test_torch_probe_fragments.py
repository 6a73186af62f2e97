"""The tensor-core moment probes 15b and 15c (gs2d_tpu_torch/csrc/probes.cu)
on the CPU: what the kernels do with a value and where they put it, stated
in Python (ops/probes.py: tf32_split, tensor_core_pixels, swizzled_word)
and held to the PTX rules they must meet; plain emulations of the two
kernels' arithmetic against the plain versions and against the Pallas
probes of scripts/probe_mxu_moments.py in interpret mode; the split
operation counts and the bounds at the tensor cores' rate.

Tolerances. PROBE_TC_RTOL is chip_smoke.py's: what 3xTF32 keeps, of the
size of each value's terms (each product loses about 2^-21 of its size, and
the sums run in another order than the plain versions'). Against the Pallas
probes the emulations are held to test_torch_probes.py's sum-order
tolerance, 1e-5 of the largest output. The split twin is exact integer
arithmetic: bit for bit.
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

from gs2d_tpu_torch.ops import probes
from gs2d_tpu_torch.scripts import roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_TC_RTOL = 1e-5
SUM_ORDER_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_probe():
    """scripts/probe_mxu_moments.py as a module (nothing in it changes)."""
    spec = importlib.util.spec_from_file_location(
        "jax_probe_mxu_moments_fragments",
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


def _close_to_pallas(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SUM_ORDER_RTOL * scale)


def _within(got, want, sizes, rtol=PROBE_TC_RTOL):
    err = (got.double() - want.double()).abs()
    assert bool((err <= rtol * sizes.double()).all()), \
        float((err / sizes.double()).max())


# ---------------------------------------------------------------------------
# The TF32 split.
# ---------------------------------------------------------------------------

def _rna_numpy(x):
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def test_tf32_split_rounds_to_nearest_ties_away():
    rng = np.random.default_rng(18)
    x = np.concatenate([rng.standard_normal(20000),
                        rng.standard_normal(2000) * 1e-3,
                        rng.standard_normal(2000) * 4096.0]).astype(np.float32)
    hi, lo = probes.tf32_split(torch.from_numpy(x))
    hi_n = _rna_numpy(x)
    lo_n = _rna_numpy(x - hi_n)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32),
                                  hi_n.view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32),
                                  lo_n.view(np.uint32))
    # Both are TF32 values: a 10-bit mantissa, the low 13 bits zero.
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    x64 = x.astype(np.float64)
    hi64, lo64 = hi.double().numpy(), lo.double().numpy()
    assert (np.abs(x64 - hi64) <= 2.0 ** -11 * np.abs(x64)).all()
    assert (np.abs(x64 - hi64 - lo64) <= 2.0 ** -22 * np.abs(x64)).all()
    # Ties go away from zero, on both signs: 1 + 2^-11 lies half way
    # between two TF32 values.
    tie = np.float32(1.0 + 2.0 ** -11)
    got, _ = probes.tf32_split(torch.tensor([tie, -tie, 1.0 + 2.0 ** -12]))
    assert got.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]


# ---------------------------------------------------------------------------
# Kernel 15b's map: each lane's pixels are its wgmma A fragments.
# ---------------------------------------------------------------------------

def _ptx_a_fragment(q, s):
    """(64, 8, 2): for the A operand (m64 x k8) of warpgroup q's k-step s,
    the (row, column) of the tile pixel each element must hold: the tile
    taken transposed, A[m][k] = z[16 (q // 2) + 8 s + k][64 (q % 2) + m]."""
    m, k = np.meshgrid(np.arange(64), np.arange(8), indexing="ij")
    return np.stack([16 * (q // 2) + 8 * s + k, 64 * (q % 2) + m], axis=-1)


def test_tensor_core_pixels_cover_the_tile_once_as_a_fragments():
    pix = probes.tensor_core_pixels()
    assert pix.shape == (16, 32, 2, 4, 2)
    flat = pix[..., 0] * 128 + pix[..., 1]
    assert sorted(flat.ravel().tolist()) == list(range(4096))
    # PTX ISA, wgmma .m64nNk8 with .tf32 A in registers: lane (g, t) =
    # (lane // 4, lane % 4) of warp j of the warpgroup holds a0 (16 j + g,
    # t), a1 (16 j + g + 8, t), a2 (16 j + g, t + 4), a3 (16 j + g + 8,
    # t + 4).
    for warp in range(16):
        q, j = divmod(warp, 4)
        for s in range(2):
            want = _ptx_a_fragment(q, s)
            for lane in range(32):
                g, t = divmod(lane, 4)
                for i in range(4):
                    m = 16 * j + g + 8 * (i % 2)
                    k = t + 4 * (i // 2)
                    assert tuple(pix[warp, lane, s, i]) == tuple(want[m, k])


# ---------------------------------------------------------------------------
# Kernel 15c's stages (and 15b's B): the producers' stores are where the
# 128-byte-swizzled K-major descriptor reads.
# ---------------------------------------------------------------------------

def _descriptor_word(row, k, step, sbo=1024):
    """The 32-bit word wgmma reads for element (row, k) of a k8 step whose
    descriptor starts 32 step bytes into a 1024-aligned block of 128-byte
    rows (K-major, the 128B swizzle): 8-row groups sbo apart, the row's
    bytes XORed in bits 4-6 with bits 7-9 of the address."""
    addr = 32 * step + (row // 8) * sbo + (row % 8) * 128 + 4 * k
    return (addr ^ (((addr >> 7) & 7) << 4)) // 4


@pytest.mark.parametrize("rows", [64, 32, 16])
def test_swizzled_stores_are_where_the_descriptor_reads(rows):
    """64: a stage's planes (the m64 of A); 32: 15c's V^T block, hi rows
    0-15 and lo rows 16-31 (the n32 and, its first 16 rows, the n16 of B);
    16: 15b's Vy (hi rows 0-7, lo 8-15; k = the tile's 32 rows)."""
    seen = set()
    for row in range(rows):
        for x in range(32):
            word = probes.swizzled_word(row, x)
            assert word == _descriptor_word(row, x % 8, x // 8)
            seen.add(word)
        # A warp's store of one row (one lane per pixel): 32 banks.
        assert len({probes.swizzled_word(row, x) % 32
                    for x in range(32)}) == 32
    assert seen == set(range(rows * 32))


# ---------------------------------------------------------------------------
# Plain emulations of the two kernels' arithmetic.
# ---------------------------------------------------------------------------

def _fragment_index():
    """{(q, s): (rows, cols)} index tensors (64, 8) that gather each
    warpgroup's A operand from a z plane through tensor_core_pixels and the
    PTX fragment layout."""
    pix = probes.tensor_core_pixels()
    idx = {}
    for warp in range(16):
        q, j = divmod(warp, 4)
        for s in range(2):
            rows, cols = idx.setdefault(
                (q, s), (torch.empty(64, 8, dtype=torch.long),
                         torch.empty(64, 8, dtype=torch.long)))
            for lane in range(32):
                g, t = divmod(lane, 4)
                for i in range(4):
                    m, k = 16 * j + g + 8 * (i % 2), t + 4 * (i // 2)
                    rows[m, k], cols[m, k] = (int(v) for v in
                                              pix[warp, lane, s, i])
    return idx


def emulate_tensor_cores(n_k):
    """Kernel 15b's arithmetic: per step the A fragments split hi / lo,
    per warpgroup q and k-step s the products a_hi @ [Vy hi | Vy lo] and
    a_lo @ Vy hi, the small terms added first, stage 2's column monomials
    1 + vx + vx^2, and the two pixel sums. Returns (out (1, 128), steps
    (n_k, 5))."""
    idx = _fragment_index()
    vy = torch.arange(32, dtype=torch.float32) - 16.0
    vy_b = torch.zeros(32, 8)
    vy_b[:, 0], vy_b[:, 1], vy_b[:, 2] = 1.0, vy, vy * vy
    b_hi, b_lo = probes.tf32_split(vy_b)
    vx = torch.arange(128, dtype=torch.float32) - 64.0
    w = (1.0 + vx) + vx * vx
    steps = []
    for z, carry in probes._z_steps(n_k, "cpu"):
        z_hi, z_lo = probes.tf32_split(z)
        s012 = torch.zeros(3)
        for q in range(4):
            big, small = [], []
            for s in range(2):
                rows, cols = idx[(q, s)]
                ks = slice(8 * (2 * (q // 2) + s), 8 * (2 * (q // 2) + s) + 8)
                big.append(z_hi[rows, cols] @ torch.cat(
                    [b_hi[ks], b_lo[ks]], dim=1))
                small.append(z_lo[rows, cols] @ b_hi[ks])
            e = ((small[0] + big[0][:, 8:]) + (small[1] + big[1][:, 8:])) \
                + (big[0][:, :8] + big[1][:, :8])
            wq = w[64 * (q % 2): 64 * (q % 2) + 64]
            s012 = s012 + (e[:, :3] * wq[:, None]).sum(dim=0)
        steps.append(torch.cat([s012, torch.stack(
            [(z * carry).sum(), (z * z).sum()])]))
    steps = torch.stack(steps)
    return steps.sum().expand(1, probes.TILE_W), steps


def emulate_contraction(n_k):
    """Kernel 15c's arithmetic: the planes in batches of 64 (zeros past
    n_k), each batch over its 32 chunks (tile rows) of 16 k8 steps, chain j
    taking the k-steps s = j mod 4, a step's products A hi @ [V^T hi | V^T
    lo] and A lo @ V^T hi; a chunk's small terms first, the chunks added in
    order; then the fold. Returns (out (1, 128), M (n_k, 9))."""
    zs = torch.stack([z.reshape(-1) for z, _ in probes._z_steps(n_k, "cpu")])
    v_hi, v_lo = probes.tf32_split(probes.contraction_v("cpu"))
    b = torch.zeros(4096, 32)
    b[:, :9], b[:, 16:25] = v_hi, v_lo
    n_b = -(-n_k // 64)
    planes = torch.zeros(n_b * 64, 4096)
    planes[:n_k] = zs
    a_hi, a_lo = probes.tf32_split(planes)
    m = torch.zeros(n_b * 64, 16)
    for k0 in range(0, n_b * 64, 64):
        mo = torch.zeros(64, 16)
        for r in range(32):
            big = [torch.zeros(64, 32) for _ in range(4)]
            small = [torch.zeros(64, 16) for _ in range(4)]
            for s in range(16):
                px = slice(128 * r + 8 * s, 128 * r + 8 * s + 8)
                big[s % 4] = big[s % 4] + a_hi[k0:k0 + 64, px] @ b[px]
                small[s % 4] = small[s % 4] + a_lo[k0:k0 + 64, px] \
                    @ b[px, :16]
            lo = sum(small[j] + big[j][:, 16:] for j in range(4))
            hi = sum(big[j][:, :16] for j in range(4))
            mo = mo + (lo + hi)
        m[k0:k0 + 64] = mo
    m = m[:n_k, :9]
    return probes.contraction_fold(m, 1), m


def test_tensor_core_emulation_matches_plain_and_pallas(jax_probe):
    n_k = 64
    got, steps = emulate_tensor_cores(n_k)
    want = probes.moments_mxu_plain(n_k, 1, "cpu")
    _within(got, want, probes.moments_output_sizes("mxu", want, n_k))
    _within(steps, probes.moments_mxu_plain_steps(n_k, "cpu"),
            probes.moments_mxu_plain_steps(n_k, "cpu", sizes=True))
    _close_to_pallas(got.numpy(),
                     _interpret(jax_probe, jax_probe.kernel_mxu, n_k))


@pytest.mark.parametrize("n_k", [64, 72])
def test_contraction_emulation_matches_plain_and_pallas(jax_probe,
                                                        monkeypatch, n_k):
    """72: a masked last batch of 8 planes. kernel_mxu2 folds with its
    module's K, set to n_k here."""
    got, m = emulate_contraction(n_k)
    want = probes.moments_mxu2_plain(n_k, 1, "cpu")
    _within(got, want, probes.moments_output_sizes("mxu2", want, n_k))
    _within(m, probes.moments_mxu2_plain_steps(n_k, "cpu"),
            probes.moments_mxu2_plain_steps(n_k, "cpu", sizes=True))
    monkeypatch.setattr(jax_probe, "K", n_k)
    _close_to_pallas(got.numpy(), _interpret(
        jax_probe, jax_probe.kernel_mxu2, n_k,
        scratch=[pltpu.VMEM((n_k, jax_probe.TH, jax_probe.TW),
                            jnp.float32)]))


@pytest.mark.parametrize("kind,width", [("mxu", 5), ("mxu2", 9)])
def test_cpu_wrappers_fill_the_steps_with_the_plain_steps(kind, width):
    name, wrapper, plain = probes.MOMENT_PROBES[kind]
    steps = torch.full((64, width), float("nan"))
    before = dict(probes.launches)
    out = wrapper("cpu", n_k=64, n_blocks=2, steps=steps)
    assert probes.launches == before
    assert torch.equal(out, plain(64, 2, "cpu"))
    assert probes.MOMENT_STEPS[kind][0] == width
    assert torch.equal(steps, probes.MOMENT_STEPS[kind][1](64, "cpu"))
    # Each step's values add up to what the plain version folds or sums.
    if kind == "mxu":
        assert float(steps.sum()) == pytest.approx(float(out[0, 0]),
                                                   rel=1e-6)
    else:
        assert torch.equal(probes.contraction_fold(steps, 2), out)


def test_reference_launchers_are_counted_apart():
    assert set(probes.REFERENCE_COUNTERS) == {
        "moments_cuda_cores_tree", "moments_tensor_cores_staged",
        "moments_scratch_contraction_sync"}
    assert set(probes.REFERENCE_COUNTERS) <= set(probes.launches)
    assert not set(probes.REFERENCE_COUNTERS) & {
        name for name, _, _ in probes.MOMENT_PROBES.values()}


# ---------------------------------------------------------------------------
# Operation counts and bounds.
# ---------------------------------------------------------------------------

def test_operation_counts_split_the_product_from_the_rest():
    assert probes.moments_flops_split("vpu", 1) == (0, 4096 * 16 + 128 * 12
                                                    + 9)
    assert probes.moments_flops_split("mxu", 1) == (2 * 4096 * 3,
                                                    4096 * 9 + 518 + 5)
    assert probes.moments_flops_split("mxu2", 1) == (2 * 4096 * 9,
                                                     4096 * 5 + 384)
    for kind in ("vpu", "mxu", "mxu2"):
        for n_k in (1, 64, 512):
            assert sum(probes.moments_flops_split(kind, n_k)) == \
                probes.moments_flops(kind, n_k)
    # 15c's 94 208 operations a step, 73 728 of them the product; 15b's
    # 61 963, 24 576.
    assert probes.moments_flops_split("mxu2", 512)[0] == 512 * 73728
    assert probes.moments_flops("mxu2", 512) == 512 * 94208 + 384
    assert probes.moments_flops_split("mxu", 512)[0] == 512 * 24576


def test_bounds_take_the_products_at_the_tensor_cores_rate():
    assert (roofline.F32_PEAK, roofline.TF32_PEAK) == (67e12, 495e12)
    out = 132 * 128 * 4
    # At K = 512 on 132 blocks: 15b 0.0625 -> 0.0377 ms, 15c 0.0950 ->
    # 0.0302 ms; 15a keeps its bound (no product).
    want = {"vpu": 0.06766570602985075, "mxu": 0.037712880716417915,
            "mxu2": 0.0301989888}
    for kind, ms in want.items():
        got, by = probes.moments_bound(kind, 512, 132, out)
        assert by == "operations" and got == pytest.approx(ms, rel=1e-12)
    total = {kind: 132 * probes.moments_flops(kind, 512) / 67e12 * 1e3
             for kind in want}
    assert total["mxu"] == pytest.approx(0.062503, abs=1e-6)
    assert total["mxu2"] == pytest.approx(0.095030, abs=1e-6)
    assert total["vpu"] == pytest.approx(want["vpu"], rel=1e-12)
    # The bound never exceeds all of the work on the CUDA cores.
    for kind in want:
        for n_k in (64, 512, 4096):
            got, _ = probes.moments_bound(kind, n_k, 1, 512)
            assert got <= 1e3 * probes.moments_flops(kind, n_k) / 67e12 \
                * (1 + 1e-12)
    # Bytes bound it once they outweigh the operations.
    assert probes.moments_bound("mxu", 64, 1, 10 ** 9)[1] == "bytes"
    # Kernel 14's bound at its sweep's best count (32 chains) stays the
    # float32 one: 1.027604 ms.
    flops = probes.fma_peak_flops(32, probes.FMA_INNER,
                                  probes.FMA_GRID * probes.FMA_THREADS)
    assert 1e3 * flops / roofline.F32_PEAK == pytest.approx(1.027604,
                                                            abs=1e-6)


def test_probe_parts_take_out_statements_of_the_current_source():
    """scripts/probe_parts.py removes named statements from csrc/probes.cu:
    each must still be there, once, or its variants would time something
    else."""
    from gs2d_tpu_torch.ops import _build
    from gs2d_tpu_torch.scripts import probe_parts

    src = (_build.CSRC_DIR / "probes.cu").read_text()
    for kernel, _, statements in probe_parts.PARTS:
        assert kernel in probe_parts.ENTRY
        assert len(probe_parts.variant_source(src, statements)) < len(src)
    with pytest.raises(ValueError):
        probe_parts.variant_source(src, ("no such statement;\n",))
    if not torch.cuda.is_available():
        lines = []
        assert probe_parts.main([], log=lines.append) == 2
        assert "no CUDA GPU" in lines[0]
