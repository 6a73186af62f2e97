"""The CUDA-core moment probe 15a (gs2d_tpu_torch/csrc/probes.cu) on the
CPU: its reduce-scatter butterfly, stated in Python
(ops/probes.py::butterfly_schedule), and the lane tree it replaced, held
to each other bit for bit; the whole kernel and its reference emulated in
numpy float32, thread by thread, equal bit for bit and near the plain
version; the per-step values against a float64 recursion.

Why bit for bit: at each level the butterfly adds, for every value, the
same two partial sums that the tree's lane 0 adds (lane i's and lane i +
offset's), on the lane whose bit is clear or on its partner, in either
order, and float32 addition is commutative. Tolerances: the emulations and
the per-step values against the plain versions, GRAD_RTOL (chip_smoke.py:
the moments' sum order) of the size of each value's terms; the plain steps
against float64, STEPS_F64_RTOL of that size (float32 rounding of the
recursion and of sums of 4096 terms, measured 2.1e-6 at 64
steps).
"""

import math
import re

import numpy as np
import pytest
import torch

from gs2d_tpu_torch.ops import _build, probes
from gs2d_tpu_torch.scripts import probe_parts

GRAD_RTOL = 1e-4
STEPS_F64_RTOL = 1e-5
WARPS, THREADS, ROWS, ROUND = 16, 512, 8, 32


def _values(rng, n_values):
    """(32, n_values) float32, magnitudes spread over 1e-3 .. 1e3, both
    signs."""
    mag = 10.0 ** rng.uniform(-3.0, 3.0, size=(32, n_values))
    sign = rng.choice([-1.0, 1.0], size=(32, n_values))
    return (mag * sign).astype(np.float32)


def tree_lane0(v):
    """csrc/probes.cu::warp_to_round: v[lane] += __shfl_down_sync(v, off)
    for off = 16 .. 1; lane 0's totals. v (..., 32, n)."""
    v = np.array(v, dtype=np.float32)
    lanes = np.arange(32)
    for off in probes.BUTTERFLY_OFFSETS:
        src = np.where(lanes + off < 32, lanes + off, lanes)
        v = v + v[..., src, :]
    return v[..., 0, :]


def schedule_sums(v):
    """Follows probes.butterfly_schedule: after each level a lane holds, for
    every value it keeps, its own partial sum plus its partner's. Returns
    {value: (lane, total)} of the values held after the last level."""
    v = np.asarray(v, dtype=np.float32)
    n = v.shape[-1]
    held = [{f: v[lane, f] for f in range(n)} for lane in range(32)]
    for off, _, kept in probes.butterfly_schedule(n):
        held = [{f: np.float32(held[lane][f] + held[lane ^ off][f])
                 for f in kept[lane]} for lane in range(32)]
    out = {}
    for lane in range(32):
        for f, total in held[lane].items():
            assert f not in out, f"value {f} on two lanes"
            out[f] = (lane, total)
    return out


def butterfly_rows(v):
    """csrc/probes.cu::butterfly_to_round as the card runs it, slot by slot:
    the selects, the xor shuffles, the spare slots, and the stores of the
    slots below ``end`` at ``first + j``. v (..., 32, n) -> (..., n) with
    NaN where no lane stored, and the count of stores of each value."""
    s = np.array(v, dtype=np.float32)
    n = s.shape[-1]
    lanes = np.arange(32)
    first, end = np.zeros(32, int), np.full(32, n)
    for off in probes.BUTTERFLY_OFFSETS:
        slots = s.shape[-1]
        keep = probes.butterfly_keep(slots)
        rest = slots - keep
        up = (lanes & off) != 0
        w = np.empty(s.shape[:-1] + (keep,), np.float32)
        for i in range(keep):
            if i < rest:
                mine = np.where(up[:, None], s[..., keep + i:keep + i + 1],
                                s[..., i:i + 1])[..., 0]
                theirs = np.where(up[:, None], s[..., i:i + 1],
                                  s[..., keep + i:keep + i + 1])[..., 0]
            else:
                mine = theirs = s[..., i]
            w[..., i] = mine + theirs[..., lanes ^ off]
        first = np.where(up, first + keep, first)
        end = np.where(up, end, np.minimum(end, first + keep))
        s = w
    rows = np.full(s.shape[:-2] + (n,), np.nan, np.float32)
    stores = np.zeros(n, int)
    for lane in range(32):
        for j in range(s.shape[-1]):
            if first[lane] + j < end[lane]:
                rows[..., first[lane] + j] = s[..., lane, j]
                stores[first[lane] + j] += 1
    return rows, stores


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# The butterfly against the tree.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_values", [9, 18, 36, 1, 5, 13, 27, 39])
def test_butterfly_equals_the_tree_bit_for_bit(n_values):
    rng = np.random.default_rng(1900 + n_values)
    for _ in range(50):
        v = _values(rng, n_values)
        want = tree_lane0(v)
        got = schedule_sums(v)
        assert sorted(got) == list(range(n_values))
        np.testing.assert_array_equal(
            _bits([got[f][1] for f in range(n_values)]), _bits(want))
        rows, stores = butterfly_rows(v)
        assert (stores == 1).all()
        np.testing.assert_array_equal(_bits(rows), _bits(want))


@pytest.mark.parametrize("n_values,shuffles", [(9, 12), (18, 20), (36, 37),
                                               (1, 5), (5, 8)])
def test_butterfly_levels_take_half_their_values(n_values, shuffles):
    """Each level takes one shuffle for each of the first ceil(n / 2) slots,
    the values a lane with the level's bit clear keeps; every value ends on
    exactly one lane."""
    levels = probes.butterfly_schedule(n_values)
    assert [off for off, _, _ in levels] == [16, 8, 4, 2, 1]
    slots = n_values
    for _, before, kept in levels:
        assert before == slots
        assert max(len(k) for k in kept) == math.ceil(slots / 2)
        slots = math.ceil(slots / 2)
    assert sum(math.ceil(before / 2) for _, before, _ in levels) == shuffles
    owner = {}
    for lane, kept in enumerate(levels[-1][2]):
        for f in kept:
            assert f not in owner
            owner[f] = lane
    assert sorted(owner) == list(range(n_values))
    # Along a lane's path the kept values only shrink.
    for lane in range(32):
        for (_, _, a), (_, _, b) in zip(levels, levels[1:]):
            assert set(b[lane]) <= set(a[lane])


def test_shuffles_a_step_at_each_batch():
    """The tree: 45 shuffles a step; the butterfly over G steps: 12, 10 and
    9.25 a step at G = 1, 2, 4."""
    def per_step(g):
        levels = probes.butterfly_schedule(9 * g)
        return sum(math.ceil(b / 2) for _, b, _ in levels) / g

    assert [per_step(g) for g in probe_parts.BATCHES] == [12, 10, 9.25]
    assert 9 * len(probes.BUTTERFLY_OFFSETS) == 45


def test_the_source_runs_the_python_schedule():
    """csrc/probes.cu's step batch, split rule and offsets are the ones
    ops/probes.py states, read from the source as probe_parts reads it."""
    src = (_build.CSRC_DIR / "probes.cu").read_text()
    g = probe_parts.source_batch(src)
    assert g == probes.MOMENT_STEP_BATCH and g in probe_parts.BATCHES
    k_round = int(re.search(r"constexpr int kRound = (\d+);", src).group(1))
    assert k_round == ROUND and ROUND % g == 0
    rule = re.search(r"constexpr int butterfly_keep\(int n\) \{ return "
                     r"\(n \+ 1\) / 2; \}", src)
    assert rule is not None
    assert all(probes.butterfly_keep(n) == (n + 1) // 2
               for n in range(1, 80))
    assert "butterfly_levels<N, 16>(v, w, threadIdx.x & 31, first, end);" \
        in src
    assert "butterfly_levels<keep, OFF / 2>(w, out, lane, first, end);" \
        in src
    assert "__shfl_xor_sync(0xffffffffu, theirs, OFF)" in src
    # probe_parts' other batches change only kStepBatch.
    for kernel, label, text, exact in probe_parts.variants(src):
        assert kernel in probe_parts.ENTRY and text != src
        if exact:
            other = probe_parts.source_batch(text)
            assert other != g and other in probe_parts.BATCHES
            assert probe_parts.batch_source(text, g) == src


# ---------------------------------------------------------------------------
# The whole kernel, thread by thread.
# ---------------------------------------------------------------------------

def emulate_15a(n_k, batch=None):
    """Kernel 15a in numpy float32 as csrc/probes.cu runs it: 512 threads,
    thread t at column t % 128, rows 8 (t // 128) .. +7; a step's row
    chains and Moments::finish; the lanes reduced by the tree (batch None:
    moments_cuda_cores_tree_kernel) or by the butterfly over ``batch``
    steps, the round's last steps one at a time; close_round_steps and
    write_total. Returns (the block's output scalar, steps (n_k, 9))."""
    f32 = np.float32
    t = np.arange(THREADS)
    col, row0 = t % 128, (t // 128) * ROWS
    vx = col.astype(f32) - f32(64.0)
    vy = [(row0 + r).astype(f32) - f32(16.0) for r in range(ROWS)]
    carry = [np.full(THREADS, 0.5, f32) for _ in range(ROWS)]

    def step(k):
        scale = f32(1e-6) * f32(k + 1)
        m = [np.zeros(THREADS, f32) for _ in range(6)]
        for r in range(ROWS):
            z = carry[r] * scale + f32(1e-3)
            zvy = z * vy[r]
            m[0] = m[0] + z
            m[1] = m[1] + zvy
            m[2] = m[2] + zvy * vy[r]
            m[3] = m[3] + z * carry[r]
            m[4] = m[4] + zvy * carry[r]
            m[5] = m[5] + z * z
            carry[r] = carry[r] * f32(0.999) + z * f32(1e-4)
        r0x = m[0] * vx
        return np.stack([r0x, m[1], r0x * vx, m[1] * vx, m[2], m[3], m[4],
                         m[5], m[0]], axis=-1)          # (512, 9)

    def reduce(v):
        """(512, n) per-thread values -> (16 warps, n) rows."""
        v = v.reshape(WARPS, 32, -1)
        if batch is None:
            return tree_lane0(v)
        rows, stores = butterfly_rows(v)
        assert (stores == 1).all()
        return rows

    acc = np.zeros(THREADS, f32)
    steps = np.full((n_k, 9), np.nan, f32)
    for k0 in range(0, n_k, ROUND):
        kn = min(ROUND, n_k - k0)
        red = np.full((WARPS, ROUND, 9), np.nan, f32)
        kk = 0
        g = batch or 1
        while kk < kn:
            g = g if kk + g <= kn else 1
            v = np.concatenate([step(k0 + kk + s) for s in range(g)],
                               axis=-1)
            red[:, kk:kk + g] = reduce(v).reshape(WARPS, g, 9)
            kk += g
        flat = red.reshape(WARPS, ROUND * 9)
        for i in range(kn * 9):         # thread i; kn 9 <= 288 < 512
            a = f32(0.0)
            for w in range(WARPS):
                a = f32(a + flat[w, i])
            acc[i] = acc[i] + a
            steps[k0 + i // 9, i % 9] = a
    total = tree_lane0(acc.reshape(WARPS, 32, 1))[:, 0]
    out = f32(0.0)
    for w in range(WARPS):
        out = f32(out + total[w])
    return out, steps


@pytest.mark.parametrize("n_k", [40, 35])
def test_emulated_kernel_equals_its_tree_and_the_plain_version(n_k):
    """40: a round of 32 and a last round of 8; 35: a last round of 3 (one
    batch of 2 and a step alone at G = 2). Every batch gives the tree's
    output and steps bit for bit; both are near the plain version."""
    want_out, want_steps = emulate_15a(n_k)
    for g in probe_parts.BATCHES:
        out, steps = emulate_15a(n_k, batch=g)
        assert _bits(out) == _bits(want_out)
        np.testing.assert_array_equal(_bits(steps), _bits(want_steps))
    plain = probes.moments_vpu_plain(n_k, 1, "cpu")
    assert abs(float(want_out) - float(plain[0, 0])) \
        <= GRAD_RTOL * abs(float(plain[0, 0]))
    sizes = probes.moments_vpu_plain_steps(n_k, "cpu", sizes=True) \
        .clamp(min=1.0).numpy()
    err = np.abs(want_steps - probes.moments_vpu_plain_steps(n_k, "cpu")
                 .numpy())
    assert np.isfinite(want_steps).all() and (err <= GRAD_RTOL * sizes).all()


# ---------------------------------------------------------------------------
# The per-step values.
# ---------------------------------------------------------------------------

def _steps_f64(n_k):
    """(values, sizes) (n_k, 9) of the probe's recursion in float64 (its
    float32 constants), values in Moments::finish's row order."""
    vy = np.arange(32, dtype=np.float64)[:, None] - 16.0
    vx = np.arange(128, dtype=np.float64)[None, :] - 64.0
    c = {name: float(np.float32(x)) for name, x in (
        ("scale", 1e-6), ("bias", 1e-3), ("keep", 0.999), ("gain", 1e-4))}
    carry = np.full((32, 128), 0.5)
    values, sizes = [], []
    for k in range(n_k):
        z = carry * (c["scale"] * (k + 1)) + c["bias"]
        for out, fn in ((values, lambda x: x), (sizes, np.abs)):
            zz, cc, yy, xx = fn(z), fn(carry), fn(vy), fn(vx)
            r0 = zz.sum(axis=0)
            r1 = (zz * yy).sum(axis=0)
            out.append([(r0 * xx[0]).sum(), r1.sum(),
                        (r0 * xx[0] ** 2).sum(), (r1 * xx[0]).sum(),
                        (zz * yy * yy).sum(), (zz * cc).sum(),
                        (zz * yy * cc).sum(), (zz * zz).sum(), r0.sum()])
        carry = carry * c["keep"] + z * c["gain"]
    return np.array(values), np.array(sizes)


@pytest.mark.parametrize("n_k", [24, 64])
def test_plain_steps_match_a_float64_recursion(n_k):
    want, sizes = _steps_f64(n_k)
    got = probes.moments_vpu_plain_steps(n_k, "cpu")
    got_sizes = probes.moments_vpu_plain_steps(n_k, "cpu", sizes=True)
    assert got.shape == (n_k, 9) and got.dtype == torch.float32
    np.testing.assert_array_less(np.abs(got.numpy() - want),
                                 STEPS_F64_RTOL * np.maximum(sizes, 1.0))
    np.testing.assert_array_less(np.abs(got_sizes.numpy() - sizes),
                                 STEPS_F64_RTOL * np.maximum(sizes, 1.0))
    # r0 vx, r1, r1 vx and sum z vy carry cancel over the tile (vx and vy
    # change sign across it); the other five are sums of positive terms,
    # their own sizes.
    cancel, positive = [0, 1, 3, 6], [2, 4, 5, 7, 8]
    assert (np.abs(want[:, cancel]) < 0.1 * sizes[:, cancel]).all()
    np.testing.assert_allclose(want[:, positive], sizes[:, positive],
                               rtol=1e-12)
    # The steps add up to the plain output.
    out = probes.moments_vpu_plain(n_k, 1, "cpu")
    assert float(got.sum()) == pytest.approx(float(out[0, 0]), rel=1e-6)


def test_cpu_wrapper_fills_the_steps_with_the_plain_steps():
    name, wrapper, plain = probes.MOMENT_PROBES["vpu"]
    steps = torch.full((64, probes.VPU_VALUES), float("nan"))
    before = dict(probes.launches)
    out = wrapper("cpu", n_k=64, n_blocks=2, steps=steps)
    assert probes.launches == before
    assert torch.equal(out, plain(64, 2, "cpu"))
    width, plain_steps = probes.MOMENT_STEPS["vpu"]
    assert width == 9
    assert torch.equal(steps, plain_steps(64, "cpu"))
    assert probes.MOMENT_REFERENCES["vpu"][0] == "moments_cuda_cores_tree"
    assert "moments_cuda_cores_tree" in probes.REFERENCE_COUNTERS
