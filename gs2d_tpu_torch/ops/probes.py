"""Measurement probes (the counterparts of the Pallas kernels inside
``scripts/roofline.py`` and ``scripts/probe_mxu_moments.py``): a float32
FMA-issue ceiling and three formulations of the backward's moment
reduction over one 32 x 128 tile.

Four kernels (``csrc/probes.cu``), each behind a wrapper that launches it
for a CUDA device (raising if the launch fails) and runs the plain PyTorch
version beside it for the CPU; the kernels take no input tensor, so the
wrappers dispatch on the ``device`` they are given:

- ``fma_peak``                     <- roofline.py ``kernel``      (kernel 14)
- ``moments_cuda_cores``           <- ``kernel_vpu``              (15a)
- ``moments_tensor_cores``         <- ``kernel_mxu``              (15b)
- ``moments_scratch_contraction``  <- ``kernel_mxu2``             (15c)

The moment probes run ``n_k`` steps of a fake z plane derived from a carry
(``z = carry * 1e-6 (k + 1) + 1e-3``, ``carry = 0.999 carry + 1e-4 z``) and
return ``(n_blocks, 128)``: every block of the grid computes the same
function, so one block reproduces the TPU probe's (1, 128) output and one
block per SM loads the whole card. Each wrapper adds one to
``launches[<name>]`` where it launches its kernel, and nowhere else. The
moment probes take an optional ``steps`` tensor, (n_k, 9), (n_k, 5) and
(n_k, 9), which receives each step's values (``moments_vpu_plain_steps``,
``moments_mxu_plain_steps``, ``moments_mxu2_plain_steps`` on the CPU).
``_moments_cuda_cores_tree_cuda``, ``_moments_tensor_cores_staged_cuda``
and ``_moments_scratch_contraction_sync_cuda`` launch the designs 15a, 15b
and 15c had before their redesigns for the H100 (15a's lane tree, 15b's and
15c's designs before wgmma), kept unchanged as their references for
``chip_smoke.py`` and the card tests (``launches`` counts them too; no path
reaches them).

``fma_peak_flops`` and ``moments_flops`` count each function's float32
operations once from its definition (an add, a multiply or a compare is one;
a product of an (m, k) by a (k, n) matrix is 2 m k n), whatever unit carries
them out; ``moments_flops_split`` parts the matrix product from the rest,
and ``moments_bound`` takes 15b's and 15c's products at the tensor cores'
rate. ``tf32_split``, ``tensor_core_pixels`` and ``swizzled_word`` state in
Python what the two tensor-core kernels do with a value and where they put
it, and ``butterfly_schedule`` which lane 15a's butterfly leaves each value
on, for the CPU tests; ``moments_sass_counts`` counts 15a's and its
reference's instructions in the built library.
"""

from __future__ import annotations

import numpy as np
import torch

from gs2d_tpu_torch.ops._build import check, library, stream

TILE_H, TILE_W = 32, 128
N_K = 512              # the TPU probe's K
FMA_C = 1.0000001      # rounds to 1 + 2^-23 in float32
FMA_B = 1e-9
FMA_INNER = 256
FMA_THREADS = 256      # a block of kernel 14 (csrc/probes.cu kFmaThreads)
# The TPU probe's grid of 4096 steps over (8, 128) accumulators, as blocks
# of 256 threads: 16 384 blocks, 4 194 304 threads.
FMA_GRID = 4096 * 8 * 128 // FMA_THREADS
FMA_CHAINS = (1, 2, 4, 8, 16, 32)
FMA_ULPS = 4           # see fma_peak_plain

launches = {"fma_peak": 0, "moments_cuda_cores": 0,
            "moments_tensor_cores": 0, "moments_scratch_contraction": 0,
            "moments_cuda_cores_tree": 0, "moments_tensor_cores_staged": 0,
            "moments_scratch_contraction_sync": 0}
VPU_VALUES = 9         # 15a's values a step: Moments::finish's rows
MXU_SUMS = 5           # 15b's values a step: s0, s1, s2, sum z carry, sum z z
V_COLUMNS = 9          # 15c's: the columns of V


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _on_card(device) -> bool:
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {device}")
    return kind == "cuda"


# ---------------------------------------------------------------------------
# Operation counts (see the module docstring).
# ---------------------------------------------------------------------------

_PIXELS = TILE_H * TILE_W
MXU_COLUMNS = 3        # the columns of kernel 15b's Vx that are not zero


def fma_peak_flops(chains: int, inner: int, n_threads: int) -> int:
    """2 per FMA, plus the chains' sum."""
    return n_threads * (2 * chains * inner + chains - 1)


def moments_flops_split(kind: str, n_k: int) -> tuple:
    """(product, rest): float32 operations of one block's n_k steps, the
    matrix product's apart (0 for "vpu"). Per pixel and step: z 2 and the
    carry update 3. "vpu": the products z vy, z vy vy, z carry, z vy carry,
    z z 5 and the six sums over rows 6; per column r0 vx, r0 vx vx, r1 vx 3
    and the nine sums over columns 9; the nine totals added onto the scalar
    9. "mxu": the product, (32, 128) @ (128, 8) over the three columns of Vx
    that are not zero (1, vx, vx^2; the other five give zeros whatever z is
    and need no work); over those (32, 3) the three sums over rows and the
    products by vy and vy^2 (5), vy^2 once per row, the sums of the three
    (1, 3) rows 6; per pixel the two other sums with their products 4; five
    adds onto the scalar. "mxu2": the product (n_k, 4096) @ (4096, 9) and
    the fold's 3 x 128 adds."""
    if kind == "vpu":
        return 0, n_k * (_PIXELS * 16 + TILE_W * 12 + 9)
    if kind == "mxu":
        stage2 = 5 * TILE_H * MXU_COLUMNS + TILE_H + 3 * (MXU_COLUMNS - 1)
        return (n_k * 2 * _PIXELS * MXU_COLUMNS,
                n_k * (_PIXELS * 9 + stage2 + 5))
    if kind == "mxu2":
        return n_k * 2 * _PIXELS * V_COLUMNS, n_k * _PIXELS * 5 + 3 * TILE_W
    raise ValueError(f"unknown moment probe {kind!r}")


def moments_flops(kind: str, n_k: int) -> int:
    """All float32 operations of one block's n_k steps
    (``moments_flops_split``'s two parts)."""
    return sum(moments_flops_split(kind, n_k))


def moments_bound(kind: str, n_k: int, n_blocks: int, n_bytes: int):
    """(bound_ms, bound_by) of n_blocks blocks of a moment probe that write
    n_bytes: the larger of its operations' and its bytes' least times. 15a's
    operations run at the CUDA cores' float32 rate. 15b and 15c may run their
    product on the tensor cores, 3xTF32 (three TF32 products for one float32
    product) at the TF32 rate beside the rest at the float32 rate, or all on
    the CUDA cores, whichever is less: min(total / F32_PEAK, max(rest /
    F32_PEAK, 3 product / TF32_PEAK))."""
    from gs2d_tpu_torch.scripts.roofline import F32_PEAK, HBM_RATE, TF32_PEAK

    product, rest = (n_blocks * f for f in moments_flops_split(kind, n_k))
    t_ops = (product + rest) / F32_PEAK
    if product:
        t_ops = min(t_ops, max(rest / F32_PEAK, 3 * product / TF32_PEAK))
    t_bytes = n_bytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the card-side reference in chip_smoke).
# ---------------------------------------------------------------------------

def fma_peak_plain(chains: int, inner: int, grid: int, threads: int,
                   device) -> torch.Tensor:
    """Plain twin of kernel 14: (grid, threads), every element the sum of
    the chains' final values. A fused multiply-add rounds once: a * c is
    exact in float64 (two 24-bit significands), so each step is computed in
    float64 and rounded to float32. The float64 sum rounds first to 53
    bits, so where it lands exactly between two float32 values the second
    rounding can differ from the FMA's by one unit in the last place of one
    chain; callers compare within FMA_ULPS units of the result."""
    a = torch.arange(1, chains + 1, dtype=torch.float64, device=device) \
        .to(torch.float32)
    c = float(np.float32(FMA_C))
    b = float(np.float32(FMA_B))
    for _ in range(inner):
        a = (a.to(torch.float64) * c + b).to(torch.float32)
    s = a[0]
    for i in range(1, chains):
        s = s + a[i]
    return s.expand(grid, threads)


def _tile_offsets(device):
    vy = (torch.arange(TILE_H, dtype=torch.float32, device=device)
          - 16.0)[:, None].expand(TILE_H, TILE_W)
    vx = (torch.arange(TILE_W, dtype=torch.float32, device=device)
          - 64.0)[None, :].expand(TILE_H, TILE_W)
    return vx, vy


def _z_steps(n_k: int, device):
    """Yields (z, carry) of each step, the carry as it was before it."""
    carry = torch.full((TILE_H, TILE_W), 0.5, dtype=torch.float32,
                       device=device)
    for k in range(n_k):
        z = carry * float(np.float32(1e-6) * np.float32(k + 1)) \
            + float(np.float32(1e-3))
        yield z, carry
        carry = carry * float(np.float32(0.999)) \
            + z * float(np.float32(1e-4))


def _vpu_steps(n_k: int, device, sizes: bool = False):
    """Yields kernel 15a's nine values of each step, (9,): ``kernel_vpu``'s
    six sums over rows, the column monomials and the nine sums over columns,
    in Moments::finish's row order [r0 vx, r1, r0 vx^2, r1 vx, r2, sum z
    carry, sum z vy carry, sum z z, r0]; with ``sizes``, the sums of their
    terms' absolute values instead."""
    vx, vy = _tile_offsets(device)
    vx_row = vx[:1]
    if sizes:
        vx_row, vy = vx_row.abs(), vy.abs()
    for z, carry in _z_steps(n_k, device):
        if sizes:
            z, carry = z.abs(), carry.abs()
        zvy = z * vy
        r0 = z.sum(dim=0, keepdim=True)
        r1 = zvy.sum(dim=0, keepdim=True)
        r2 = (zvy * vy).sum(dim=0, keepdim=True)
        c1 = (z * carry).sum(dim=0, keepdim=True)
        c2 = (zvy * carry).sum(dim=0, keepdim=True)
        c3 = (z * z).sum(dim=0, keepdim=True)
        r0x = r0 * vx_row
        stacked = torch.cat([r0x, r1, r0x * vx_row, r1 * vx_row, r2, c1, c2,
                             c3, r0], dim=0)
        yield stacked.sum(dim=1)


def moments_vpu_plain(n_k: int, n_blocks: int, device) -> torch.Tensor:
    """Plain twin of kernel 15a, the float32 operations of ``kernel_vpu``
    in its order: each step's nine values (``_vpu_steps``), their sum added
    onto the scalar."""
    acc = torch.zeros((), dtype=torch.float32, device=device)
    for values in _vpu_steps(n_k, device):
        acc = acc + values.sum()
    return acc.expand(n_blocks, TILE_W)


def moments_vpu_plain_steps(n_k: int, device,
                            sizes: bool = False) -> torch.Tensor:
    """(n_k, 9): each step's nine values, which kernel 15a writes to its
    ``steps``; with ``sizes``, the sums of their terms' absolute values
    (r0 vx, r1, r1 vx and sum z vy carry cancel over the tile), the scale
    of their errors."""
    return torch.stack(list(_vpu_steps(n_k, device, sizes)))


def _mxu_steps(n_k: int, device, sizes: bool = False):
    """Yields kernel 15b's five values of each step as 0-d tensors: with
    ``sizes``, the sums of their terms' absolute values instead."""
    vx, vy = _tile_offsets(device)
    vxc = vx[0]
    big_vx = torch.zeros((TILE_W, 8), dtype=torch.float32, device=device)
    big_vx[:, 0], big_vx[:, 1], big_vx[:, 2] = 1.0, vxc, vxc * vxc
    vy_col = vy[:, :1]
    if sizes:
        big_vx, vy_col = big_vx.abs(), vy_col.abs()
    for z, carry in _z_steps(n_k, device):
        if sizes:
            z, carry = z.abs(), carry.abs()
        a = z @ big_vx
        s0 = a.sum(dim=0)
        s1 = (a * vy_col).sum(dim=0)
        s2 = (a * (vy_col * vy_col)).sum(dim=0)
        yield (s0.sum(), s1.sum(), s2.sum(), (z * carry).sum(),
               (z * z).sum())


def moments_mxu_plain(n_k: int, n_blocks: int, device) -> torch.Tensor:
    """Plain twin of kernel 15b: per step A = z @ [1, vx, vx^2, 0...] in
    full float32, its sums over rows under 1, vy, vy^2, and the two pixel
    sums."""
    acc = torch.zeros((), dtype=torch.float32, device=device)
    for s0, s1, s2, c1, c2 in _mxu_steps(n_k, device):
        acc = acc + (s0 + s1 + s2 + c1 + c2)
    return acc.expand(n_blocks, TILE_W)


def moments_mxu_plain_steps(n_k: int, device,
                            sizes: bool = False) -> torch.Tensor:
    """(n_k, 5): each step's s0, s1, s2 (the sums of A under 1, vy, vy^2),
    sum z carry and sum z z, which kernel 15b writes to its ``steps``; with
    ``sizes``, the sums of their terms' absolute values (s1's terms cancel
    over vy), the scale of their errors."""
    rows = [torch.stack(v) for v in _mxu_steps(n_k, device, sizes)]
    return torch.stack(rows)


def check_contraction_steps(n_k: int, batch: int = 4) -> None:
    """The fold reshapes M (n_k, 9) to (4, n_k 9 / 4) and keeps 128
    columns; the kernel contracts in batches of planes."""
    if n_k <= 0 or n_k % batch or n_k * 9 // 4 < TILE_W:
        raise ValueError(f"n_k = {n_k}: need a positive multiple of {batch} "
                         f"with n_k * 9 / 4 >= {TILE_W}")


def contraction_v(device) -> torch.Tensor:
    """V (4096, 9), the TPU kernel's nine columns [1, vx, vy, vx^2, vx vy,
    vy^2, vx, vy, vx] of each pixel (row-major over the tile)."""
    vx, vy = _tile_offsets(device)
    return torch.stack([torch.ones_like(vx), vx, vy, vx * vx, vx * vy,
                        vy * vy, vx, vy, vx], dim=-1).reshape(_PIXELS, 9)


def moments_mxu2_plain_steps(n_k: int, device,
                             sizes: bool = False) -> torch.Tensor:
    """M (n_k, 9) = Z @ V in full float32, the moments kernel 15c writes to
    its ``steps``; with ``sizes``, |Z| @ |V|."""
    v = contraction_v(device)
    zs = torch.stack([z.reshape(-1) for z, _ in _z_steps(n_k, device)])
    return zs.abs() @ v.abs() if sizes else zs @ v


def contraction_fold(m: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """``kernel_mxu2``'s fold of M (n_k, 9): flat, reshaped to (4, n_k 9 /
    4), summed over the 4 rows, the first 128 columns kept; every block's
    row."""
    n_k = m.shape[0]
    out = m.reshape(4, n_k * 9 // 4).sum(dim=0, keepdim=True)[:, :TILE_W]
    return out.expand(n_blocks, TILE_W)


def moments_mxu2_plain(n_k: int, n_blocks: int, device) -> torch.Tensor:
    """Plain twin of kernel 15c: the z planes stacked to (n_k, 4096), one
    product with V (4096, 9) in full float32, and ``kernel_mxu2``'s fold."""
    check_contraction_steps(n_k)
    return contraction_fold(moments_mxu2_plain_steps(n_k, device), n_blocks)


def moments_output_sizes(kind: str, want: torch.Tensor,
                         n_k: int) -> torch.Tensor:
    """The size each output's error is measured against, at least 1: the
    sum of its terms' absolute values. 15a's and 15b's one scalar is a sum
    that positive terms dominate, so its own size ``|want|`` stands for it.
    15c's 128 outputs cycle through nine moments, some of which cancel
    (the sum of z vx is 1/64 of the sum of |z vx|): the same fold over
    |Z| @ |V|, since a product rounded to a few bits keeps that share of
    its own size whatever the sum comes to."""
    if kind == "mxu2":
        want = contraction_fold(moments_mxu2_plain_steps(
            n_k, want.device, sizes=True), want.shape[0])
    return want.abs().clamp(min=1.0)


# ---------------------------------------------------------------------------
# What the tensor-core kernels do with a value and where they put it.
# ---------------------------------------------------------------------------

def tf32_split(x: torch.Tensor) -> tuple:
    """(hi, lo) float32 tensors with hi + lo ~ x, each a TF32 value (a
    10-bit mantissa, the low 13 bits zero): round to nearest with ties away
    from zero, through the int32 view, as csrc/probes.cu::tf32_rna does;
    x - hi is exact, so |x - hi - lo| <= 2^-22 |x| for normal x."""

    def rna(v):
        u = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        u = (u + 0x1000) & 0xFFFFE000
        u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
        return u.to(torch.int32).view(torch.float32)

    x = x.to(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def tensor_core_pixels() -> np.ndarray:
    """Kernel 15b's map, as csrc/probes.cu::moments_tensor_cores_kernel
    computes it: [warp, lane, k-step s, register i] -> (row, column) of the
    tile pixel whose z that register holds, (16, 32, 2, 4, 2). Warpgroup q =
    warp // 4 multiplies columns 64 (q % 2) .. +63 by rows 16 (q // 2) ..
    +15; lane (g, t) = (lane // 4, lane % 4) of its warp j owns columns c,
    c + 8 (c = 64 (q % 2) + 16 j + g) at rows r, r + 4 (r = 16 (q // 2) + 8
    s + t); register i is at row r + 4 (i // 2), column c + 8 (i % 2)."""
    warp, lane, s, i = np.meshgrid(np.arange(16), np.arange(32),
                                   np.arange(2), np.arange(4), indexing="ij")
    q, j, g, t = warp // 4, warp % 4, lane // 4, lane % 4
    row = 16 * (q // 2) + t + 8 * s + 4 * (i // 2)
    col = 64 * (q % 2) + 16 * j + g + 8 * (i % 2)
    return np.stack([row, col], axis=-1)


BUTTERFLY_OFFSETS = (16, 8, 4, 2, 1)
# csrc/probes.cu kStepBatch: the steps whose values 15a reduces together.
MOMENT_STEP_BATCH = 4


def butterfly_keep(n: int) -> int:
    """Of n values, how many the lane with a level's bit clear keeps (the
    first ones); its partner keeps the rest (csrc/probes.cu
    butterfly_keep)."""
    return (n + 1) // 2


def butterfly_schedule(n_values: int) -> list:
    """Kernel 15a's reduce-scatter butterfly over the lanes' n_values
    values, as csrc/probes.cu::butterfly_levels runs it: for each level
    (offset, slots, kept), ``slots`` the values a lane holds before it (one
    shuffle each for the first butterfly_keep(slots)) and ``kept[lane]`` the
    values the lane holds after it, whose sums over the lanes so far it
    carries: the lane with the offset's bit clear keeps the first
    butterfly_keep(slots) of its slots, its partner the rest, and a slot
    past the lane's values (an odd count's last, on the partner) is a spare.
    After the last level every value is on one lane."""
    first, end = [0] * 32, [n_values] * 32
    slots, levels = n_values, []
    for off in BUTTERFLY_OFFSETS:
        keep = butterfly_keep(slots)
        for lane in range(32):
            if lane & off:
                first[lane] += keep
            else:
                end[lane] = min(end[lane], first[lane] + keep)
        levels.append((off, slots, [tuple(range(first[lane], end[lane]))
                                    for lane in range(32)]))
        slots = keep
    return levels


def swizzled_word(row, x):
    """Kernel 15c's stage layout, as its producers store: the 32-bit word of
    element (row, x) of a column block of 128-byte rows (x < 32 the pixel in
    the block), 16-byte chunk x // 4 of the row moved to chunk (x // 4) ^
    (row % 8)."""
    return row * 32 + ((((x >> 2) ^ (row & 7)) << 2) | (x & 3))


# ---------------------------------------------------------------------------
# CUDA launches.
# ---------------------------------------------------------------------------

def _fma_peak_cuda(chains: int, inner: int, grid: int, device):
    lib = library()
    if chains not in FMA_CHAINS or inner <= 0 \
            or inner % lib.gs2d_fma_unroll():
        raise ValueError(f"chains {chains} not in {FMA_CHAINS}, or inner "
                         f"{inner} not a positive multiple of "
                         f"{lib.gs2d_fma_unroll()}")
    if lib.gs2d_fma_threads() != FMA_THREADS:
        raise RuntimeError("csrc/probes.cu kFmaThreads != probes.FMA_THREADS")
    out = torch.empty((grid, FMA_THREADS), dtype=torch.float32,
                      device=device)
    err = lib.gs2d_fma_peak(out.data_ptr(), chains, inner, grid,
                            float(np.float32(FMA_C)),
                            float(np.float32(FMA_B)), stream(out))
    check(err, "fma_peak kernel launch")
    launches["fma_peak"] += 1
    return out


def fma_peak(chains: int, device, inner: int = FMA_INNER,
             grid: int = FMA_GRID) -> torch.Tensor:
    """Kernel 14: every thread of ``grid`` blocks of 256 runs ``chains``
    independent float32 FMA chains of ``inner`` steps from 1, 2, ... and
    writes their sum: (grid, FMA_THREADS)."""
    if _on_card(device):
        return _fma_peak_cuda(chains, inner, grid, device)
    return fma_peak_plain(chains, inner, grid, FMA_THREADS, device)


def _steps_ptr(steps, n_k: int, width: int) -> int:
    """The data pointer of a (n_k, width) float32 contiguous CUDA tensor, or
    0 (the kernel writes no steps) for None."""
    if steps is None:
        return 0
    if (steps.device.type != "cuda" or steps.dtype != torch.float32
            or tuple(steps.shape) != (n_k, width)
            or not steps.is_contiguous()):
        raise ValueError(f"steps must be a contiguous float32 ({n_k}, "
                         f"{width}) CUDA tensor, got {tuple(steps.shape)} "
                         f"{steps.dtype} on {steps.device}")
    return steps.data_ptr()


def _moments_cuda(name: str, n_k: int, n_blocks: int, device,
                  steps=None, width: int = 0):
    """Launches gs2d_<name>; ``width`` > 0: its C entry point takes a steps
    pointer after ``out`` ((n_k, width), or 0)."""
    if n_k <= 0 or n_blocks <= 0:
        raise ValueError(f"n_k {n_k} and n_blocks {n_blocks} must be positive")
    lib = library()
    out = torch.empty((n_blocks, TILE_W), dtype=torch.float32, device=device)
    fn = getattr(lib, f"gs2d_{name}")
    if width:
        err = fn(out.data_ptr(), _steps_ptr(steps, n_k, width), n_k,
                 n_blocks, stream(out))
    else:
        err = fn(out.data_ptr(), n_k, n_blocks, stream(out))
    check(err, f"{name} kernel launch")
    launches[name] += 1
    return out


def _plain_with_steps(plain, plain_steps, n_k, n_blocks, device, steps):
    out = plain(n_k, n_blocks, device)
    if steps is not None:
        steps.copy_(plain_steps(n_k, device))
    return out


def moments_cuda_cores(device, n_k: int = N_K, n_blocks: int = 1,
                       steps: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel 15a: the production reduction on the CUDA cores, its lanes
    reduced by a reduce-scatter butterfly over MOMENT_STEP_BATCH steps;
    ``steps`` (n_k, 9), when given, receives each step's values
    (``moments_vpu_plain_steps``)."""
    if _on_card(device):
        return _moments_cuda("moments_cuda_cores", n_k, n_blocks, device,
                             steps, VPU_VALUES)
    return _plain_with_steps(moments_vpu_plain, moments_vpu_plain_steps, n_k,
                             n_blocks, device, steps)


def _moments_cuda_cores_tree_cuda(n_k: int, n_blocks: int, device):
    """The reference (gs2d_moments_cuda_cores_tree, kernel 15a before the
    butterfly: production's lane tree). For chip_smoke.py and the card
    tests only."""
    return _moments_cuda("moments_cuda_cores_tree", n_k, n_blocks, device)


def moments_tensor_cores(device, n_k: int = N_K, n_blocks: int = 1,
                         steps: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel 15b: the per-step product on the tensor cores (wgmma, 3xTF32,
    z computed in its A fragments); ``steps`` (n_k, 5), when given,
    receives each step's values (``moments_mxu_plain_steps``)."""
    if _on_card(device):
        return _moments_cuda("moments_tensor_cores", n_k, n_blocks, device,
                             steps, MXU_SUMS)
    return _plain_with_steps(moments_mxu_plain, moments_mxu_plain_steps, n_k,
                             n_blocks, device, steps)


def _moments_tensor_cores_staged_cuda(n_k: int, n_blocks: int, device):
    """The reference (gs2d_moments_tensor_cores_staged, kernel 15b before
    wgmma: z staged through a shared plane for mma.sync). For chip_smoke.py
    and the card tests only."""
    return _moments_cuda("moments_tensor_cores_staged", n_k, n_blocks,
                         device)


def _contraction_room(lib, n_k: int, smem_fn) -> None:
    from gs2d_tpu_torch.utils.hardware import resolve_budget

    check_contraction_steps(n_k, lib.gs2d_probe_batch())
    need, limit = smem_fn(n_k), resolve_budget(
        "smem_per_block", lib.gs2d_max_smem_per_block())
    if need > limit:
        raise ValueError(f"n_k = {n_k} needs {need} B of shared memory per "
                         f"block, more than the card's {limit} B")


def moments_scratch_contraction(device, n_k: int = N_K, n_blocks: int = 1,
                                steps: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """Kernel 15c: the z planes, produced in batches of 64 by the carry
    recursion and split at the store into shared-memory stages, contracted
    with V on the tensor cores (wgmma, 3xTF32), then the fold; ``steps``
    (n_k, 9), when given, receives M = Z @ V
    (``moments_mxu2_plain_steps``)."""
    if not _on_card(device):
        return _plain_with_steps(moments_mxu2_plain, moments_mxu2_plain_steps,
                                 n_k, n_blocks, device, steps)
    lib = library()
    _contraction_room(lib, n_k, lib.gs2d_contraction_smem_bytes)
    return _moments_cuda("moments_scratch_contraction", n_k, n_blocks,
                         device, steps, V_COLUMNS)


def _moments_scratch_contraction_sync_cuda(n_k: int, n_blocks: int, device):
    """The reference (gs2d_moments_scratch_contraction_sync, kernel 15c
    before wgmma: batches of 8 planes, __syncthreads between the phases).
    For chip_smoke.py and the card tests only."""
    lib = library()
    _contraction_room(lib, n_k, lib.gs2d_contraction_sync_smem_bytes)
    return _moments_cuda("moments_scratch_contraction_sync", n_k, n_blocks,
                         device)


MOMENT_PROBES = {
    "vpu": ("moments_cuda_cores", moments_cuda_cores, moments_vpu_plain),
    "mxu": ("moments_tensor_cores", moments_tensor_cores, moments_mxu_plain),
    "mxu2": ("moments_scratch_contraction", moments_scratch_contraction,
             moments_mxu2_plain),
}
# The moment probes' references (15a's lane tree, held bit for bit; 15b's
# and 15c's designs before wgmma), by kind: (counter, launcher (n_k,
# n_blocks, device)).
MOMENT_REFERENCES = {
    "vpu": ("moments_cuda_cores_tree", _moments_cuda_cores_tree_cuda),
    "mxu": ("moments_tensor_cores_staged", _moments_tensor_cores_staged_cuda),
    "mxu2": ("moments_scratch_contraction_sync",
             _moments_scratch_contraction_sync_cuda),
}
# Their counters, which no script or path reaches.
REFERENCE_COUNTERS = tuple(name for name, _ in MOMENT_REFERENCES.values())
# Each moment probe's per-step values: (width, plain (n_k, device,
# sizes=False)).
MOMENT_STEPS = {"vpu": (VPU_VALUES, moments_vpu_plain_steps),
                "mxu": (MXU_SUMS, moments_mxu_plain_steps),
                "mxu2": (V_COLUMNS, moments_mxu2_plain_steps)}


def _sass_functions() -> list:
    """The built library's compiled functions, from ``cuobjdump -sass``
    (beside nvcc in the toolkit): one text block each, its name first."""
    import subprocess

    from gs2d_tpu_torch.ops import _build

    tool = _build.toolkit_binary("cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.build())],
                          capture_output=True, text=True, check=True).stdout
    return sass.split("Function : ")[1:]


def fma_sass_counts() -> dict:
    """{chains: {"FFMA": n, "FMUL": n, "FADD": n}} of kernel 14's compiled
    code: the loop must be fused multiply-adds, since the library is
    compiled with -fmad=false and a multiply and an add would read half the
    peak."""
    import re

    counts = {}
    for block in _sass_functions():
        m = re.match(r"\S*fma_peak_kernelILi(\d+)E", block)
        if m:
            counts[int(m.group(1))] = {
                op: len(re.findall(rf"\b{op}\b", block))
                for op in ("FFMA", "FMUL", "FADD")}
    if not counts:
        raise RuntimeError("cuobjdump shows no fma_peak_kernel in the library")
    return dict(sorted(counts.items()))


# FMULs of one step of 15a's body: 8 a pixel (z, z vy, z vy vy, z carry, z
# vy carry, z z and the carry update's two), the step's z scale and
# Moments::finish's 3. Nothing else in 15a or its reference multiplies.
MOMENT_STEP_FMUL = 8 * 8 + 1 + 3
# The shuffles of write_total's tree, once a kernel.
WRITE_TOTAL_SHFL = 5


def moments_sass_counts() -> dict:
    """{"moments_cuda_cores" | "moments_cuda_cores_tree": {"SHFL", "FADD",
    "FMUL", "SEL", "FSEL": n, "step_bodies": n, "shfl_per_step": x}} of
    kernel 15a's and its reference's compiled code: static counts, so
    however far the compiler unrolled the step loops, ``step_bodies`` =
    FMUL / MOMENT_STEP_FMUL steps' bodies are in the code, and
    ``shfl_per_step`` their shuffles, write_total's taken out, per body.
    The butterfly: 12, 10 or 9.25 at G = 1, 2, 4 (the last round's
    single steps beside a batch raise the mean over bodies). The tree's 45
    compile to 30 on the H100's toolkit: the probe's z plane is the same in
    every column, so r0, sum z carry and sum z z are the same on every lane
    of a warp, and ptxas folds their shuffles; the butterfly's selects
    depend on the lane, so it keeps all of its shuffles. Production's z
    differs from pixel to pixel, and its tree keeps all 45."""
    import re

    counts = {}
    for block in _sass_functions():
        m = re.match(r"\S*?(moments_cuda_cores(?:_tree)?)_kernel", block)
        if not m:
            continue
        c = {op: len(re.findall(rf"\b{op}\b", block))
             for op in ("SHFL", "FADD", "FMUL", "SEL", "FSEL")}
        c["step_bodies"] = c["FMUL"] / MOMENT_STEP_FMUL
        c["shfl_per_step"] = (c["SHFL"] - WRITE_TOTAL_SHFL) / max(
            c["step_bodies"], 1)
        counts[m.group(1)] = c
    if len(counts) != 2:
        raise RuntimeError("cuobjdump shows no moments_cuda_cores kernel "
                           "and reference in the library")
    return counts
