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
``launches[<name>]`` where it launches its kernel, and nowhere else.

``fma_peak_flops`` and ``moments_flops`` count each function's float32 operations once from its
definition (an add, a multiply or a compare is one; a product of an (m, k)
by a (k, n) matrix is 2 m k n), whatever unit carries them out, for the
bound that ``chip_smoke.py`` and the scripts report.
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
            "moments_tensor_cores": 0, "moments_scratch_contraction": 0}


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


def moments_flops(kind: str, n_k: int) -> int:
    """Float32 operations of one block's n_k steps. Per pixel and step: z 2
    and the carry update 3. "vpu": the products z vy, z vy vy, z carry,
    z vy carry, z z 5 and the six sums over rows 6; per column r0 vx,
    r0 vx vx, r1 vx 3 and the nine sums over columns 9; the nine totals
    added onto the scalar 9. "mxu": the (32, 128) @ (128, 8) product over
    the three columns of Vx that are not zero (1, vx, vx^2; the other five
    give zeros whatever z is and need no work); over those (32, 3) the three
    sums over rows and the products by vy and vy^2 (5), vy^2 once per row,
    the sums of the three (1, 3) rows 6; per pixel the two other sums with
    their products 4; five adds onto the scalar. "mxu2": the
    (n_k, 4096) @ (4096, 9) product and the fold's 3 x 128 adds."""
    if kind == "vpu":
        return n_k * (_PIXELS * 16 + TILE_W * 12 + 9)
    if kind == "mxu":
        stage2 = 5 * TILE_H * MXU_COLUMNS + TILE_H + 3 * (MXU_COLUMNS - 1)
        return n_k * (_PIXELS * 9 + 2 * _PIXELS * MXU_COLUMNS + stage2 + 5)
    if kind == "mxu2":
        return n_k * (_PIXELS * 5 + 2 * _PIXELS * 9) + 3 * TILE_W
    raise ValueError(f"unknown moment probe {kind!r}")


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


def moments_vpu_plain(n_k: int, n_blocks: int, device) -> torch.Tensor:
    """Plain twin of kernel 15a, the float32 operations of ``kernel_vpu``
    in its order: six sums over rows, the column monomials, nine sums over
    columns, their sum added onto the scalar."""
    vx, vy = _tile_offsets(device)
    vx_row = vx[:1]
    acc = torch.zeros((), dtype=torch.float32, device=device)
    for z, carry in _z_steps(n_k, device):
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
        acc = acc + stacked.sum(dim=1).sum()
    return acc.expand(n_blocks, TILE_W)


def moments_mxu_plain(n_k: int, n_blocks: int, device) -> torch.Tensor:
    """Plain twin of kernel 15b: per step A = z @ [1, vx, vx^2, 0...] in
    full float32, its sums over rows under 1, vy, vy^2, and the two pixel
    sums."""
    vx, vy = _tile_offsets(device)
    vxc = vx[0]
    big_vx = torch.zeros((TILE_W, 8), dtype=torch.float32, device=device)
    big_vx[:, 0], big_vx[:, 1], big_vx[:, 2] = 1.0, vxc, vxc * vxc
    vy_col = vy[:, :1]
    acc = torch.zeros((), dtype=torch.float32, device=device)
    for z, carry in _z_steps(n_k, device):
        a = z @ big_vx
        s0 = a.sum(dim=0)
        s1 = (a * vy_col).sum(dim=0)
        s2 = (a * (vy_col * vy_col)).sum(dim=0)
        acc = acc + (s0.sum() + s1.sum() + s2.sum() + (z * carry).sum()
                     + (z * z).sum())
    return acc.expand(n_blocks, TILE_W)


def check_contraction_steps(n_k: int, batch: int = 4) -> None:
    """The fold reshapes M (n_k, 9) to (4, n_k 9 / 4) and keeps 128
    columns; the kernel contracts in batches of planes."""
    if n_k <= 0 or n_k % batch or n_k * 9 // 4 < TILE_W:
        raise ValueError(f"n_k = {n_k}: need a positive multiple of {batch} "
                         f"with n_k * 9 / 4 >= {TILE_W}")


def _contraction_fold(n_k: int, n_blocks: int, device, sizes: bool):
    vx, vy = _tile_offsets(device)
    v = torch.stack([torch.ones_like(vx), vx, vy, vx * vx, vx * vy, vy * vy,
                     vx, vy, vx], dim=-1).reshape(_PIXELS, 9)
    zs = torch.stack([z.reshape(-1) for z, _ in _z_steps(n_k, device)])
    m = zs.abs() @ v.abs() if sizes else zs @ v
    out = m.reshape(4, n_k * 9 // 4).sum(dim=0, keepdim=True)[:, :TILE_W]
    return out.expand(n_blocks, TILE_W)


def moments_mxu2_plain(n_k: int, n_blocks: int, device) -> torch.Tensor:
    """Plain twin of kernel 15c: the z planes stacked to (n_k, 4096), one
    product with V (4096, 9) in full float32, and ``kernel_mxu2``'s fold."""
    check_contraction_steps(n_k)
    return _contraction_fold(n_k, n_blocks, device, sizes=False)


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
        want = _contraction_fold(n_k, want.shape[0], want.device, sizes=True)
    return want.abs().clamp(min=1.0)


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


def _moments_cuda(name: str, n_k: int, n_blocks: int, device):
    if n_k <= 0 or n_blocks <= 0:
        raise ValueError(f"n_k {n_k} and n_blocks {n_blocks} must be positive")
    lib = library()
    out = torch.empty((n_blocks, TILE_W), dtype=torch.float32, device=device)
    err = getattr(lib, f"gs2d_{name}")(out.data_ptr(), n_k, n_blocks,
                                       stream(out))
    check(err, f"{name} kernel launch")
    launches[name] += 1
    return out


def moments_cuda_cores(device, n_k: int = N_K,
                       n_blocks: int = 1) -> torch.Tensor:
    """Kernel 15a: the production reduction on the CUDA cores."""
    if _on_card(device):
        return _moments_cuda("moments_cuda_cores", n_k, n_blocks, device)
    return moments_vpu_plain(n_k, n_blocks, device)


def moments_tensor_cores(device, n_k: int = N_K,
                         n_blocks: int = 1) -> torch.Tensor:
    """Kernel 15b: the per-step product on the tensor cores (3xTF32)."""
    if _on_card(device):
        return _moments_cuda("moments_tensor_cores", n_k, n_blocks, device)
    return moments_mxu_plain(n_k, n_blocks, device)


def moments_scratch_contraction(device, n_k: int = N_K,
                                n_blocks: int = 1) -> torch.Tensor:
    """Kernel 15c: z planes staged in shared memory, contracted in batches
    on the tensor cores (3xTF32), then the fold."""
    if not _on_card(device):
        return moments_mxu2_plain(n_k, n_blocks, device)
    from gs2d_tpu_torch.utils.hardware import resolve_budget

    lib = library()
    check_contraction_steps(n_k, lib.gs2d_probe_batch())
    need, limit = lib.gs2d_contraction_smem_bytes(n_k), resolve_budget(
        "smem_per_block", lib.gs2d_max_smem_per_block())
    if need > limit:
        raise ValueError(f"n_k = {n_k} needs {need} B of shared memory per "
                         f"block, more than the card's {limit} B")
    return _moments_cuda("moments_scratch_contraction", n_k, n_blocks,
                         device)


MOMENT_PROBES = {
    "vpu": ("moments_cuda_cores", moments_cuda_cores, moments_vpu_plain),
    "mxu": ("moments_tensor_cores", moments_tensor_cores, moments_mxu_plain),
    "mxu2": ("moments_scratch_contraction", moments_scratch_contraction,
             moments_mxu2_plain),
}


def fma_sass_counts() -> dict:
    """{chains: {"FFMA": n, "FMUL": n, "FADD": n}} of kernel 14's compiled
    code, from ``cuobjdump -sass`` (beside nvcc in the toolkit) on the built
    library: the loop must be fused multiply-adds, since the library is
    compiled with -fmad=false and a multiply and an add would read half the
    peak."""
    import re
    import subprocess

    from gs2d_tpu_torch.ops import _build

    tool = _build.toolkit_binary("cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.build())],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        m = re.match(r"\S*fma_peak_kernelILi(\d+)E", block)
        if m:
            counts[int(m.group(1))] = {
                op: len(re.findall(rf"\b{op}\b", block))
                for op in ("FFMA", "FMUL", "FADD")}
    if not counts:
        raise RuntimeError("cuobjdump shows no fma_peak_kernel in the library")
    return dict(sorted(counts.items()))
