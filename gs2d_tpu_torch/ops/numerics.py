"""Low-level numerics shared by every rasterization path (the counterpart of
``gs2d_tpu/ops/numerics.py``).

- ``pcg`` / ``pcg3d``: deterministic uint32 hash RNG (reference main.cpp:10-24)
- ``exp_approx``: (1 + x/8)^8 fast exponential with a flush-to-zero guard
  (reference main.cpp:49-83)
- ``solve_quadratic``: cancellation-safe quadratic roots (main.cpp:171-185)
- ``sign_of``: branchless sign with sign(0) = +1 (main.cpp:34-37)
- ``log_f32``: the float32 natural log the JAX package computes on a CPU,
  operation for operation (the opacity cull's per-splat cutoff)

PyTorch's ``uint32`` supports few operations, so the hashes run in ``int64``
holding values in [0, 2^32) and reduce every product and sum mod 2^32. A
product of two 32-bit words would overflow ``int64``, so ``_mul32`` splits
one factor into 16-bit halves; every intermediate stays below 2^49.
"""

from __future__ import annotations

import struct

import torch

from gs2d_tpu_torch.config import EXP_APPROX_FLUSH

UINT32_MAX_F = 4294967296.0  # float(0xFFFFFFFF) rounds up to 2^32
_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 tensors holding uint32 values."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _as_u32(v) -> torch.Tensor:
    v = torch.as_tensor(v)
    if v.dtype != torch.int64:
        v = v.to(torch.int64)
    return v & _M32


def pcg(v) -> torch.Tensor:
    """PCG hash of uint32 values held in int64 (reference main.cpp:10-15)."""
    v = _as_u32(v)
    state = (_mul32(v, 747796405) + 2891336453) & _M32
    shift = (state >> 28) + 4
    word = _mul32((state >> shift) ^ state, 277803737)
    return (word >> 22) ^ word


def pcg3d(v) -> torch.Tensor:
    """3-lane PCG hash; ``v`` has shape (..., 3) (reference main.cpp:17-24)."""
    v = (_mul32(_as_u32(v), 1664525) + 1013904223) & _M32
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    x = (x + _mul32(y, z)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = (x + _mul32(y, z)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    return torch.stack([x, y, z], dim=-1)


def pcg3d_unit(v) -> torch.Tensor:
    """pcg3d mapped to [0, 1) floats the way the reference converts it
    (uint32 -> float32 rounding to nearest, then / float(0xFFFFFFFF);
    reference main.cpp:290-291)."""
    return pcg3d(v).to(torch.float32) / UINT32_MAX_F


def sign_of(v: torch.Tensor) -> torch.Tensor:
    """sign with sign(0) == +1 (reference main.cpp:34-37)."""
    return torch.where(v < 0.0, -1.0, 1.0).to(v.dtype)


def exp_approx(x: torch.Tensor) -> torch.Tensor:
    """Fast exp: (1 + x/8)^8 by three squarings, flushing to zero below the
    subnormal-safety threshold (reference main.cpp:49-83)."""
    x = 1.0 + x * 0.125
    flush = x < EXP_APPROX_FLUSH
    x = x * x
    x = x * x
    x = x * x
    return torch.where(flush, torch.zeros_like(x), x)


def exp_ref(x: torch.Tensor, use_approx: bool = True) -> torch.Tensor:
    """exp_approx by default; exact exp in validation mode (main.cpp:51)."""
    return exp_approx(x) if use_approx else torch.exp(x)


def solve_quadratic(a, b, c):
    """Roots of a*x^2 + b*x + c = 0, cancellation-safe (main.cpp:171-185).

    Returns (ok, x_lo, x_hi); where ``ok`` is False the roots are garbage and
    must be masked by the caller. ``torch.minimum``/``maximum`` propagate NaN
    like ``jnp.minimum``."""
    det = b * b - 4.0 * a * c
    ok = det >= 0.0
    sdet = torch.sqrt(torch.clamp(det, min=0.0))
    k = (-b - sign_of(b) * sdet) * 0.5
    x0 = k / a
    x1 = c / k
    return ok, torch.minimum(x0, x1), torch.maximum(x0, x1)


def trunc_to_int(x: torch.Tensor) -> torch.Tensor:
    """C-style float -> int32 conversion (truncation toward zero), with
    XLA's edge semantics: NaN -> 0 and saturation at the int32 range (a
    plain ``.to(int32)`` of those is undefined in C++)."""
    t = torch.trunc(x).clamp(-2147483648.0, 2147483648.0)
    t = torch.where(torch.isnan(t), torch.zeros_like(t), t)
    return t.to(torch.int64).clamp(max=2147483647).to(torch.int32)


def _f32_const(bits: int) -> float:
    """The float32 whose bit pattern is ``bits``, as a Python float."""
    return struct.unpack("<f", struct.pack("<I", bits))[0]


# Cephes' single-precision log (as Eigen's plog_float, which XLA's CPU
# backend emits for jnp.log): sqrt(1/2), the polynomial's nine coefficients
# and the two parts of ln 2, each the float32 of its bit pattern.
_LOG_SQRTHF = _f32_const(0x3F3504F3)
_LOG_P = [_f32_const(b) for b in (
    0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50,
    0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)]
_LOG_Q1 = _f32_const(0xB95E8083)
_LOG_Q2 = _f32_const(0x3F318000)
_FLT_MIN = _f32_const(0x00800000)


def _fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c as a fused multiply-add: the product is exact in
    float64; the sum rounds to float64 and then to float32, which differs
    from one rounding only where the float64 sum falls on a float32
    midpoint."""
    d = torch.float64
    return (a.to(d) * b + c.to(d) if torch.is_tensor(c) else
            a.to(d) * b + c).to(torch.float32)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of a float32 tensor, bit for bit the JAX package's
    ``jnp.log`` on a CPU (Cephes' polynomial in the order XLA's CPU backend
    evaluates it, with the multiply-adds it fuses), on any device. The
    libraries' own logs (torch's, CUDA's) differ from it in the last place
    for a few percent of inputs. 0 and subnormals (read as zero, as XLA's
    CPU code does) -> -inf, +inf -> +inf, x < 0 and NaN -> NaN."""
    i32 = torch.int32
    xc = torch.where(x <= _FLT_MIN, torch.full_like(x, _FLT_MIN), x)
    bits = xc.view(i32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & -2139095041) | 1056964608).view(torch.float32)
    small = m < _LOG_SQRTHF
    zero = torch.zeros_like(m)
    x1 = (m - 1.0) + torch.where(small, m, zero)
    e = e - torch.where(small, torch.ones_like(m), zero)
    x2 = x1 * x1
    x3 = x2 * x1
    p = _LOG_P
    y = _fma(_fma(x1, p[0], p[1]), x1, p[2])
    y1 = _fma(_fma(x1, p[3], p[4]), x1, p[5])
    y2 = _fma(_fma(x1, p[6], p[7]), x1, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    r = _fma(e, _LOG_Q2, _fma(x2, -0.5, x1) + y)
    r = torch.where(x <= 0.0, torch.full_like(r, float("nan")), r)
    r = torch.where(torch.isnan(x), x, r)
    r = torch.where(x == float("inf"), x, r)
    return torch.where(x.abs() < _FLT_MIN, torch.full_like(r, float("-inf")),
                       r)
