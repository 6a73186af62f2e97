"""Splat geometry: covariance construction and inversion (the counterpart of
``gs2d_tpu/ops/geometry.py``), vectorized over the splat axis.

The math follows the reference's expanded trigonometric forms so that
float32 rounding matches (main.cpp:206-221, 432-436, 488-489). The eigen
helpers (main.cpp:188-196, 223-234) serve visualization, not the hot path.
"""

from __future__ import annotations

import torch


def cov_of(sx, sy, rot):
    """Covariance entries (s11, s12, s22) from scale/rotation parameters:
    s11 = sx^2 cos^2 + sy^2 sin^2, s12 = (sx^2 - sy^2) sin cos,
    s22 = sx^2 + sy^2 - s11 (reference main.cpp:206-221)."""
    c = torch.cos(rot)
    s = torch.sin(rot)
    l0 = sx * sx
    l1 = sy * sy
    s11 = l0 * c * c + l1 * s * s
    s12 = (l0 - l1) * s * c
    s22 = l0 + l1 - s11
    return s11, s12, s22


def det_of_cov(s11, s12, s22):
    """det(Sigma) as the reference's backward computes it (main.cpp:560)."""
    return s11 * s22 - s12 * s12


def inv_cov_of(s11, s12, s22):
    """Closed-form inverse of the symmetric 2x2 covariance: (a, b, d, det)
    with inv = [[a, b], [b, d]] (adjugate / det; main.cpp:432-436)."""
    det = det_of_cov(s11, s12, s22)
    return s22 / det, -s12 / det, s11 / det, det


def eigenvalues_2x2(s11, s12, s22):
    """Eigenvalues of the symmetric 2x2 matrix, lambda0 >= lambda1, and its
    determinant (reference main.cpp:188-196)."""
    mean = (s11 + s22) * 0.5
    det = det_of_cov(s11, s12, s22)
    d = torch.sqrt(torch.clamp(mean * mean - det, min=0.0))
    return mean + d, mean - d, det


def eigenvectors_of_cov(s11, s12, s22, lambda0):
    """Unit eigenvectors (e0 for lambda0, e1 perpendicular), the branch
    chosen for numerical stability (reference main.cpp:223-234)."""
    eps = 1e-15
    ex = torch.where(s11 < s22, s12 + eps, lambda0 - s22)
    ey = torch.where(s11 < s22, lambda0 - s11, s12 + eps)
    norm = torch.sqrt(ex * ex + ey * ey)
    e0 = torch.stack([ex / norm, ey / norm], dim=-1)
    e1 = torch.stack([-e0[..., 1], e0[..., 0]], dim=-1)
    return e0, e1


def bbox_half_height(a_inv, det, bounds: float):
    """Vertical half-extent sqrt(inv_cov[0][0] * det) * bounds
    (reference main.cpp:489)."""
    return torch.sqrt(a_inv * det) * bounds


def bbox_half_width(d_inv, det, bounds: float):
    """Horizontal half-extent sqrt(inv_cov[1][1] * det) * bounds
    (reference main.cpp:488)."""
    return torch.sqrt(d_inv * det) * bounds
