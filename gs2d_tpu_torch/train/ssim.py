"""Differentiable SSIM for the perceptual fitting objective (the counterpart
of ``gs2d_tpu/train/ssim.py``): loss = (1 - lam) * L2 + lam * (1 - SSIM),
lam typically 0.2.

The SSIM head is plain PyTorch on top of the rasterizer's analytic
backward (``ops/render_flat.production_render``): autograd differentiates
the window statistics, the layout's backward kernel supplies dC/dparams.
The Gaussian window is two separable depthwise 1-D convolutions with zero
"SAME" padding, as in gs2d_tpu, where XLA computes them and no Pallas
kernel does. Here ``torch.nn.functional.conv2d`` (``groups`` = channels)
computes them, all five blurred images of one SSIM in one call per axis:
eleven shifted multiply-adds per axis would issue some hundred elementwise
launches a step where the convolution issues four. On the card the
convolution goes through cuDNN, which by default runs float32 in TF32 and
may pick nondeterministic algorithms, so the train step runs the loss and
its gradient under ``conv_flags()`` (full float32, deterministic).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def conv_flags():
    """cuDNN settings for the SSIM head: full float32 (no TF32) and
    deterministic algorithms. The convolutions' backward runs inside
    ``torch.autograd.grad``, so the whole loss-and-gradient must run under
    them, not the forward alone."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


@functools.lru_cache(maxsize=8)
def _gauss_kernel_np(window: int, sigma: float):
    # A host (numpy) array, as in gs2d_tpu, where a cached jnp array built
    # while tracing would leak a tracer into later traces.
    x = np.arange(window, dtype=np.float32) - (window - 1) / 2.0
    k = np.exp(-0.5 * (x / np.float32(sigma)) ** 2)
    return k / np.sum(k)


@functools.lru_cache(maxsize=8)
def _gauss_kernel(window: int, sigma: float, device) -> torch.Tensor:
    """The taps on ``device``, copied from the host once: a CUDA graph of
    the step captures no host-to-device copy."""
    return torch.from_numpy(_gauss_kernel_np(window, sigma)).to(device)


def _blur(img: torch.Tensor, window: int, sigma: float) -> torch.Tensor:
    """Separable depthwise Gaussian blur of an (H, W, C) image with zero
    "SAME" padding (odd ``window``)."""
    if window % 2 == 0:
        raise ValueError(f"window {window} must be odd")
    k = _gauss_kernel(window, sigma, img.device)
    c = img.shape[-1]
    x = img.permute(2, 0, 1)[None]                       # (1, C, H, W)
    kv = k.view(1, 1, window, 1).repeat(c, 1, 1, 1)
    kh = k.view(1, 1, 1, window).repeat(c, 1, 1, 1)
    x = F.conv2d(x, kv, padding=(window // 2, 0), groups=c)
    x = F.conv2d(x, kh, padding=(0, window // 2), groups=c)
    return x[0].permute(1, 2, 0)


def ssim(a: torch.Tensor, b: torch.Tensor, window: int = 11,
         sigma: float = 1.5, data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM between (H, W, C) images (Wang et al. 2004 constants)."""
    c1 = float(np.float32((0.01 * data_range) ** 2))
    c2 = float(np.float32((0.03 * data_range) ** 2))
    c = a.shape[-1]
    mu_a, mu_b, m_aa, m_bb, m_ab = torch.split(
        _blur(torch.cat([a, b, a * a, b * b, a * b], dim=-1), window, sigma),
        c, dim=-1)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = m_aa - mu_aa
    var_b = m_bb - mu_bb
    cov = m_ab - mu_ab
    s = ((2 * mu_ab + c1) * (2 * cov + c2)) / (
        (mu_aa + mu_bb + c1) * (var_a + var_b + c2))
    return s.mean()


def mixed_loss(color: torch.Tensor, ref: torch.Tensor,
               lam: float) -> torch.Tensor:
    """(1-lam) * 0.5*sum((C-ref)^2) + lam * (1 - SSIM) * npix.

    Both terms are on the un-normalized L2 scale the analytic backward
    uses (0.5*sum d^2, cotangent C - ref), so ``lam=0`` is the reference
    objective."""
    d = color - ref
    l2 = 0.5 * torch.sum(d * d)
    npix = float(color.shape[0] * color.shape[1])
    return (float(np.float32(1.0 - lam)) * l2
            + float(np.float32(lam)) * (1.0 - ssim(color, ref)) * npix)
