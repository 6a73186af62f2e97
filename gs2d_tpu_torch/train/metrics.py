"""Convergence metrics comparable with the reference readout (the
counterpart of ``gs2d_tpu/train/metrics.py``): MSE on the 0-255 scale over
RGB (main.cpp:796-807) and the PSNR that follows from it."""

from __future__ import annotations

import torch


def mse_255(color: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Mean squared error on the 0-255 scale over RGB (main.cpp:796-806)."""
    d = (color - ref) * 255.0
    return torch.mean(d * d)


def psnr_from_mse(mse: torch.Tensor) -> torch.Tensor:
    """PSNR in dB from the 0-255-scale MSE."""
    # torch.full, not torch.tensor: a fill kernel, where torch.tensor copies
    # from the host, which a CUDA graph of the step cannot capture.
    return 10.0 * torch.log10(
        torch.full((), 255.0 * 255.0, dtype=mse.dtype, device=mse.device)
        / mse)


def psnr(color: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return psnr_from_mse(mse_255(color, ref))

