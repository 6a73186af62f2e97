"""Inputs made from the seed: splat populations and target images.

Everything is drawn on the device with a ``torch.Generator`` seeded from
(seed, index), in a few large calls, so that the same seed gives the same
inputs and the reference gets exactly the tensors the program got.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FIELDS = ("pos", "sx", "sy", "rot", "color", "opacity")


def derive(seed: int, *index: int) -> int:
    """A 63-bit seed for stream ``index`` of ``seed`` (any size of int)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    ss = np.random.SeedSequence(words + [int(i) for i in index])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def population(config: dict, seed: int, index: int, device,
               color: str = "init") -> dict:
    """One population of ``config["n_splats"]`` splats, uniform over the
    reference's init ranges (config["init"]): position over the image,
    scales in [scale_min, scale_max], rotation in [0, pi) and one opacity
    for all; one colour for all (``color`` "init"), or each splat's colour
    uniform in [0, 1] ("uniform"), as a fitted population has them."""
    n, w, h = config["n_splats"], config["width"], config["height"]
    init = config["init"]
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, 1, index))
    u = torch.rand((5, n), generator=gen, device=device)
    lo, hi = init["scale_min"], init["scale_max"]
    if color == "uniform":
        col = torch.rand((n, 3), generator=gen, device=device)
    elif color == "init":
        col = torch.full((n, 3), init["color"], device=device)
    else:
        raise ValueError(f"unknown colour draw {color!r}")
    return {
        "pos": torch.stack([u[0] * (w - 1), u[1] * (h - 1)], -1),
        "sx": lo + (hi - lo) * u[2],
        "sy": lo + (hi - lo) * u[3],
        "rot": math.pi * u[4],
        "color": col,
        "opacity": torch.full((n,), init["opacity"], device=device),
    }


def _load(path: str) -> np.ndarray:
    arr = np.load(path, allow_pickle=False)
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / np.float32(255.0)
    return arr.astype(np.float32)


def synthetic(height: int, width: int, phase: float, device) -> torch.Tensor:
    """The smooth synthetic target of the program's test images, with
    ``phase`` in the place of their seed: (H, W, 3) float32 in [0, 1]."""
    y = torch.linspace(0.0, 1.0, height, device=device)[:, None]
    x = torch.linspace(0.0, 1.0, width, device=device)[None, :]
    r = 0.5 + 0.5 * torch.sin(6.0 * x + phase) * torch.cos(5.0 * y)
    g = 0.5 + 0.5 * torch.cos(4.0 * x) * torch.sin(7.0 * y + phase)
    b = (x * y).expand(height, width)
    return torch.stack([r, g, b], -1).clamp(0.0, 1.0).contiguous()


def target(config: dict, seed: int, device) -> torch.Tensor:
    """The configuration's (H, W, 3) target: its image file, or the
    synthetic pattern with a phase drawn from the seed."""
    h, w = config["height"], config["width"]
    target = config["target"]
    if target["kind"] == "file":
        img = torch.from_numpy(_load(target["path"])).to(device)
        if tuple(img.shape) != (h, w, 3):
            raise ValueError(f"{target['path']}: {tuple(img.shape)} is not "
                             f"({h}, {w}, 3)")
        return img
    if target["kind"] == "synthetic":
        rng = np.random.default_rng(derive(seed, 2))
        phase = float(rng.uniform(0.0, 2.0 * math.pi))
        return synthetic(h, w, phase, device)
    raise ValueError(f"unknown target kind {target['kind']!r}")
