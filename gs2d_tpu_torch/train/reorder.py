"""Spatial (Morton) reordering of the splat population (the counterpart of
``gs2d_tpu/train/reorder.py``).

Sorting the population along a Morton (Z-order) curve of splat centres
makes each tile's ascending id list nearly contiguous, which is what the
window layout (``ops/render_window.py``) needs for a narrow window.
Reordering changes the fixed compositing order, so it is an explicit
maintenance step between fit blocks (CLI ``--reorder-every``), never applied
silently. Adam's moments follow their splats through the permutation; the
bias powers and the step count are order-free. Dead slots (pos at DEAD_POS)
sort to the end.

The codes are computed in int64 rather than gs2d_tpu's uint32 (PyTorch's
bit operations on uint32 are incomplete, on CUDA above all); every value
fits in 32 bits, so the codes and the stable sort's permutation are
integer-equal to gs2d_tpu's.
"""

from __future__ import annotations

import dataclasses

import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.params import DEAD_POS, GaussianParams
from gs2d_tpu_torch.train.loop import TrainState

_DEAD_CODE = 0xFFFFFFFF


def _part1by1(x: torch.Tensor) -> torch.Tensor:
    """Interleave the low 16 bits of int64 ``x`` with zeros."""
    x = x & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def morton_codes(params: GaussianParams, cfg: SplatConfig) -> torch.Tensor:
    """(N,) int64 Z-order codes of splat centres on a 16-bit grid (the
    float32 clip, then a truncating cast); dead slots get 0xFFFFFFFF."""
    scale = 65535.0
    x = params.pos[:, 0] / float(max(cfg.width, 1))
    y = params.pos[:, 1] / float(max(cfg.height, 1))
    qx = torch.clamp(x, 0.0, 1.0) * scale
    qy = torch.clamp(y, 0.0, 1.0) * scale
    code = _part1by1(qx.to(torch.int64)) | (_part1by1(qy.to(torch.int64)) << 1)
    dead = params.pos[:, 0] <= DEAD_POS * 0.5
    return torch.where(dead, _DEAD_CODE, code)


def reorder_perm(params: GaussianParams, cfg: SplatConfig) -> torch.Tensor:
    """Stable permutation sorting the splats along the Morton curve."""
    return torch.sort(morton_codes(params, cfg), stable=True).indices


def reorder_state(state: TrainState, cfg: SplatConfig) -> TrainState:
    """Permute the population and its Adam moments into Morton order."""
    perm = reorder_perm(state.params, cfg)

    def take(x):
        return x.index_select(0, perm)

    return TrainState(
        params=state.params.map(take),
        opt=dataclasses.replace(state.opt, m=state.opt.m.map(take),
                                v=state.opt.v.map(take)),
    )
