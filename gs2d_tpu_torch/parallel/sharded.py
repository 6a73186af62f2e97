"""Batched state and targets of several images (the counterpart of
``gs2d_tpu/parallel/sharded.py:78-96``): ``init_batched_state`` and
``pad_ref_batch``, which the batched fitters of ``train/loop.py`` and
``train/densify.py`` take. ``init_batched_state`` lives in
``train/loop.py``, so that the fitters need not import this package. The
rest of gs2d_tpu's ``sharded.py`` (the sharded step and fitters over a
device mesh, the ordered (C, T) combine across splat shards) is a later
slice, ``parallel/`` on ``torch.distributed`` (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import numpy as np
import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.train.loop import init_batched_state

__all__ = ["init_batched_state", "pad_ref_batch"]


def pad_ref_batch(refs, cfg: SplatConfig, device) -> torch.Tensor:
    """(B, H, W, 3) targets zero-padded to the tile grid: (B, Hp, Wp, 3)."""
    refs = torch.as_tensor(np.asarray(refs, np.float32), device=device)
    out = torch.zeros((refs.shape[0], cfg.padded_height, cfg.padded_width, 3),
                      dtype=torch.float32, device=device)
    out[:, : cfg.height, : cfg.width] = refs
    return out
