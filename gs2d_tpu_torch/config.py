"""Configuration of the PyTorch port: the same frozen dataclass as
``gs2d_tpu.config`` (every reference constant, every rasterizer static),
kept as the port's own copy so that this package never imports the JAX one.
``tests/test_torch_numerics.py`` pins each field and default to the JAX
class, so the two cannot drift apart silently.

Field meanings are documented in ``gs2d_tpu/config.py``; the port runs the
``resident``, ``flat``, ``dense`` and ``window`` layouts, and refuses
configurations that need a later slice (see ``train/loop.fit``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SplatConfig:
    """Static hyperparameters of the 2D Gaussian splatting fitter."""

    # --- image / workload -------------------------------------------------
    width: int = 268
    height: int = 213
    n_splats: int = 1024  # reference main.cpp:271

    # --- rasterization ----------------------------------------------------
    splat_bounds: float = 3.0  # reference main.cpp:7
    min_throughput: float = 1.0 / 256.0  # reference main.cpp:8, 518-521
    use_exp_approx: bool = True  # (1+x/8)^8 fast exp, main.cpp:49-83

    # --- optimizer (reference-faithful Adam) ------------------------------
    adam_beta1: float = 0.9   # reference main.cpp:136
    adam_beta2: float = 0.99  # reference main.cpp:137
    adam_eps: float = 1.0e-15  # reference main.cpp:154
    learning_rate: float = 0.05  # reference main.cpp:715
    optimize_opacity: bool = False  # reference main.cpp:317
    lr_final: float = 0.005
    lr_decay_iters: int = 0

    # --- init ranges (reference main.cpp:294-302) -------------------------
    init_scale_min: float = 6.0
    init_scale_max: float = 10.0
    init_color: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    init_opacity: float = 1.0

    # --- clamp constraints (reference main.cpp:741-749) -------------------
    scale_min: float = 1.0
    scale_max: float = 1024.0
    opacity_min: float = 0.1
    opacity_max: float = 1.0

    # --- tile rasterizer ---------------------------------------------------
    tile_h: int = 8
    tile_w: int = 128
    max_splats_per_tile: Optional[int] = None
    splat_chunk: int = 256
    max_tiles_per_splat: int = 32
    exact_cull: bool = True
    alpha_cache: bool = True
    rebin_margin: float = 0.0
    opacity_cull_alpha: float = 0.0

    # --- binning layout ----------------------------------------------------
    binning: str = "auto"
    window_width: Optional[int] = None
    flat_chunk: int = 256
    flat_capacity: Optional[int] = None
    flat_max_chunks: Optional[int] = None
    tile_rows_multiple: int = 1

    @property
    def image_shape(self) -> Tuple[int, int]:
        return (self.height, self.width)

    @property
    def cutoff_sq(self) -> float:
        return self.splat_bounds * self.splat_bounds

    @property
    def n_tiles_y(self) -> int:
        base = -(-self.height // self.tile_h)
        m = self.tile_rows_multiple
        return -(-base // m) * m

    @property
    def n_tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def padded_height(self) -> int:
        return self.n_tiles_y * self.tile_h

    @property
    def padded_width(self) -> int:
        return self.n_tiles_x * self.tile_w

    def replace(self, **kw) -> "SplatConfig":
        return dataclasses.replace(self, **kw)


# Flush-to-zero threshold of the fast exp (reference main.cpp:75).
EXP_APPROX_FLUSH = 0.00001814586175896693021059036255

PI = math.pi
