"""Window layout (the counterpart of ``gs2d_tpu/ops/render_pallas_window.py``):
the resident fused L2 step whose gradients reach each tile's splats only
through a window [base_t, base_t + W) of the splat axis.

Per-tile id lists are ascending, so after a Morton reorder
(``train/reorder.py``) the ids binned to one tile span a compact range;
``tune_window`` sizes the static width W from the measured spans with a
margin. Ids listed past their tile's window lose their gradient
contribution (the forward is windowless), so they are counted as escaped
and folded into the step's n_dropped: overflow is never silent. On a
population without index locality W tunes to n_pad, where the layout is
the plain resident step.

gs2d_tpu expands each tile's per-slot gradient columns onto its window with
a one-hot matmul and scatter-adds the (16, W) window blocks. The port never
expands onto the splat axis: kernel 12 (``csrc/render_resident.cu``) runs
kernel 1's warp-patch kernel, one moment partial per (tile, slot, pass,
warp), and its patch sum adds splat i's partials only from the tiles whose
window holds i, in tile order. With no escapes that is kernel 1's sum over
a subset of its tiles in the same order, so the window step equals the
resident step bit for bit (gs2d_tpu's two differ by about 1 ulp in the
order of the cross-tile sums).

``l2_render_and_grads_window`` launches kernel 12 for CUDA tensors (adding
one to ``launches["l2_window"]``) and runs the plain twin
``_l2_window_plain`` for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_resident as rr
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.ops._build import on_card
from gs2d_tpu_torch.params import GaussianParams

# Kernel launch counts since the last reset_launch_counts().
launches = {"l2_window": 0}

_n_pad = rr._n_pad


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _span_ends(binning: tl.TileBinning, n_splats: int):
    """Per tile: (first live id, last live id or -1, live mask)."""
    ids = binning.ids.reshape(-1, binning.ids.shape[-1])
    live = ids >= 0
    min_id = torch.where(live, ids, n_splats).min(dim=1).values
    max_id = torch.where(live, ids, -1).max(dim=1).values
    return min_id, max_id, live


def window_bases(binning: tl.TileBinning, n_splats: int,
                 width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile window bases and the escaped-pair count.

    base_t = the first live id's 128-block, clipped so the window stays
    inside [0, n_pad); after the clip-down every live id is >= base_t, so
    escapes happen only past the top edge. Returns (bases (n_tiles,) int32,
    n_escaped 0-d int32: live pairs whose gradient the window loses)."""
    ids = binning.ids.reshape(-1, binning.ids.shape[-1])
    min_id, _, live = _span_ends(binning, n_splats)
    base = torch.clamp(torch.div(min_id, 128, rounding_mode="floor") * 128,
                       0, max(_n_pad(n_splats) - width, 0))
    escaped = (live & (ids >= base[:, None] + width)).sum()
    return base.to(torch.int32), escaped.to(torch.int32)


def measure_window_span(binning: tl.TileBinning,
                        n_splats: int) -> torch.Tensor:
    """Max over tiles of (last live id - first live id's 128-block + 1):
    the smallest W (before rounding) that loses nothing on this binning."""
    min_id, max_id, _ = _span_ends(binning, n_splats)
    span = torch.where(
        max_id >= 0,
        max_id - torch.div(min_id, 128, rounding_mode="floor") * 128 + 1, 0)
    return span.max()


def tune_window(p: GaussianParams, cfg: SplatConfig,
                margin_blocks: int = 2) -> SplatConfig:
    """Fill cfg.window_width from the measured per-tile id spans:
    W = ceil(max span / 128) * 128 + margin_blocks * 128 (slack for drift
    between retunes), capped at n_pad. Call after a Morton reorder; spans on
    an unordered population tune to n_pad."""
    k = rd._max_per_tile(cfg)
    binning = tl.bin_splats(p, cfg, k, ids_only=True)
    span = int(measure_window_span(binning, cfg.n_splats))
    w = min(-(-span // 128) * 128 + margin_blocks * 128,
            _n_pad(cfg.n_splats))
    return cfg.replace(window_width=w)


def _escaped_slots(ids_s, count, bases, width: int) -> torch.Tensor:
    """(n_tiles, K) mask of the listed slots whose id lies past the tile's
    window."""
    slot = torch.arange(ids_s.shape[1], device=ids_s.device)
    return (slot[None] < count[:, None]) & (ids_s >= bases[:, None] + width)


def _l2_window_plain(table, ids_s, count, bases, ref_chw, n_splats: int,
                     cfg: SplatConfig, width: int):
    """Plain twin of kernel 12: kernel 1's plain twin with the escaped
    slots' contributions dropped. (color (1, 3, Hp, Wp), moments
    (16, n_pad))."""
    return rr._l2_resident_plain(table, ids_s, count, ref_chw, n_splats, cfg,
                                 drop=_escaped_slots(ids_s, count, bases,
                                                     width))


def _l2_window_cuda(table, ids_s, count, bases, ref_chw, n_splats: int,
                    cfg: SplatConfig, width: int, walked=None):
    """Kernel 12: kernel 1's patch kernel, then the patch sum over each
    tile's window. ``walked`` as in render_resident._l2_patches."""
    n_tiles = cfg.n_tiles_x * cfg.n_tiles_y
    if (bases.dtype != torch.int32 or tuple(bases.shape) != (n_tiles,)
            or not bases.is_contiguous() or bases.device != table.device):
        raise ValueError(f"bases: need contiguous int32 ({n_tiles},) on "
                         f"{table.device}")
    if width <= 0 or width % 128:
        raise ValueError(f"window width {width}: need a positive multiple "
                         "of 128")
    color, grads16 = rr._l2_patches(table, ids_s, count, ref_chw, n_splats,
                                    cfg, walked=walked,
                                    window=(bases, width))
    launches["l2_window"] += 1
    return color, grads16


def l2_render_and_grads_window(
    binning: tl.TileBinning,
    table: torch.Tensor,
    ref_chw: torch.Tensor,
    n_splats: int,
    cfg: SplatConfig,
) -> Tuple[torch.Tensor, GaussianParams, torch.Tensor]:
    """Windowed fused L2 step (kernel 12): the contract of
    render_resident.l2_render_and_grads_resident plus the trailing
    escaped-pair count (0 under a well-tuned cfg.window_width)."""
    if cfg.window_width is None:
        raise ValueError("cfg.window_width unset; call tune_window")
    width = cfg.window_width
    ids_s = rr._remap_ids(binning, n_splats)
    bases, escaped = window_bases(binning, n_splats, width)
    fn = _l2_window_cuda if on_card(table) else _l2_window_plain
    color, grads16 = fn(table, ids_s, binning.count, bases, ref_chw, n_splats,
                        cfg, width)
    grads = rd.moments_to_grads(rd.unpack_moments(grads16, n_splats),
                                rr._table_fields(table, n_splats))
    color = color[0].permute(1, 2, 0)[: cfg.height, : cfg.width]
    return color, grads, escaped


def l2_step_window(params: GaussianParams, ref_chw: torch.Tensor,
                   cfg: SplatConfig, max_per_tile: int):
    """One window-layout L2 evaluation: ids-only binning + kernel 12.
    Returns (color (H, W, 3), grads, n_dropped), n_dropped folding in the
    escaped pairs (a static capacity lost work either way: re-tune)."""
    binning = tl.bin_splats(params, cfg, max_per_tile, ids_only=True)
    table = rr.resident_table(params, cfg)
    color, grads, escaped = l2_render_and_grads_window(
        binning, table, ref_chw, params.n, cfg)
    return color, grads, binning.n_dropped + escaped
