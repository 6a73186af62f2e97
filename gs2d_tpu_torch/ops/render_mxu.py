"""The fused L2 step in the "MXU form" (the counterpart of
``gs2d_tpu/ops/render_pallas_mxu.py``, gs2d_tpu's experimental alternative
to the dense fused kernel).

Alpha comes from each splat's squared distance written as a degree-2
polynomial in tile-centred pixel coordinates, D2 = Coef (K, 6) . Basis
(6, P) with Basis = [x'^2, x'y', y'^2, x', y', 1]; the backward's pixel
reductions are moments of q = dL/dalpha * alpha against the same basis,
combined per splat into the gradients inside the kernel. Coverage is the
exact trunc interval of the direct form, so the masks are kernel 4's; D2
itself is not bit-equal to the direct form's, and gs2d_tpu holds the MXU
step at colour atol 5e-5 and gradients 2e-3 * max(1, |g|) against the scan
path.

``l2_render_and_grads_mxu`` launches kernel 13 (``csrc/render_mxu.cu``: the
warp patches of the other L2 kernels, one 10-sum partial per (tile, slot,
pass, warp), then a patch sum and combine) for CUDA tensors, adding one to
``launches["l2_mxu"]``, and runs the plain twin ``_l2_mxu_plain`` for CPU
tensors. ``_l2_mxu_chunk_cuda`` launches the one-block-per-tile chunk walk
kernel 13 had before its warp patches, kept unchanged as its reference for
``chip_smoke.py`` and the card tests (``launches["l2_mxu_chunk"]``; no path
reaches it); the two are equal bit for bit. The plain twin evaluates D2's terms
and the combine in the kernel's float32 order (D2 grouped as ((c_xx x'^2 +
c_x x') + c_0) + ((c_yy y'^2 + c_y y') + c_xy x'y'), which cancels with the
least rounding of the groupings tried); its pixel sums are taken in another
order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_dense as rdn
from gs2d_tpu_torch.ops import render_resident as rr
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.ops._build import check, library, on_card, stream
from gs2d_tpu_torch.ops.numerics import exp_ref, trunc_to_int
from gs2d_tpu_torch.params import GaussianParams
from gs2d_tpu_torch.utils.hardware import resolve_budget

# Kernel launch counts since the last reset_launch_counts().
launches = {"l2_mxu": 0, "l2_mxu_chunk": 0}

# Per-slot pixel sums: the six moments of q, the three sums of w * gC and
# sum q / op; and the D2 coefficients the chunk reference stages.
N_SUMS = 10
N_COEFS = 6


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU path; the card-side reference in chip_smoke).
# ---------------------------------------------------------------------------

def _tile_centres(cfg: SplatConfig, device):
    """(cx, cy) of every tile, (n_tiles, 1, 1) each, and the tile-centred
    coordinates x' (1, 1, tile_w) and y' (1, tile_h, 1)."""
    t = torch.arange(cfg.n_tiles_y * cfg.n_tiles_x, device=device)
    ty = torch.div(t, cfg.n_tiles_x, rounding_mode="floor")
    tx = t - ty * cfg.n_tiles_x
    cx = (tx * cfg.tile_w).to(torch.float32) + cfg.tile_w / 2.0
    cy = (ty * cfg.tile_h).to(torch.float32) + cfg.tile_h / 2.0
    xp = (torch.arange(cfg.tile_w, device=device).to(torch.float32) + 0.5) \
        - cfg.tile_w / 2.0
    yp = (torch.arange(cfg.tile_h, device=device).to(torch.float32) + 0.5) \
        - cfg.tile_h / 2.0
    return (cx[:, None, None], cy[:, None, None], xp[None, None, :],
            yp[None, :, None])


def _coefs(r, cx, cy):
    """The six D2 coefficients of each tile's slot row ``r`` (n_tiles,
    N_FIELDS) in the tile's centred coordinates, each (n_tiles, 1, 1)."""
    f = lambda i: r[:, i, None, None]
    a, b, d = f(tl.FIELD_A), f(tl.FIELD_B), f(tl.FIELD_D)
    ex = f(tl.FIELD_PX) - cx
    ey = f(tl.FIELD_PY) - cy
    return (a, 2.0 * b, d, -2.0 * (a * ex + b * ey),
            -2.0 * (d * ey + b * ex),
            a * ex * ex + 2.0 * b * ex * ey + d * ey * ey)


def _cover(r, coords, cfg: SplatConfig):
    """Coverage of each tile's slot row ``r`` over its pixels (n_tiles,
    tile_h, tile_w): the exact trunc row and column interval of the direct
    form, inside the image (kernel 4's masks; the warp-patch cull of
    kernel 13 decides on the same bits)."""
    yy, xx, fy, _, _ = coords
    f = lambda i: r[:, i, None, None]
    px, py, a, b, d = (f(tl.FIELD_PX), f(tl.FIELD_PY), f(tl.FIELD_A),
                       f(tl.FIELD_B), f(tl.FIELD_D))
    h = f(tl.FIELD_H)
    row_ok = (yy >= trunc_to_int(py - h)) & (yy <= trunc_to_int(py + h))
    vy = fy - py
    qb = 2.0 * b * vy
    qc = d * vy * vy - cfg.cutoff_sq
    disc = qb * qb - 4.0 * a * qc
    q_ok = disc >= 0.0
    sq = torch.sqrt(torch.maximum(disc, torch.zeros_like(disc)))
    sgn = torch.where(qb < 0.0, -1.0, 1.0)
    kq = (-qb - sgn * sq) * 0.5
    r0 = kq / a
    r1 = qc / kq
    beg_x = trunc_to_int(px + torch.minimum(r0, r1))
    end_x = trunc_to_int(px + torch.maximum(r0, r1))
    return row_ok & q_ok & (xx >= beg_x) & (xx <= end_x) \
        & (yy < cfg.height) & (xx < cfg.width)


def _alpha(r, coef, basis, coords, cfg: SplatConfig):
    """Coverage-masked alpha of each tile's slot row ``r`` over its pixels
    (n_tiles, tile_h, tile_w), D2 from the coefficient form."""
    cover = _cover(r, coords, cfg)
    f = lambda i: r[:, i, None, None]
    bxx, bxy, byy, xp, yp = basis
    c_xx, c_xy, c_yy, c_x, c_y, c_0 = coef
    d2 = ((c_xx * bxx + c_x * xp) + c_0) + ((c_yy * byy + c_y * yp)
                                           + c_xy * bxy)
    g = exp_ref(-0.5 * d2, cfg.use_exp_approx)
    return torch.where(cover, g * f(tl.FIELD_OP), torch.zeros_like(g))


def _combine(rows, mom, cx, cy):
    """The nine gradient fields (..., 9) in G_* order from the per-slot sums
    ``mom`` (..., 10) and packed rows (..., N_FIELDS); cx, cy broadcast."""
    f = lambda i: rows[..., i]
    m = lambda i: mom[..., i]
    a, b, d = f(tl.FIELD_A), f(tl.FIELD_B), f(tl.FIELD_D)
    sx, sy = f(tl.FIELD_SX), f(tl.FIELD_SY)
    cs, sn = f(tl.FIELD_COS), f(tl.FIELD_SIN)
    ex = f(tl.FIELD_PX) - cx
    ey = f(tl.FIELD_PY) - cy
    m_xx, m_xy, m_yy, m_x, m_y, m_1 = (m(i) for i in range(6))
    s_x = m_x - ex * m_1
    s_y = m_y - ey * m_1
    s_xx = m_xx - 2.0 * ex * m_x + ex * ex * m_1
    s_yy = m_yy - 2.0 * ey * m_y + ey * ey * m_1
    s_xy = m_xy - ex * m_y - ey * m_x + ex * ey * m_1
    inv_sx3 = 1.0 / (sx * sx * sx)
    inv_sy3 = 1.0 / (sy * sy * sy)
    rot_k = (sx * sx - sy * sy) / (sx * sx * sy * sy)
    return torch.stack([
        a * s_x + b * s_y,
        d * s_y + b * s_x,
        inv_sx3 * (cs * cs * s_xx + 2.0 * sn * cs * s_xy + sn * sn * s_yy),
        inv_sy3 * (sn * sn * s_xx - 2.0 * sn * cs * s_xy + cs * cs * s_yy),
        rot_k * ((cs * cs - sn * sn) * s_xy - sn * cs * (s_xx - s_yy)),
        m(6), m(7), m(8), m(9)], dim=-1)


def _l2_mxu_plain(tile_params, ids, count, ref_chw, n_splats: int,
                  cfg: SplatConfig, kc: int):
    """Plain twin of kernel 13 and the segment sum: (color (3, Hp, Wp),
    per-(tile, slot) gradient rows (n_tiles, K, 9), splat gradients
    (9, n)). Every tile walks its list in lockstep; a chunk whose tile has
    no pixel left at T >= min_throughput contributes exactly zero, so no
    chunk is skipped here."""
    del kc  # the chunking only bounds the chunk reference's shared memory
    dev = tile_params.device
    coords = rd.tile_coords(cfg, dev)
    cx, cy, xp, yp = _tile_centres(cfg, dev)
    basis = (xp * xp, xp * yp, yp * yp, xp, yp)
    n_tiles, k_cap, _ = tile_params.shape
    n_steps = int(count.max()) if count.numel() else 0
    mt = cfg.min_throughput
    shape = (n_tiles, cfg.tile_h, cfg.tile_w)
    zero = torch.zeros(shape, dtype=torch.float32, device=dev)

    def alpha_of(k):
        r = tile_params[:, k]
        return r, _alpha(r, _coefs(r, cx, cy), basis, coords, cfg)

    # ---- phase 0: forward composite from T = 1 on every pixel ---------------
    fin = [zero, zero, zero]
    T = torch.ones(shape, dtype=torch.float32, device=dev)
    for k in range(n_steps):
        r, al = alpha_of(k)
        live = T >= mt
        w = torch.where(live, T * al, zero)
        for ch in range(3):
            fin[ch] = fin[ch] + w * r[:, tl.FIELD_CR + ch, None, None]
        T = torch.where(live, T * (1.0 - al), T)
    ref_t = rd.to_tiles(ref_chw[0], cfg)
    gc = [fin[ch] - ref_t[ch] for ch in range(3)]

    # ---- phase 1: replay from (0, 1), per-slot sums ------------------------
    mom = torch.zeros((n_tiles, k_cap, N_SUMS), dtype=torch.float32,
                      device=dev)
    comp = [zero, zero, zero]
    T = torch.ones(shape, dtype=torch.float32, device=dev)
    for k in range(n_steps):
        r, al = alpha_of(k)
        live = T >= mt
        mw = live.to(torch.float32)
        w = torch.where(live, T * al, zero)
        w_c = (al * T) * mw
        col = [r[:, tl.FIELD_CR + ch, None, None] for ch in range(3)]
        comp = [comp[ch] + w * col[ch] for ch in range(3)]
        inv1ma = 1.0 / torch.where(al >= 1.0, torch.full_like(al, 1e-15),
                                   1.0 - al)
        dl_da = (gc[0] * (col[0] * T - (fin[0] - comp[0]) * inv1ma)
                 + gc[1] * (col[1] * T - (fin[1] - comp[1]) * inv1ma)
                 + gc[2] * (col[2] * T - (fin[2] - comp[2]) * inv1ma)) * mw
        q = dl_da * al
        T = torch.where(live, T * (1.0 - al), T)
        opd = torch.maximum(r[:, tl.FIELD_OP, None, None],
                            torch.full_like(r[:, :1, None], 1e-30))
        # Column sums over the tile's rows, then the x' monomials per
        # column, then the sum over columns (the kernel's order of stages).
        s0 = q.sum(dim=1)
        s1 = (q * yp).sum(dim=1)
        s2 = (q * basis[2]).sum(dim=1)
        cols = torch.stack([
            s0 * basis[0][:, 0], s1 * xp[:, 0], s2, s0 * xp[:, 0], s1, s0,
            (w_c * gc[0]).sum(dim=1), (w_c * gc[1]).sum(dim=1),
            (w_c * gc[2]).sum(dim=1), (q / opd).sum(dim=1)], dim=1)
        mom[:, k] = cols.sum(dim=2)
    rows = _combine(tile_params, mom, cx[:, :, 0], cy[:, :, 0])
    slot = torch.arange(k_cap, device=dev)
    rows = torch.where((slot[None] < count[:, None])[..., None], rows,
                       torch.zeros_like(rows))
    color = rd.from_tiles(torch.stack(fin), cfg)
    return color, rows, rdn._segment9(ids, count, rows, n_splats)


# ---------------------------------------------------------------------------
# CUDA launch.
# ---------------------------------------------------------------------------

def _l2_mxu_cuda(tile_params, ids, count, ref_chw, n_splats: int,
                 cfg: SplatConfig, kc: int, partial=None, walked=None):
    """Kernel 13 on warp patches, its patch sum and combine, and the
    segment sum: (color (3, Hp, Wp), per-(tile, slot) gradient rows
    (n_tiles, K, 9), splat gradients (9, n)). ``partial`` replaces the
    uninitialised (n_tiles, K, patches per tile, 10) scratch (a test's
    NaN-filled buffer); ``walked`` gets each patch's survivors and the
    survivors its forward walked (render_resident._walked_ptr)."""
    del kc  # nothing is staged in shared memory
    ref = ref_chw[0]
    lib, k, _ = rdn._check_inputs(cfg, tile_params, count, ids,
                                  (("ref_chw", ref),))
    dev = tile_params.device
    partial = rr.patch_scratch(partial, cfg, k, dev, N_SUMS)
    color = torch.empty_like(ref)
    rows = torch.empty((ids.shape[0], k, rd.N_MOMENTS), dtype=torch.float32,
                       device=dev)
    grads9 = torch.empty((rd.N_MOMENTS, n_splats), dtype=torch.float32,
                         device=dev)
    err = lib.gs2d_l2_mxu(
        tile_params.data_ptr(), ids.data_ptr(), count.data_ptr(),
        ref.data_ptr(), color.data_ptr(), partial.data_ptr(), rows.data_ptr(),
        grads9.data_ptr(), rr._walked_ptr(walked, cfg, dev), n_splats,
        *rdn._patch_statics(cfg, k), stream(tile_params))
    check(err, "l2_mxu kernel launch")
    launches["l2_mxu"] += 1
    return color, rows, grads9


def _l2_mxu_chunk_cuda(tile_params, ids, count, ref_chw, n_splats: int,
                       cfg: SplatConfig, kc: int):
    """The reference (gs2d_l2_mxu_chunk, kernel 13's chunk walk before its
    warp patches) and the segment sum: what _l2_mxu_cuda returns. For
    chip_smoke.py and the card tests only."""
    ref = ref_chw[0]
    _, k, _ = rdn._check_inputs(cfg, tile_params, count, ids,
                                (("ref_chw", ref),))
    lib = library()
    rows_pt, max_threads = lib.gs2d_rows_per_thread(), lib.gs2d_max_threads()
    threads = cfg.tile_w * min(cfg.tile_h,
                               max_threads * rows_pt // cfg.tile_w) // rows_pt
    # Staged rows and coefficients of a chunk, and the warps' reduction
    # rounds of 32 slots.
    need = 4 * (kc * (tl.N_FIELDS + N_COEFS) + threads // 32 * 32 * N_SUMS)
    limit = resolve_budget("smem_per_block", lib.gs2d_max_smem_per_block())
    if need > limit:
        raise ValueError(f"chunk {kc} needs {need} B of shared memory per "
                         f"block, more than the card's {limit} B")
    dev = tile_params.device
    color = torch.empty_like(ref)
    mom = torch.zeros((ids.shape[0], k, N_SUMS), dtype=torch.float32,
                      device=dev)
    rows = torch.empty((ids.shape[0], k, rd.N_MOMENTS), dtype=torch.float32,
                       device=dev)
    grads9 = torch.empty((rd.N_MOMENTS, n_splats), dtype=torch.float32,
                         device=dev)
    err = lib.gs2d_l2_mxu_chunk(
        tile_params.data_ptr(), ids.data_ptr(), count.data_ptr(),
        ref.data_ptr(), color.data_ptr(), mom.data_ptr(), rows.data_ptr(),
        grads9.data_ptr(), n_splats, cfg.height, cfg.width, cfg.tile_h,
        cfg.tile_w, cfg.n_tiles_x, cfg.n_tiles_y, k, kc, cfg.cutoff_sq,
        cfg.min_throughput, int(cfg.use_exp_approx), stream(tile_params))
    check(err, "l2_mxu_chunk kernel launch")
    launches["l2_mxu_chunk"] += 1
    return color, rows, grads9


def l2_render_and_grads_mxu(
    binning: tl.TileBinning,
    ref_chw: torch.Tensor,
    n_splats: int,
    cfg: SplatConfig,
    chunk: int = 256,
) -> Tuple[torch.Tensor, GaussianParams]:
    """MXU-form fused L2 step on a dense binning (kernel 13); the contract
    of render_dense.l2_render_and_grads: (color (H, W, 3), parameter
    gradients). ``ref_chw`` is the padded (1, 3, Hp, Wp) target."""
    tp = rdn._tile_params(binning)
    k = binning.ids.shape[1]
    kc = min(chunk, k)
    if k % kc:
        raise ValueError(f"per-tile capacity {k} must divide by chunk {kc}")
    fn = _l2_mxu_cuda if on_card(tp) else _l2_mxu_plain
    color, _, g = fn(tp, binning.ids, binning.count, ref_chw, n_splats, cfg,
                     kc)
    grads = GaussianParams(
        pos=torch.stack([g[rd.G_PX], g[rd.G_PY]], dim=-1),
        sx=g[rd.G_SX], sy=g[rd.G_SY], rot=g[rd.G_ROT],
        color=torch.stack([g[rd.G_CR], g[rd.G_CG], g[rd.G_CB]], dim=-1),
        opacity=g[rd.G_OP])
    return color.permute(1, 2, 0)[: cfg.height, : cfg.width], grads
