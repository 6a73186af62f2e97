"""Rasterizer pieces outside the kernels (the counterpart of the non-kernel
parts of ``gs2d_tpu/ops/render_pallas.py``), and the plain PyTorch twin of
the device code the CUDA kernels share (``csrc/splat_terms.cuh``).

Every kernel wrapper takes ``band_row0`` / ``band_rows``, gs2d_tpu's band of
tile rows (the unit of tile-axis sharding, ``parallel/sharded.py``): the
binning's tile ids are band-local, the planes hold the band's
``band_rows * tile_h`` rows, and the splat geometry and the in-image test
take image rows, offset by ``band_row0 * tile_h`` (the TPU kernels'
scalar-prefetched ``off``, the CUDA kernels' ``row_off``). ``band_rows``
None is the whole image.

The twin evaluates one splat-step for every tile at once: per-pixel planes
are (n_tiles, tile_h, tile_w) tensors and each tile's slot-k splat scalars a
(n_tiles, N_FIELDS) row block broadcast over the tile's pixels. Its float32
operation order follows ``render_pallas._splat_terms`` / ``_fwd_one`` /
``_bwd_splat_step`` / ``_moment_reduce`` (the reference semantics of
main.cpp:418-712): exact trunc row/column bounds, the per-row ellipse
quadratic, the fast exp and the per-pixel T >= 1/256 early-out.

Gradient rows of the kernels' (16, n) output (raw z-moments, combined by
``moments_to_grads``): 0 gpx, 1 gpy, 2 gsx, 3 gsy, 4 grot, 5 gcr, 6 gcg,
7 gcb, 8 gop.
"""

from __future__ import annotations

import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.ops.numerics import exp_ref, trunc_to_int
from gs2d_tpu_torch.params import GaussianParams
from gs2d_tpu_torch.utils.hardware import warn_if_untuned

G_PX, G_PY, G_SX, G_SY, G_ROT, G_CR, G_CG, G_CB, G_OP = range(9)
N_MOMENTS = 9       # moment rows G_PX..G_OP
N_GRAD_FIELDS = 16  # 9 used; padded to 16 rows like the JAX kernels

# The JAX package's "auto" layout policy (render_pallas_flat.py:57-99),
# copied so both packages resolve a cfg alike. The byte budget is the TPU's
# SMEM figure and says nothing about the card; choosing layouts for Hopper
# is a later, measured change.
RESIDENT_THRESHOLD = 4096
FLAT_THRESHOLD = 2048
_JAX_RESIDENT_BUDGET = 800 * 1024


def resolve_binning(cfg: SplatConfig) -> str:
    """The layout gs2d_tpu.ops.render_pallas_flat.resolve_binning picks for
    ``cfg``: "resident", "flat", "dense" or, asked for by name, "window"."""
    if cfg.binning not in ("auto", "dense", "flat", "resident", "window"):
        raise ValueError(f"unknown binning {cfg.binning!r}")
    if cfg.binning != "auto":
        return cfg.binning
    warn_if_untuned()  # thresholds and byte budget come from v5e sweeps
    k = -(-_max_per_tile(cfg) // 128) * 128
    smem = (4 * tl.N_FIELDS * (cfg.n_splats + 1)
            + 4 * cfg.n_tiles_x * cfg.n_tiles_y * k)
    fits = smem <= _JAX_RESIDENT_BUDGET
    if cfg.n_splats <= RESIDENT_THRESHOLD and fits:
        return "resident"
    if cfg.n_splats >= FLAT_THRESHOLD:
        return "flat"
    return "dense"


def _max_per_tile(cfg: SplatConfig) -> int:
    if cfg.max_splats_per_tile is not None:
        return cfg.max_splats_per_tile
    return min(max(256, cfg.n_splats // 4), 4096)


def moments_to_grads(m: GaussianParams,
                     fields: torch.Tensor) -> GaussianParams:
    """Per-splat scalar combinations turning the kernels' raw z-moments into
    parameter gradients (main.cpp:635-704, Form.pdf sections 8-11); see
    gs2d_tpu.ops.render_pallas.moments_to_grads for the derivation.

    ``m`` carries the reduced moments (pos=(M1, M2), sx=M3, sy=M4, rot=M5,
    opacity=M0, color final); ``fields`` is the (N_FIELDS, n) packed table
    the kernel consumed; the combinations run in the moments' dtype."""
    fields = fields.to(m.opacity.dtype)
    a, b, d = fields[tl.FIELD_A], fields[tl.FIELD_B], fields[tl.FIELD_D]
    c, s = fields[tl.FIELD_COS], fields[tl.FIELD_SIN]
    sx, sy, op = fields[tl.FIELD_SX], fields[tl.FIELD_SY], fields[tl.FIELD_OP]
    m1, m2 = m.pos[:, 0], m.pos[:, 1]
    m3, m4, m5, m0 = m.sx, m.sy, m.rot, m.opacity
    cc, ss, cs = c * c, s * s, c * s
    inv_sx3 = 1.0 / (sx * sx * sx)
    inv_sy3 = 1.0 / (sy * sy * sy)
    th_s = -(sx * sx - sy * sy) / (sx * sx * sy * sy)
    pos_ok = op > 0.0
    return GaussianParams(
        pos=torch.stack([a * m1 + b * m2, d * m2 + b * m1], dim=-1),
        sx=inv_sx3 * (cc * m3 + 2.0 * (cs * m4) + ss * m5),
        sy=inv_sy3 * (ss * m3 - 2.0 * (cs * m4) + cc * m5),
        rot=th_s * (cs * (m3 - m5) + (ss - cc) * m4),
        color=m.color,
        # Dead slots (op == 0) have exactly zero moments: guard the 0/0.
        opacity=torch.where(
            pos_ok, m0 / torch.where(pos_ok, op, torch.ones_like(op)),
            torch.zeros_like(op)),
    )


def unpack_moments(rows: torch.Tensor, n_splats: int) -> GaussianParams:
    """Moment rows G_PX..G_OP ((16, n_pad) or (9, n)) -> GaussianParams-
    shaped carrier of raw z-moments (see moments_to_grads)."""
    g = rows[:, :n_splats]
    return GaussianParams(
        pos=torch.stack([g[G_PX], g[G_PY]], dim=-1),
        sx=g[G_SX], sy=g[G_SY], rot=g[G_ROT],
        color=torch.stack([g[G_CR], g[G_CG], g[G_CB]], dim=-1),
        opacity=g[G_OP],
    )


def band_grid(cfg: SplatConfig, band_row0: int = 0,
              band_rows=None) -> tuple:
    """(tile rows, first image row in pixels) of a launch over the band of
    ``band_rows`` tile rows from tile row ``band_row0``; the whole grid and
    0 when ``band_rows`` is None."""
    if band_rows is None:
        return cfg.n_tiles_y, 0
    return int(band_rows), int(band_row0) * cfg.tile_h


def identity_trans(cfg: SplatConfig, hp: int, wp: int, device=None,
                   row0_px: int = 0) -> torch.Tensor:
    """Identity transmittance plane (hp, wp) of the rows from image row
    ``row0_px``: 1 inside the image, 0 on padding. Out-of-image pixels
    never composite, so zero is exact there, and it lets the saturation
    exits below ignore padding."""
    yy = row0_px + torch.arange(hp, device=device)[:, None]
    xx = torch.arange(wp, device=device)[None, :]
    return ((yy < cfg.height) & (xx < cfg.width)).to(torch.float32)


# Splat-steps between saturation checks, and the population size from which
# the flat kernels check inside a chunk as well as at chunk starts
# (gs2d_tpu/ops/render_pallas.py:145-160; the threshold was measured on a
# TPU and is kept so both packages walk alike).
SAT_CHECK_EVERY = 32
SAT_WALK_THRESHOLD = 8192


def _sat_walk(cfg: SplatConfig) -> bool:
    if cfg.n_splats >= SAT_WALK_THRESHOLD:
        warn_if_untuned()  # the gate comes from a v5e sweep
        return True
    return False


def saturating_loop(n_steps: int, step, carry, get_t, mt: float,
                    check_every: int):
    """``carry = step(k, carry)`` for k < n_steps, stopping at a check point
    (every ``check_every`` steps) where no element of ``get_t(carry)`` is
    >= ``mt``: every pixel then fails the per-pixel early-out, so every
    later step contributes exactly zero and stopping is bitwise-exact (the
    semantics of gs2d_tpu's ``_saturating_loop``). Each check reads one
    flag back from the device."""
    for k in range(n_steps):
        if k % check_every == 0 and not bool((get_t(carry) >= mt).any()):
            break
        carry = step(k, carry)
    return carry


def pad_ref_chw(ref, cfg: SplatConfig, device=None) -> torch.Tensor:
    """Zero-pad an (H, W, 3) target to the (1, 3, Hp, Wp) kernel layout."""
    ref = torch.as_tensor(ref, dtype=torch.float32, device=device)
    out = torch.zeros((1, 3, cfg.padded_height, cfg.padded_width),
                      dtype=torch.float32, device=ref.device)
    out[0, :, : cfg.height, : cfg.width] = ref.permute(2, 0, 1)
    return out


def identity_carry(cfg: SplatConfig, device, band_row0: int = 0,
                   band_rows=None):
    """The empty prefix entering a population: C_in (3, Hp, Wp) zeros and
    the identity T_in (Hp, Wp), or the band's rows of them."""
    gy, row0_px = band_grid(cfg, band_row0, band_rows)
    hp, wp = gy * cfg.tile_h, cfg.padded_width
    return (torch.zeros((3, hp, wp), dtype=torch.float32, device=device),
            identity_trans(cfg, hp, wp, device, row0_px))


def carry_planes(final_color, g_color, carry_in, cfg: SplatConfig,
                 band_row0: int = 0, band_rows=None):
    """The backward kernels' input planes from (H, W, 3) images, zero-padded
    as gs2d_tpu's backward_tiled / backward_resident pad them: (fin, gc,
    cin) (3, Hp, Wp) and tin (Hp, Wp). ``carry_in`` is the (C (H, W, 3),
    T (H, W)) prefix entering the population; identity when None. Under a
    band the images are the band's, already padded ((band_rows * tile_h,
    Wp, 3) and (band_rows * tile_h, Wp)), as gs2d_tpu takes them."""
    if band_rows is not None:
        chw = lambda img: img.permute(2, 0, 1).contiguous()
        if carry_in is None:
            cin, tin = identity_carry(cfg, final_color.device, band_row0,
                                      band_rows)
        else:
            cin, tin = chw(carry_in[0]), carry_in[1].contiguous()
        return chw(final_color), chw(g_color), cin, tin
    fin = pad_ref_chw(final_color, cfg)[0]
    gc = pad_ref_chw(g_color, cfg)[0]
    if carry_in is None:
        return (fin, gc, *identity_carry(cfg, fin.device))
    tin = torch.zeros((cfg.padded_height, cfg.padded_width),
                      dtype=torch.float32, device=fin.device)
    tin[: cfg.height, : cfg.width] = carry_in[1]
    return fin, gc, pad_ref_chw(carry_in[0], cfg)[0], tin


def cotangent_tiles(fin, gc, cin, cfg: SplatConfig):
    """The backward replay's per-pixel inputs from (3, Hp, Wp) planes, in
    tiles: (gc_rgb, gf = sum_ch gC * C_final, ga = sum_ch gC * C_in), in
    the float32 order of the CUDA kernels' load_cotangent."""
    fin_t, gc_t, cin_t = (to_tiles(x, cfg) for x in (fin, gc, cin))
    gf = gc_t[0] * fin_t[0] + gc_t[1] * fin_t[1] + gc_t[2] * fin_t[2]
    ga = gc_t[0] * cin_t[0] + gc_t[1] * cin_t[1] + gc_t[2] * cin_t[2]
    return (gc_t[0], gc_t[1], gc_t[2]), gf, ga


def segment_sum_plain(ids, start, count, moments, n_splats: int):
    """(9, n) splat-axis sums of (M, 9) per-pair moment rows, tile t's run
    being rows [start[t], start[t] + count[t]) with splat ids ``ids``: each
    splat's rows added in tile order, as the CUDA segment sums add them.
    Ids within a run are unique, so each tile's add is a plain indexed
    update; -1 ids would land on the dropped row n."""
    acc = torch.zeros((n_splats + 1, N_MOMENTS),
                      dtype=moments.dtype, device=moments.device)
    for s, c in zip(start.tolist(), count.tolist()):
        if c:
            run = ids[s: s + c].long()
            run = torch.where(run >= 0, run, n_splats)
            acc[run] = acc[run] + moments[s: s + c]
    return acc[:n_splats].T.contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch twin of the shared device code (csrc/splat_terms.cuh).
# ---------------------------------------------------------------------------

def tile_coords(cfg: SplatConfig, device, band_row0: int = 0,
                band_rows=None):
    """Integer pixel coords (image rows), centres and the in-image mask of
    every tile of the grid, or of the band: (yy, xx, fy, fx, inside), each
    (n_tiles, tile_h, tile_w), tiles in row-major grid order."""
    th, tw = cfg.tile_h, cfg.tile_w
    gy, row0_px = band_grid(cfg, band_row0, band_rows)
    t = torch.arange(gy * cfg.n_tiles_x, device=device)
    ty = torch.div(t, cfg.n_tiles_x, rounding_mode="floor")
    tx = t - ty * cfg.n_tiles_x
    ty = ty + row0_px // th
    r = torch.arange(th, device=device)
    c = torch.arange(tw, device=device)
    yy = (ty[:, None, None] * th + r[None, :, None]).expand(-1, th, tw)
    xx = (tx[:, None, None] * tw + c[None, None, :]).expand(-1, th, tw)
    yy = yy.to(torch.int32).contiguous()
    xx = xx.to(torch.int32).contiguous()
    inside = (yy < cfg.height) & (xx < cfg.width)
    return yy, xx, yy.to(torch.float32) + 0.5, xx.to(torch.float32) + 0.5, \
        inside


def to_tiles(img_chw: torch.Tensor, cfg: SplatConfig) -> torch.Tensor:
    """(C, Hp, Wp) -> (C, n_tiles, tile_h, tile_w); a band's (C, rows, Wp)
    alike."""
    ch, hp = img_chw.shape[:2]
    gy = hp // cfg.tile_h
    x = img_chw.reshape(ch, gy, cfg.tile_h, cfg.n_tiles_x, cfg.tile_w)
    return x.permute(0, 1, 3, 2, 4).reshape(
        ch, gy * cfg.n_tiles_x, cfg.tile_h, cfg.tile_w)


def from_tiles(tiles: torch.Tensor, cfg: SplatConfig) -> torch.Tensor:
    """(C, n_tiles, tile_h, tile_w) -> (C, Hp, Wp); a band's tiles to its
    (C, rows, Wp) alike."""
    ch = tiles.shape[0]
    gy = tiles.shape[1] // cfg.n_tiles_x
    x = tiles.reshape(ch, gy, cfg.n_tiles_x, cfg.tile_h, cfg.tile_w)
    return x.permute(0, 1, 3, 2, 4).reshape(
        ch, gy * cfg.tile_h, cfg.padded_width)


def _row_interval(px, a, b, d, vy, cfg: SplatConfig):
    """Exact per-row x interval from the ellipse quadratic (main.cpp:497-509)
    at vy = (row centre) - py: (q_ok, the row meets the ellipse; beg_x,
    end_x, the int32 columns it covers there). The twin of
    csrc/splat_terms.cuh's row_interval, which the kernels' coverage and the
    resident kernels' per-warp cull share."""
    qb = 2.0 * b * vy
    qc = d * vy * vy - cfg.cutoff_sq
    disc = qb * qb - 4.0 * a * qc
    sq = torch.sqrt(torch.maximum(disc, torch.zeros_like(disc)))
    sgn = torch.where(qb < 0.0, -1.0, 1.0)
    kq = (-qb - sgn * sq) * 0.5
    r0 = kq / a
    r1 = qc / kq
    # torch.minimum/maximum propagate NaN like jnp.minimum/maximum.
    return (disc >= 0.0, trunc_to_int(px + torch.minimum(r0, r1)),
            trunc_to_int(px + torch.maximum(r0, r1)))


def _splat_terms(rows, fx, fy, xx, yy, inside, T, cfg: SplatConfig):
    """Per-pixel coverage + alpha of one splat per tile.

    ``rows`` is (n_tiles, N_FIELDS): each tile's slot-k packed row. Returns
    (live, alpha, vx, vy, colors (cr, cg, cb) as (n_tiles, 1, 1))."""
    f = lambda i: rows[:, i, None, None]
    px, py = f(tl.FIELD_PX), f(tl.FIELD_PY)
    a, b, d = f(tl.FIELD_A), f(tl.FIELD_B), f(tl.FIELD_D)
    h = f(tl.FIELD_H)
    op = f(tl.FIELD_OP)

    vy = fy - py
    vx = fx - px

    # Row walk bounds: y in [trunc(py-h), trunc(py+h)] (main.cpp:490-492).
    # Coverage is decided on the float32 rows, as the kernels decide it,
    # also where rows in float64 carry the rest of the arithmetic (the
    # float64 reference in chip_smoke.py).
    px32, py32, h32 = px.float(), py.float(), h.float()
    row_ok = (yy >= trunc_to_int(py32 - h32)) & (yy <= trunc_to_int(py32
                                                                    + h32))
    q_ok, beg_x, end_x = _row_interval(px32, a.float(), b.float(), d.float(),
                                       fy - py32, cfg)
    col_ok = (xx >= beg_x) & (xx <= end_x)

    cover = row_ok & q_ok & col_ok & inside
    d2 = a * vx * vx + 2.0 * b * vx * vy + d * vy * vy
    alpha = exp_ref(-0.5 * d2, cfg.use_exp_approx) * op
    live = cover & (T >= cfg.min_throughput)
    return live, alpha, vx, vy, (f(tl.FIELD_CR), f(tl.FIELD_CG),
                                 f(tl.FIELD_CB))


def _fwd_one(rows, fx, fy, xx, yy, inside, cfg: SplatConfig, carry):
    """One front-to-back composite step (carry = (cr, cg, cb, T))."""
    cr_acc, cg_acc, cb_acc, T = carry
    live, alpha, _, _, (cr, cg, cb) = _splat_terms(
        rows, fx, fy, xx, yy, inside, T, cfg)
    zero = torch.zeros_like(T)
    w = torch.where(live, T * alpha, zero)
    return (cr_acc + w * cr, cg_acc + w * cg, cb_acc + w * cb,
            torch.where(live, T * (1.0 - alpha), T))


def _moment_reduce(z, vx_row, vy, w_c, gc_rgb):
    """Separable two-stage reduction of the nine per-splat tile sums ->
    (n_tiles, 9), rows [M1, M2, M3, M4, M5, CR, CG, CB, M0]: column sums
    over the tile's rows first (z, z*vy, z*vy^2 and the colour sums), then
    the x monomials of the lane vector vx, then the sum over columns."""
    gc_r, gc_g, gc_b = gc_rgb
    zvy = z * vy
    r0 = z.sum(dim=1)
    r1 = zvy.sum(dim=1)
    r2 = (zvy * vy).sum(dim=1)
    cr = (gc_r * w_c).sum(dim=1)
    cg = (gc_g * w_c).sum(dim=1)
    cb = (gc_b * w_c).sum(dim=1)
    r0x = r0 * vx_row
    stacked = torch.stack(
        [r0x, r1, r0x * vx_row, r1 * vx_row, r2, cr, cg, cb, r0], dim=1)
    return stacked.sum(dim=2)


def _bwd_splat_step(rows, fx, fy, xx, yy, inside, cfg: SplatConfig, carry,
                    gf, gc_rgb):
    """One splat's backward contribution per tile: the cotangent-weighted
    replay (carry = (ga, T), ga = sum_ch gc_ch * C_prefix_ch) and its nine
    moment sums; see gs2d_tpu.ops.render_pallas._bwd_splat_step."""
    ga, T = carry
    gc_r, gc_g, gc_b = gc_rgb
    live, alpha, vx, vy, (cr, cg, cb) = _splat_terms(
        rows, fx, fy, xx, yy, inside, T, cfg)
    mw = live.to(torch.float32)

    w_c = alpha * T * mw
    gcdot = gc_r * cr + gc_g * cg + gc_b * cb
    ga = ga + w_c * gcdot

    # (1 - alpha + 1e-15) guard in select form: never reassociated to 0.
    one_minus = torch.where(alpha >= 1.0, torch.full_like(alpha, 1e-15),
                            1.0 - alpha)
    inv1ma = 1.0 / one_minus
    dL_da = (T * gcdot - (gf - ga) * inv1ma) * mw
    z = dL_da * alpha

    col = _moment_reduce(z, vx[:, 0, :], vy, w_c, gc_rgb)
    T = torch.where(live, T * (1.0 - alpha), T)
    return (ga, T), col
