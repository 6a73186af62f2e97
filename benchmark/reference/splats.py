"""Plain PyTorch reference of one fitting step of 2D Gaussian splatting.

A frozen rewrite of the loop-faithful NumPy oracle (``oracle/oracle_numpy.py``,
which follows Ushio/2dGaussianSplatting main.cpp), vectorised so that it runs
at 1920x1080 with a million splats. It imports nothing of the program under
test and takes nothing that the program made: the splats, the target and the
step's settings are all it reads.

Semantics (main.cpp line numbers as in the oracle):

- Coverage (main.cpp:487-509): a splat covers the rows
  [trunc(py - h), trunc(py + h)], h = 3 sqrt(a det), and on each row the
  columns [trunc(px + min(r0, r1)), trunc(px + max(r0, r1))] of the
  Mahalanobis ellipse quadratic, computed in float32 in the reference's order.
- Composite (main.cpp:418-538): front to back in splat index order,
  alpha = fastexp(-d2 / 2) * opacity with fastexp(x) = (1 + x/8)^8 (flushed
  to zero below its threshold); a splat adds to a pixel only while the
  pixel's transmittance is at least 1/256.
- Gradients (main.cpp:548-712): of L = sum (C - ref)^2 / 2 through the
  composite, with the reference's hand-derived convention that the fast
  exponential's derivative is taken as its value (the derivative of exp).
  Autograd computes the rest, so the suffix colour is never formed by
  subtraction (no 1/(1 - alpha) guard is needed).
- Adam (main.cpp:714-750): external bias powers, m_hat / (sqrt(v_hat) +
  eps), opacity frozen unless optimised, then the clamps.
- MSE (main.cpp:796-807): on the 0-255 scale, accumulated in float64.

The image is cut into tiles (``tile_h`` x ``tile_w``); each tile composites
the splats whose bounding box reaches it, ``chunk`` splats at a time, and
stops once every pixel's transmittance is below the threshold (nothing after
that can add). ``dtype`` is the precision of the per-pixel arithmetic
(float32; the lower-precision control passes bfloat16). With
``count_work`` the composite also counts the live work that the work model
of ``benchmark/lib/workmodel.py`` prices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

FIELDS = ("pos", "sx", "sy", "rot", "color", "opacity")
EXP_FLUSH = 0.00001814586175896693021059036255


@dataclasses.dataclass(frozen=True)
class Settings:
    """What a step needs besides the splats and the target."""

    width: int
    height: int
    bounds: float = 3.0
    min_throughput: float = 1.0 / 256.0
    learning_rate: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1.0e-15
    scale_min: float = 1.0
    scale_max: float = 1024.0
    opacity_min: float = 0.1
    opacity_max: float = 1.0
    optimize_opacity: bool = False
    tile_h: int = 32
    tile_w: int = 128
    chunk: int = 128
    # (pixel, splat) entries a batch of tiles holds at once.
    batch_entries: int = 1 << 23
    dtype: torch.dtype = torch.float32


class _FastExp(torch.autograd.Function):
    """(1 + x/8)^8, flushed to zero below EXP_FLUSH; its derivative is
    taken as its value, as the reference's backward does."""

    @staticmethod
    def forward(ctx, x):
        y = 1.0 + x * 0.125
        flush = y < EXP_FLUSH
        y = y * y
        y = y * y
        y = y * y
        y = torch.where(flush, torch.zeros_like(y), y)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


def _trunc(x: torch.Tensor) -> torch.Tensor:
    """C's float -> int conversion (toward zero), NaN -> 0, saturating."""
    t = torch.nan_to_num(torch.trunc(x), nan=0.0)
    return t.clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int64)


def geometry(sx, sy, rot, bounds: float):
    """(a, b, d, h, hw): the inverse covariance [[a, b], [b, d]], the
    half-height of the row walk and the half-width of the ellipse, in the
    reference's float32 order (main.cpp:206-221, 432-436, 488-489)."""
    c = torch.cos(rot)
    s = torch.sin(rot)
    l0 = sx * sx
    l1 = sy * sy
    s11 = l0 * c * c + l1 * s * s
    s12 = (l0 - l1) * s * c
    s22 = l0 + l1 - s11
    det = s11 * s22 - s12 * s12
    a, b, d = s22 / det, -s12 / det, s11 / det
    return a, b, d, torch.sqrt(a * det) * bounds, torch.sqrt(d * det) * bounds


def _candidates(px, py, h, hw, s: Settings):
    """Each tile's splats whose bounding box reaches it, in index order:
    (ids (P,), start (n_tiles,), count (n_tiles,))."""
    dev = px.device
    th, tw = s.tile_h, s.tile_w
    nty, ntx = -(-s.height // th), -(-s.width // tw)
    y0 = _trunc(py - h).clamp(min=0)
    y1 = _trunc(py + h).clamp(max=s.height - 1)
    x0 = torch.floor(px - hw - 1.0).nan_to_num(0.0).to(torch.int64)
    x1 = torch.ceil(px + hw + 1.0).nan_to_num(-1.0).to(torch.int64)
    x0, x1 = x0.clamp(min=0), x1.clamp(max=s.width - 1)
    ok = (y0 <= y1) & (x0 <= x1) & torch.isfinite(px + py + h + hw)
    ty0 = torch.div(y0, th, rounding_mode="floor")
    ty1 = torch.div(y1, th, rounding_mode="floor")
    tx0 = torch.div(x0, tw, rounding_mode="floor")
    tx1 = torch.div(x1, tw, rounding_mode="floor")
    ny, nx = ty1 - ty0 + 1, tx1 - tx0 + 1
    n = torch.where(ok, ny * nx, torch.zeros_like(ny))
    ids = torch.repeat_interleave(torch.arange(px.shape[0], device=dev), n)
    first = torch.cumsum(n, 0) - n
    local = torch.arange(ids.shape[0], device=dev) - first[ids]
    ty = ty0[ids] + torch.div(local, nx[ids], rounding_mode="floor")
    tx = tx0[ids] + local % nx[ids]
    tile = ty * ntx + tx
    tile, order = torch.sort(tile, stable=True)
    ids = ids[order]
    count = torch.bincount(tile, minlength=nty * ntx)
    start = torch.cumsum(count, 0) - count
    return ids, start, count


def _tile_pixels(t0: int, t1: int, s: Settings, dev):
    """Integer rows (n, th, 1) and columns (n, 1, tw) of tiles t0..t1-1."""
    ntx = -(-s.width // s.tile_w)
    t = torch.arange(t0, t1, device=dev)
    ty, tx = torch.div(t, ntx, rounding_mode="floor"), t % ntx
    yy = ty[:, None, None] * s.tile_h + torch.arange(
        s.tile_h, device=dev)[None, :, None]
    xx = tx[:, None, None] * s.tile_w + torch.arange(
        s.tile_w, device=dev)[None, None, :]
    return yy, xx


def composite(params: dict, s: Settings, ref: Optional[torch.Tensor] = None,
              count_work: bool = False):
    """Render ``params`` (FIELDS -> float32 tensors of one image's splats).

    Returns (color (H, W, 3) float32, grads or None, work or None): with the
    (H, W, 3) target ``ref``, the gradients of sum (C - ref)^2 / 2 by field;
    with ``count_work``, the live (pixel, splat) evaluations ("pixels"),
    the (tile row, splat) and (tile column, splat) counts with a live pixel
    ("rows", "columns") and the (tile, splat) pairs with one ("pairs")."""
    dev = params["pos"].device
    need_grad = ref is not None
    n = params["pos"].shape[0]
    pad = lambda x, v: torch.cat([x, torch.full_like(x[:1], v)])
    sx = params["sx"].detach().clone().requires_grad_(need_grad)
    sy = params["sy"].detach().clone().requires_grad_(need_grad)
    rot = params["rot"].detach().clone().requires_grad_(need_grad)
    with torch.set_grad_enabled(need_grad):
        a, b, d, h, hw = geometry(sx, sy, rot, s.bounds)
    # The terms each batch gathers from: leaves of their own, so that each
    # batch's backward ends at them and one backward through geometry()
    # finishes the chain. Row n is a pad that covers nothing.
    terms = {
        "px": pad(params["pos"][:, 0].detach(), 0.0),
        "py": pad(params["pos"][:, 1].detach(), 0.0),
        "a": pad(a.detach(), 1.0), "b": pad(b.detach(), 0.0),
        "d": pad(d.detach(), 1.0),
        "op": pad(params["opacity"].detach(), 0.0),
        "col": torch.cat([params["color"].detach(),
                          torch.zeros_like(params["color"][:1])]),
    }
    for t in terms.values():
        t.requires_grad_(need_grad)
    h_pad = pad(h.detach(), -1.0)
    with torch.no_grad():
        ids, start, count = _candidates(terms["px"][:n], terms["py"][:n],
                                        h_pad[:n], hw.detach(), s)
    th, tw = s.tile_h, s.tile_w
    nty, ntx = -(-s.height // th), -(-s.width // tw)
    color = torch.zeros((nty * th, ntx * tw, 3), dtype=torch.float32,
                        device=dev)
    ref_p = None
    if need_grad:
        ref_p = torch.zeros_like(color)
        ref_p[: s.height, : s.width] = ref
    work = torch.zeros(4, dtype=torch.int64, device=dev)
    per_tile = th * tw * s.chunk
    tiles_per_batch = max(1, s.batch_entries // per_tile)
    count_h = count.cpu()
    thr = s.min_throughput
    for t0 in range(0, nty * ntx, tiles_per_batch):
        t1 = min(t0 + tiles_per_batch, nty * ntx)
        kmax = int(count_h[t0:t1].max())
        yy, xx = _tile_pixels(t0, t1, s, dev)
        inside = (yy < s.height) & (xx < s.width)        # (nb, th, tw)
        fy, fx = yy.float() + 0.5, xx.float() + 0.5
        nb = t1 - t0
        with torch.set_grad_enabled(need_grad):
            c_acc = torch.zeros((nb, th, tw, 3), dtype=s.dtype, device=dev)
            T = torch.ones((nb, th, tw), dtype=s.dtype, device=dev)
            for k0 in range(0, kmax, s.chunk):
                k = torch.arange(k0, min(k0 + s.chunk, kmax), device=dev)
                valid = k[None, :] < count[t0:t1, None]
                idx = torch.where(valid, start[t0:t1, None] + k[None, :], 0)
                cid = torch.where(valid, ids[idx], n)          # (nb, K)
                g = {key: v[cid] for key, v in terms.items()}
                px, py = g["px"][:, None, None, :], g["py"][:, None, None, :]
                hk = h_pad[cid][:, None, None, :]
                av, bv, dv = (g[key][:, None, None, :] for key in "abd")
                with torch.no_grad():
                    cover = _coverage(px, py, av, bv, dv, hk, yy, xx, fy, fx,
                                      s) & inside[..., None]
                vx = (fx[..., None] - px).to(s.dtype)          # (nb,1,tw,K)
                vy = (fy[..., None] - py).to(s.dtype)          # (nb,th,1,K)
                av, bv, dv = av.to(s.dtype), bv.to(s.dtype), dv.to(s.dtype)
                d2 = av * vx * vx + 2.0 * bv * vx * vy + dv * vy * vy
                alpha = _FastExp.apply(-0.5 * d2) * g["op"].to(
                    s.dtype)[:, None, None, :]
                one = torch.ones((), dtype=s.dtype, device=dev)
                with torch.no_grad():
                    pre = torch.cumprod(torch.where(cover, 1.0 - alpha, one),
                                        -1)
                    pre = T.detach()[..., None] * torch.cat(
                        [torch.ones_like(pre[..., :1]), pre[..., :-1]], -1)
                    live = cover & (pre >= thr)
                cp = torch.cumprod(torch.where(live, 1.0 - alpha, one), -1)
                t_pre = T[..., None] * torch.cat(
                    [torch.ones_like(cp[..., :1]), cp[..., :-1]], -1)
                w = torch.where(live, t_pre * alpha, torch.zeros_like(alpha))
                c_acc = c_acc + torch.einsum(
                    "nhwk,nkc->nhwc", w, g["col"].to(s.dtype))
                T = T * cp[..., -1]
                if count_work:
                    work += torch.stack([
                        live.sum(), live.any(2).sum(), live.any(1).sum(),
                        live.any(2).any(1).sum()])
                if bool(((T.detach() < thr) | ~inside).all()):
                    break
            c32 = c_acc.float()
            if need_grad:
                rt = ref_p.view(nty, th, ntx, tw, 3).permute(
                    0, 2, 1, 3, 4).reshape(nty * ntx, th, tw, 3)[t0:t1]
                diff = (c32 - rt) * inside[..., None]
                (0.5 * (diff * diff).sum()).backward()
        ty = torch.div(torch.arange(t0, t1), ntx, rounding_mode="floor")
        tx = torch.arange(t0, t1) % ntx
        for j in range(nb):
            y, x = int(ty[j]) * th, int(tx[j]) * tw
            color[y: y + th, x: x + tw] = c32[j].detach()
    color = color[: s.height, : s.width]
    grads = None
    if need_grad:
        z = lambda t: (torch.zeros_like(t) if t.grad is None else t.grad)[:n]
        g_abd = [z(terms[key]) for key in "abd"]
        g_sx, g_sy, g_rot = torch.autograd.grad(
            [a, b, d], [sx, sy, rot], g_abd, allow_unused=True)
        grads = {"pos": torch.stack([z(terms["px"]), z(terms["py"])], -1),
                 "sx": g_sx, "sy": g_sy, "rot": g_rot,
                 "color": z(terms["col"]), "opacity": z(terms["op"])}
    out_work = None
    if count_work:
        out_work = dict(zip(("pixels", "rows", "columns", "pairs"),
                            work.tolist()))
    return color, grads, out_work


def _coverage(px, py, a, b, d, h, yy, xx, fy, fx, s: Settings):
    """(nb, th, tw, K) bool: the pixel lies in the splat's row walk and in
    its row's exact interval (float32, the reference's order)."""
    yk = yy[..., None]
    row_ok = (yk >= _trunc(py - h)) & (yk <= _trunc(py + h))
    vy = fy[..., None] - py
    qb = 2.0 * b * vy
    qc = d * vy * vy - s.bounds * s.bounds
    disc = qb * qb - 4.0 * a * qc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    sgn = torch.where(qb < 0.0, -1.0, 1.0)
    kq = (-qb - sgn * sq) * 0.5
    r0 = kq / a
    r1 = qc / kq
    beg = _trunc(px + torch.minimum(r0, r1))
    end = _trunc(px + torch.maximum(r0, r1))
    xk = xx[..., None]
    return row_ok & (disc >= 0.0) & (xk >= beg) & (xk <= end)


def mse_255(color: torch.Tensor, ref: torch.Tensor) -> float:
    """MSE on the 0-255 scale over RGB, accumulated in float64."""
    d = (color.double() - ref.double()) * 255.0
    return float((d * d).mean())


def init_state(params: dict) -> dict:
    """A fitting state: the splats, Adam's moments and bias powers."""
    z = {f: torch.zeros_like(params[f]) for f in FIELDS}
    return {"params": {f: params[f].clone() for f in FIELDS}, "m": z,
            "v": {f: torch.zeros_like(params[f]) for f in FIELDS},
            "b1t": 1.0, "b2t": 1.0}


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def adam(state: dict, grads: dict, s: Settings) -> dict:
    """One Adam update with the reference's bias powers and clamps."""
    b1, b2 = _f32(s.beta1), _f32(s.beta2)
    b1t, b2t = _f32(state["b1t"] * b1), _f32(state["b2t"] * b2)
    p, m, v = (dict(state[k]) for k in ("params", "m", "v"))
    for f in FIELDS:
        if f == "opacity" and not s.optimize_opacity:
            continue
        g = grads[f]
        m[f] = b1 * m[f] + _f32(1.0 - b1) * g
        v[f] = b2 * v[f] + _f32(1.0 - b2) * g * g
        m_hat = m[f] / _f32(1.0 - b1t)
        v_hat = v[f] / _f32(1.0 - b2t)
        p[f] = p[f] - s.learning_rate * m_hat / (torch.sqrt(v_hat) + s.eps)
    p["pos"] = torch.stack([p["pos"][:, 0].clamp(0.0, s.width - 1.0),
                            p["pos"][:, 1].clamp(0.0, s.height - 1.0)], -1)
    p["sx"] = p["sx"].clamp(s.scale_min, s.scale_max)
    p["sy"] = p["sy"].clamp(s.scale_min, s.scale_max)
    p["color"] = p["color"].clamp(0.0, 1.0)
    p["opacity"] = p["opacity"].clamp(s.opacity_min, s.opacity_max)
    return {"params": p, "m": m, "v": v, "b1t": b1t, "b2t": b2t}


def step(state: dict, ref: torch.Tensor, s: Settings):
    """One fitting step: (new state, MSE of the pre-update render, the
    gradients)."""
    color, grads, _ = composite(state["params"], s, ref)
    return adam(state, grads, s), mse_255(color, ref), grads


def render_mse(params: dict, ref: torch.Tensor, s: Settings) -> float:
    """MSE of the render of ``params`` against ``ref``."""
    with torch.no_grad():
        color, _, _ = composite(params, s)
    return mse_255(color, ref)


def leaf_norms(tree: dict) -> dict:
    """The float64 Euclidean norm of each field."""
    return {f: math.sqrt(float((tree[f].double() ** 2).sum())) for f in tree}
