"""Debug visualization: eigen axes, covariance ellipse, exact bbox overlay
(the counterpart of ``gs2d_tpu/utils/visualize.py``).

The reference draws these live per splat with GL line primitives
(main.cpp:441-485): the two scaled eigen axes, a 16-segment ellipse at one
sigma, and the exact covariance bounding box. Here the same overlay renders
into a numpy image (headless), for visual checks and dumps.
"""

from __future__ import annotations

import numpy as np

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import geometry
from gs2d_tpu_torch.params import GaussianParams

# Minimal 3x5 bitmap glyphs for the per-splat info text (digits, ':', '.').
_GLYPHS = {
    "0": "111101101101111", "1": "010110010010111", "2": "111001111100111",
    "3": "111001111001111", "4": "101101111001001", "5": "111100111001111",
    "6": "111100111101111", "7": "111001001001001", "8": "111101111101111",
    "9": "111101111001111", ":": "000010000010000", ".": "000000000000010",
}


def _draw_text(img: np.ndarray, org, text: str, color):
    """Blit 3x5 bitmap text at ``org`` (x, y): the headless stand-in for
    the reference's DrawText splat info readout (main.cpp:479-484)."""
    h, w = img.shape[:2]
    x0 = int(round(float(org[0])))
    y0 = int(round(float(org[1])))
    for ch in text:
        bits = _GLYPHS.get(ch)
        if bits is not None:
            for r in range(5):
                for cidx in range(3):
                    if bits[r * 3 + cidx] == "1":
                        y, x = y0 + r, x0 + cidx
                        if 0 <= y < h and 0 <= x < w:
                            img[y, x] = color
        x0 += 4


def _draw_line(img: np.ndarray, p0, p1, color):
    """DDA line draw (the reference's drawLineDDA analog, main.cpp:368)."""
    h, w = img.shape[:2]
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    steps = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    xi = np.round(np.linspace(x0, x1, steps + 1)).astype(int)
    yi = np.round(np.linspace(y0, y1, steps + 1)).astype(int)
    ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    img[yi[ok], xi[ok]] = color


def overlay_splats(
    base: np.ndarray,
    params: GaussianParams,
    cfg: SplatConfig,
    max_splats: int | None = None,
    draw_axes: bool = True,
    draw_ellipse: bool = True,
    draw_bbox: bool = True,
    show_info: bool = False,
) -> np.ndarray:
    """Return a copy of ``base`` (H, W, 3 float in [0,1]) with per-splat debug
    geometry drawn on top (reference main.cpp:441-477). ``show_info`` adds
    the per-splat "index:opacity" text readout (the reference's
    showSplatInfo toggle, main.cpp:479-484). The geometry is computed on the
    CPU, whatever device ``params`` lies on."""
    img = np.array(base, dtype=np.float32, copy=True)
    p = params.map(lambda x: x.detach().cpu())
    s11, s12, s22 = geometry.cov_of(p.sx, p.sy, p.rot)
    l0, l1, det = geometry.eigenvalues_2x2(s11, s12, s22)
    e0, e1 = (v.numpy() for v in geometry.eigenvectors_of_cov(s11, s12, s22,
                                                              l0))
    s11, s22, l0, l1, det = (v.numpy() for v in (s11, s22, l0, l1, det))
    pos, color, opacity = p.pos.numpy(), p.color.numpy(), p.opacity.numpy()
    n = p.n if max_splats is None else min(p.n, max_splats)
    a_inv = s22 / det
    d_inv = s11 / det

    white = np.float32([1, 1, 1])
    gray = np.float32([0.5, 0.5, 0.5])
    for i in range(n):
        c = pos[i]
        ax0 = e0[i] * np.sqrt(l0[i])
        ax1 = e1[i] * np.sqrt(l1[i])
        if draw_axes:
            _draw_line(img, c, c + ax0, white)
            _draw_line(img, c, c + ax1, 0.9 * white)
        if draw_ellipse:
            t = np.linspace(0, 2 * np.pi, 17)
            pts = c[None] + np.outer(np.sin(t), ax0) + np.outer(np.cos(t), ax1)
            for j in range(16):
                _draw_line(img, pts[j], pts[j + 1], color[i])
        if draw_bbox:
            # exact covariance bbox half-extents (main.cpp:465-466)
            hx = np.sqrt(d_inv[i] * det[i])
            hy = np.sqrt(a_inv[i] * det[i])
            corners = [c + [-hx, -hy], c + [hx, -hy], c + [hx, hy],
                       c + [-hx, hy]]
            for j in range(4):
                _draw_line(img, corners[j], corners[(j + 1) % 4], gray)
        if show_info:
            _draw_text(img, c + [2.0, 2.0], f"{i}:{float(opacity[i]):.2f}",
                       white)
    return np.clip(img, 0.0, 1.0)
