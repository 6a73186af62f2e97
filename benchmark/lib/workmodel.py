"""The frozen work model: what the inputs make a step do, and the least time
the card could take for it.

Operations are counted as in ``gs2d_tpu_torch/scripts/roofline.py`` (copied
here so that later changes to the program cannot move the yardstick): each
float add, subtract, multiply, divide, sqrt, compare, min/max, select and
float-to-int conversion is one, and each term is counted where it first
varies:

- ROW_OPS per (tile row, splat) with a live pixel: the row's ellipse
  interval;
- PIXEL_OPS per live (pixel, splat), live being covered while the pixel's
  transmittance is at least the threshold: the offset, d2, the fast exp,
  alpha and the T test;
- FWD_OPS and BWD_OPS per live (pixel, splat) on top: the forward's weight,
  colour sums and T update; the backward's cotangent dot, dL/dalpha, the
  moment sums and T update;
- COLUMN_OPS per (tile column, splat) with a live pixel: the moments' sum
  over the tile's columns;
- per image pixel, the cotangent terms: 10 in a backward, 8 in a fused L2
  step;
- per splat, for the whole step: M2G_OPS in moments_to_grads (the nine
  moments to the nine gradients) and ADAM_OPS in Adam with its clamps
  (eight optimised parameters of 14 operations each, seven clamps of two).

The live counts come from the plain reference's composite of the
population (``reference.splats.composite(count_work=True)``), which bins
and tests liveness itself. Bytes are each input read once and each output
written once: a splat's nine parameters, a 4-byte id per listed (tile,
splat) pair, the target or cotangent image and the colour image (3 float32
a pixel), and nine gradients a splat.

Peaks are NVIDIA's published figures for the H100 SXM at its 700 W limit
(67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s); the card's power
limit is printed beside every share.
"""

from __future__ import annotations

F32_PEAK = 67e12
HBM_RATE = 3.35e12
ROW_OPS = 27
PIXEL_OPS = 17
FWD_OPS = 9
BWD_OPS = 30
COLUMN_OPS = 12
M2G_OPS = 48
ADAM_OPS = 126
SPLAT_BYTES = 9 * 4
PAIR_BYTES = 4
PIXEL_BYTES = 3 * 4


def operations(kind: str, work: dict, pixels: int) -> float:
    """Float32 operations of a forward ("fwd"), backward ("bwd") or fused
    L2 ("l2") pass over ``work`` on an image of ``pixels`` pixels."""
    rows = work["rows"] * ROW_OPS
    px = work["pixels"]
    cols = work["columns"] * COLUMN_OPS
    return {"fwd": rows + px * (PIXEL_OPS + FWD_OPS),
            "bwd": rows + px * (PIXEL_OPS + BWD_OPS) + cols + 10 * pixels,
            "l2": rows + px * (PIXEL_OPS + FWD_OPS + BWD_OPS) + cols
            + 8 * pixels}[kind]


def nbytes(kind: str, work: dict, pixels: int, splats: int) -> float:
    pairs = work["pairs"] * PAIR_BYTES
    params = splats * SPLAT_BYTES
    img = pixels * PIXEL_BYTES
    return {"fwd": params + pairs + img,
            "bwd": 2 * params + pairs + img,
            "l2": 2 * params + pairs + 2 * img}[kind]


def bound_s(kind: str, work: dict, pixels: int, splats: int) -> float:
    """The least seconds the card could take: the larger of the operations
    over F32_PEAK and the bytes over HBM_RATE."""
    return max(operations(kind, work, pixels) / F32_PEAK,
               nbytes(kind, work, pixels, splats) / HBM_RATE)


def step_operations(work: dict, pixels: int, splats: int) -> float:
    """A whole fitting step: the fused L2 pass and the per-splat work."""
    return operations("l2", work, pixels) + splats * (M2G_OPS + ADAM_OPS)
