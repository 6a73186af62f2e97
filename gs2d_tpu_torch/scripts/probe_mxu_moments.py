"""Probe: should the backward's moment reduction ride the tensor cores?
(The counterpart of ``scripts/probe_mxu_moments.py``.)

    python -m gs2d_tpu_torch.scripts.probe_mxu_moments [--device cuda]

Times three standalone kernels that isolate just the reduction structure
(K steps over one 32 x 128 tile, fake z planes derived from a carry so
nothing folds), ``ops/probes.py``:

  vpu   -- the production reduction on the CUDA cores: per-thread row
           chains, column monomials, the lanes reduced by a reduce-scatter
           butterfly over four steps (bit for bit the production lane
           tree), warps in index order.
  mxu   -- per step the product of z with the monomials on the tensor cores
           (wgmma, 3xTF32), z computed in the A fragments' registers (no
           shared plane, no barrier a step), then a small stage 2 on the
           CUDA cores. Tests whether small in-loop matrix products issue
           fast enough to beat the chains.
  mxu2  -- producer warps run the recursion and store the z planes, split
           for TF32, into shared-memory stages; a consumer warpgroup
           contracts each batch of 64 planes with V on the tensor cores
           (wgmma, 3xTF32) as the stages are handed over.

Each is timed by its device time (``scripts/roofline.py::time_ms``) for one
block (the TPU probe's shape: one core, K = 512, 200 reps) and for one
block per SM, and prints us a call and ns per splat-tile reduction.
Numbers are structural ceilings, not end to end: the winner would still
need wiring into the real backward. A kernel that fails to build or launch
raises. ``--device cpu`` rehearses with the
plain PyTorch versions (host times, labelled so); a caller in Python may
pass ``main`` fewer steps and reps (the tests do).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="gs2d_tpu_torch.scripts.probe_mxu_moments",
        description="CUDA cores against tensor cores for the moment sums.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) requires a GPU; cpu rehearses with "
                         "the plain PyTorch versions")
    return ap


def main(argv=None, collect: dict | None = None, log=print,
         n_k: int = 512, reps: int = 200) -> int:
    """Runs the probe at K = ``n_k`` steps a call; ``collect``, when given,
    receives {(kind, n_blocks): ms a call} for a caller in the same
    process."""
    args = build_parser().parse_args(argv)

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        log(f"error: --device {args.device} but no CUDA GPU is visible; "
            "pass --device cpu to rehearse with the plain PyTorch versions")
        return 2
    device = torch.device(args.device)

    from gs2d_tpu_torch.ops import probes
    from gs2d_tpu_torch.scripts.roofline import time_ms
    from gs2d_tpu_torch.utils.hardware import card_line

    card = card_line(device)
    grids = [1]
    if device.type == "cuda":
        grids.append(torch.cuda.get_device_properties(device)
                     .multi_processor_count)
    what = "" if device.type == "cuda" \
        else " (host time of the plain version on the cpu)"
    k = n_k
    log(f"probe: K={k}, tile ({probes.TILE_H},{probes.TILE_W}), "
        f"{reps} reps")
    for n_blocks in grids:
        for kind, (name, fn, _) in probes.MOMENT_PROBES.items():
            out = fn(device, n_k=k, n_blocks=n_blocks)
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{kind}: non-finite output")
            ms = time_ms(lambda: fn(device, n_k=k, n_blocks=n_blocks),
                         reps, device)
            log(f"  {kind} ({name}), {n_blocks} block"
                f"{'s' if n_blocks > 1 else ''}: {ms * 1e3:.1f} us/call, "
                f"{ms * 1e6 / k:.1f} ns per splat-tile reduction in a block, "
                f"{ms * 1e6 / (k * n_blocks):.2f} ns across the grid{what} "
                f"(val {float(out[0, 0]):.6e}) [{card}]")
            if collect is not None:
                collect[(kind, n_blocks)] = ms
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
