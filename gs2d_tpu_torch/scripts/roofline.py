"""Speed-of-light accounting for the splat kernels on the current card (the
counterpart of ``scripts/roofline.py``).

    python -m gs2d_tpu_torch.scripts.roofline [--device cuda]

1. HBM bandwidth ceiling, measured: ``y = x + 1`` over a 256 MB float32
   array (reads + writes = 2 x size), its device time.
2. float32 FMA ceiling, measured: kernel 14 (``ops/probes.py::fma_peak``),
   independent FMA chains in registers, swept over the chains per thread;
   the best rate in TFMA/s (1 FMA = 2 FLOP).
3. For each workload (the two assets at 1k resident, 1k dense, 10k dense and
   10k flat, and a synthetic 1080p target at 100k flat): binning at the
   pcg3d init, then the L2 step's kernels timed by their device time
   (kernel 1, kernel 4/5, or kernels 10 + 11; ``time_ms``): pair-steps
   (one splat listed in one tile), kernel ms, pair-steps/s, and the share
   of both ceilings, the published one (NVIDIA's data sheet for the H100
   SXM: 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s) and the
   measured one. The share is bound / kernel time, the bound being the
   least time the card could take for the work these inputs need
   (``bound``).

The operation model is the port's own (``chip_smoke.py`` reports its bounds
with the same ``live_work`` and ``bound``). Operations are counted from
csrc/splat_terms.cuh with each float add, subtract, multiply, divide, sqrt,
compare, min/max, select and float-to-int conversion as one, and each term
where it first varies:

- ROW_OPS per (row, pair) with a live pixel: splat_terms' vy and the
  ellipse quadratic's row interval (qb 2, qc 3 with d*vy*vy, disc 4, the
  root 5, kq 4, r0/r1 2, the bounds 6); integer bound tests not counted;
- PIXEL_OPS per live (pixel, pair), live being covered with T above the
  threshold (the others need no work): splat_terms' vx 1, the rest of d2
  6, the fast exp 8, alpha 1, the T test 1;
- FWD_OPS and BWD_OPS per live (pixel, pair) on top: fwd_one's weight,
  colour sums and T update; bwd_one's gcdot, ga, the 1/(1 - alpha) guard,
  dL/dalpha, the six moment sums and T update (the selects that only mask
  dead pixels are not counted). The fused L2 kernels count splat_terms once
  for both passes;
- COLUMN_OPS per (column, pair) with a live pixel: Moments::finish's 3
  products and 9 adds of the sum over the tile's columns;
- per image pixel, the cotangent terms: 10 in the backward (gf, ga's
  start) and 8 in the L2 kernels (gC = C - ref, gf).

Kernel 13 (csrc/render_mxu.cu), counted the same way: per live (pixel, pair)
D2 from the coefficients and its basis terms x'y', y'^2 12, the fast exp 8,
alpha 1 and the T test 1 (MXU_PIXEL_OPS, once for both phases), phase 0's
FWD_OPS, and phase 1's weights 3, colour sums 6, the guard 2, dL/dalpha 18,
q 1, T 2 and the seven column sums 14 (MXU_BWD_OPS); per (column, pair) the
x' products 4 and the ten sums over columns 10; per image pixel gC 3.

The live counts come from the plain composite of the run's inputs. gs2d_tpu's
``workload_scan_diff`` (two ``lax.scan`` programs subtracted) has no
counterpart: the profiler's device durations time a kernel directly
(ROADMAP.md, "Deliberately not ported").

``--device cpu`` rehearses the accounting with the kernels' plain PyTorch
versions: host times, labelled so, and no ceilings. The plain walks take
minutes at the workloads' sizes, so a rehearsal calls ``main`` from Python
with a smaller ``workloads`` (the tests do).
"""

from __future__ import annotations

import argparse
import functools
import time

F32_PEAK = 67e12     # FLOP/s, float32 outside the tensor cores (data sheet)
TF32_PEAK = 495e12   # FLOP/s, TF32 on the tensor cores, dense (data sheet)
HBM_RATE = 3.35e12   # B/s (data sheet)
ROW_OPS = 27
PIXEL_OPS = 17
FWD_OPS = 9
BWD_OPS = 30
COLUMN_OPS = 12
MXU_PIXEL_OPS = 22
MXU_BWD_OPS = 46
MXU_COLUMN_OPS = 14

# (name, asset or None for the synthetic target, width, height, splats,
# binning): scripts/roofline.py's five workloads.
WORKLOADS = (
    ("mini 1k resident", "squirrel_cls_mini.npy", 268, 213, 1024, "resident"),
    ("mini 1k dense", "squirrel_cls_mini.npy", 268, 213, 1024, "dense"),
    ("10k dense", "squirrel_cls.npy", 535, 426, 10240, "dense"),
    ("10k flat", "squirrel_cls.npy", 535, 426, 10240, "flat"),
    ("1080p 100k flat", None, 1920, 1080, 102400, "flat"),
)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def live_work(rows, count, cfg) -> dict:
    """What a front-to-back composite from T = 1 must evaluate: the live
    (pixel, pair) evaluations ("pixels"), and the (row, pair) and (column,
    pair) counts with at least one live pixel ("rows", "columns"), summed
    over the tiles. ``rows`` (n_tiles, K, 16) holds each tile's listed
    packed rows (pad rows past its count)."""
    import torch

    from gs2d_tpu_torch.ops import render as rd

    yy, xx, fy, fx, inside = rd.tile_coords(cfg, rows.device)
    T = inside.to(torch.float32)
    n = torch.zeros(3, dtype=torch.int64, device=rows.device)
    for k in range(int(count.max())):
        live, alpha, *_ = rd._splat_terms(rows[:, k], fx, fy, xx, yy, inside,
                                          T, cfg)
        live &= (k < count)[:, None, None]
        n += torch.stack([live.sum(), live.any(2).sum(), live.any(1).sum()])
        T = torch.where(live, T * (1.0 - alpha), T)
    return dict(zip(("pixels", "rows", "columns"), n.tolist()))


def bound(kind: str, work: dict, cfg, n_bytes: int,
          f32_peak: float = F32_PEAK, hbm_rate: float = HBM_RATE):
    """(bound_ms, bound_by) of a forward ("fwd"), backward ("bwd"), fused
    L2 ("l2") or MXU-form L2 ("mxu") kernel that does ``work`` (live_work's
    counts) and moves ``n_bytes`` (each input read once, each output written
    once): the larger of its operations over ``f32_peak`` and its bytes over
    ``hbm_rate``, the published ceilings unless others are given."""
    img = cfg.height * cfg.width
    rows = work["rows"] * ROW_OPS
    px = work["pixels"]
    cols = work["columns"] * COLUMN_OPS
    ops = {"fwd": rows + px * (PIXEL_OPS + FWD_OPS),
           "bwd": rows + px * (PIXEL_OPS + BWD_OPS) + cols + 10 * img,
           "l2": rows + px * (PIXEL_OPS + FWD_OPS + BWD_OPS) + cols
           + 8 * img,
           "mxu": rows + px * (MXU_PIXEL_OPS + FWD_OPS + MXU_BWD_OPS)
           + work["columns"] * MXU_COLUMN_OPS + 3 * img}[kind]
    t_ops, t_bytes = ops / f32_peak, n_bytes / hbm_rate
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def flat_listed_rows(b, device):
    """(n_tiles, max count, 16): each tile's listed rows of a flat binning,
    pad rows past its count (live_work's input)."""
    import torch

    from gs2d_tpu_torch.ops import tiles as tl

    k = torch.arange(int(b.count.max()), device=device)
    idx = torch.where(k[None] < b.count[:, None], b.start[:, None] + k[None],
                      b.rows.shape[0])
    return torch.cat([b.rows, tl.pad_row(device)[None]])[idx.long()]


def time_ms(fn, reps: int, device) -> float:
    """Mean ms of ``fn``: on the card its device time (torch.profiler's
    kernel durations, utils/profiling.py::device_time), on the CPU the host
    clock (a rehearsal, not a device time)."""
    if device.type == "cuda":
        from gs2d_tpu_torch.utils.profiling import device_time

        return device_time(fn, reps)["device"]
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def measure_hbm_bw(device, reps: int = 32) -> float:
    """GB/s of a big elementwise pass, y = x + 1 over 256 MB of float32
    (read + write), from its device time."""
    import torch

    n = 256 * 1024 * 1024 // 4
    x = torch.zeros((n,), dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    ms = time_ms(lambda: torch.add(x, 1.0, out=y), reps, device)
    return 2 * n * 4 / (ms * 1e-3) / 1e9


def measure_fma(device, log=print, reps: int = 5) -> float:
    """Measured float32 FMA/s ceiling from kernel 14. Each accumulator
    chain is serial (FMA latency-bound), so the chains per thread set the
    instruction-level parallelism; sweep them and take the best rate."""
    from gs2d_tpu_torch.ops import probes

    best = 0.0
    for chains in (2, 4, 8, 16, 32):
        ms = time_ms(lambda: probes.fma_peak(chains, device), reps, device)
        rate = probes.FMA_GRID * probes.FMA_THREADS * probes.FMA_INNER \
            * chains / (ms * 1e-3)
        log(f"  fma chains={chains}: {rate / 1e12:.3f} TFMA/s "
            f"({ms:.4f} ms)")
        best = max(best, rate)
    return best


def workload(name, asset, w, h, n_splats, binning, device, reps: int = 10):
    """Bin the pcg3d init of one workload and time its L2 step's kernels.
    Returns a dict with pair_steps, kernel_ms, the kernels timed, and the
    inputs of the bound ("parts": (kind, bytes) per kernel, "work", "cfg")."""
    import torch

    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.image import load_asset, synthetic_target
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_dense as rdn
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import render_resident as rr
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.ops import tiles_flat as tlf
    from gs2d_tpu_torch.ops._build import on_card
    from gs2d_tpu_torch.params import init_params

    ref = load_asset(asset) if asset else synthetic_target(h, w)
    cfg = tl.tune_tile_height(SplatConfig(width=w, height=h,
                                          n_splats=n_splats, binning=binning))
    p = init_params(cfg, device)
    ref_chw = rd.pad_ref_chw(ref, cfg, device)
    card = on_card(ref_chw)
    if binning == "flat":
        cfg = rf.tune_flat_config(p, cfg)
        kc, mc = cfg.flat_chunk, cfg.flat_max_chunks
        b = tlf.bin_splats_flat(p, cfg, cfg.flat_capacity, kc=kc,
                                max_chunks=mc)
        fwd = rf._fwd_flat_cuda if card else rf._fwd_flat_plain
        bwd = (functools.partial(rf._bwd_flat_cuda, fields=tl.packed_fields(
            p, cfg.splat_bounds)) if card else rf._bwd_flat_plain)
        fwd_in = (b.rows, b.start, b.count, cfg, kc, mc)
        color, trans = fwd(*fwd_in)
        gc = (color - ref_chw[0]).contiguous()
        cin, tin = rd.identity_carry(cfg, device)
        bwd_in = (b.rows, b.ids, b.start, b.count, color, gc, cin, tin,
                  n_splats, cfg, kc, mc)
        _, g = bwd(*bwd_in)

        def kern():
            fwd(*fwd_in)
            bwd(*bwd_in)

        kernels = "kernels 10 + 11"
        listed = flat_listed_rows(b, device)
        base = nbytes(b.rows, b.start, b.count)
        parts = (("fwd", base + nbytes(color, trans)),
                 ("bwd", base + nbytes(b.ids, color, gc, cin, tin, g)))
        statics = (f"M={cfg.flat_capacity} kc={kc} max_chunks={mc} "
                   f"K-chunks={int(((b.count + kc - 1) // kc).sum())}")
    else:
        cfg = tl.tune_tile_capacity(p, cfg)
        k = rd._max_per_tile(cfg)
        if binning == "resident":
            b = tl.bin_splats(p, cfg, k, ids_only=True)
            table = rr.resident_table(p, cfg)
            ids = rr._remap_ids(b, n_splats)
            fn = rr._l2_resident_cuda if card else rr._l2_resident_plain
            args = (table, ids, b.count, ref_chw, n_splats, cfg)
            color, g = fn(*args)
            kernels = "kernel 1"
            listed = table.reshape(-1, tl.N_FIELDS)[ids.long()]
            moved = nbytes(table, ids, b.count, ref_chw, color, g)
        else:
            b = tl.bin_splats(p, cfg, k)
            fn = rdn._l2_dense_cuda if card else rdn._l2_dense_plain
            args = (b.tile_params, b.ids, b.count, ref_chw, n_splats, cfg)
            color, _, g = fn(*args)
            kernels = "kernel 4/5"
            listed = b.tile_params
            moved = nbytes(b.tile_params, b.ids, b.count, ref_chw, color, g)

        def kern():
            fn(*args)

        parts = (("l2", moved),)
        statics = f"K={k}"
    if int(b.n_dropped):
        raise AssertionError(f"{name}: binning dropped {int(b.n_dropped)}")
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: non-finite moments")
    return {
        "workload": name, "pair_steps": int(b.count.sum()),
        "kernel_ms": time_ms(kern, reps, device), "kernels": kernels,
        "tiling": f"tile {cfg.tile_h}x{cfg.tile_w}, {cfg.n_tiles_y}x"
                  f"{cfg.n_tiles_x} tiles, max count {int(b.count.max())}, "
                  f"{statics}",
        "work": live_work(listed, b.count, cfg), "parts": parts, "cfg": cfg,
    }


def share(r: dict, f32_peak: float, hbm_rate: float):
    """(share of the ceiling, what bounds it) of a workload's kernels: the
    sum of their bounds over their time."""
    bounds = [bound(kind, r["work"], r["cfg"], n, f32_peak, hbm_rate)
              for kind, n in r["parts"]]
    return (sum(ms for ms, _ in bounds) / r["kernel_ms"],
            "+".join(by for _, by in bounds))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="gs2d_tpu_torch.scripts.roofline",
        description="Measured ceilings and kernel shares on the current "
                    "card.")
    ap.add_argument("--skip-ceilings", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) requires a GPU; cpu rehearses with "
                         "the plain PyTorch versions")
    return ap


def main(argv=None, collect: dict | None = None, log=print,
         workloads=WORKLOADS, reps: int = 10) -> int:
    """Runs the accounting; ``collect``, when given, receives the numbers
    ("hbm_gbps", "fma_per_s", "workloads": the workload dicts with their
    shares) for a caller in the same process, which may also pass other
    ``workloads`` and ``reps`` (a CPU rehearsal at a small size)."""
    args = build_parser().parse_args(argv)

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        log(f"error: --device {args.device} but no CUDA GPU is visible; "
            "pass --device cpu to rehearse with the plain PyTorch versions")
        return 2
    device = torch.device(args.device)

    from gs2d_tpu_torch.utils.hardware import card_line

    card = card_line(device)
    bw = fma = None
    if device.type == "cuda" and not args.skip_ceilings:
        bw = measure_hbm_bw(device)
        log(f"HBM elementwise BW ceiling: {bw:8.1f} GB/s measured "
            f"({100 * bw * 1e9 / HBM_RATE:.1f}% of the published "
            f"{HBM_RATE / 1e9:.0f} GB/s) [{card}]")
        fma = measure_fma(device, log)
        log(f"float32 FMA ceiling:        {fma / 1e12:8.3f} TFMA/s measured "
            f"({2 * fma / 1e12:.3f} TFLOP/s, {100 * 2 * fma / F32_PEAK:.1f}% "
            f"of the published {F32_PEAK / 1e12:.0f} TFLOP/s) [{card}]")
    else:
        log("ceilings: not measured")
    what = "kernel" if device.type == "cuda" \
        else "host time of the plain versions on the cpu,"
    results = []
    for name, asset, w, h, n, binning in workloads:
        r = workload(name, asset, w, h, n, binning, device, reps)
        line = (f"{name:18s} pair-steps {r['pair_steps']:>9d}  {what} "
                f"{r['kernel_ms']:8.3f} ms ({r['kernels']})  "
                f"{r['pair_steps'] / r['kernel_ms'] / 1e3:7.2f} M "
                "pair-steps/s")
        if device.type == "cuda":
            r["share_published"], r["bound_by"] = share(r, F32_PEAK,
                                                        HBM_RATE)
            line += (f"  {100 * r['share_published']:.4f}% of the published "
                     f"ceiling ({r['bound_by']})")
            if fma:
                r["share_measured"], by = share(r, 2 * fma, bw * 1e9)
                line += (f", {100 * r['share_measured']:.4f}% of the "
                         f"measured ({by})")
        log(f"{line}  [{r['tiling']}; live (pixel, pair) "
            f"{r['work']['pixels']}] [{card}]")
        results.append(r)
    log("NOTE: pair-steps count BINNED pairs; the shares count only the live\n"
        "(pixel, pair) evaluations a front-to-back composite needs, so\n"
        "the saturation exits cannot lift a share past 100%.")
    if collect is not None:
        collect.update(hbm_gbps=bw, fma_per_s=fma, workloads=results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
