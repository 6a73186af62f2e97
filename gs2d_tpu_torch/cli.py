"""Command-line fitting app of the PyTorch port (the counterpart of
``gs2d_tpu/cli.py`` for the resident, flat and dense fitting paths, L2 or
the SSIM mix, with Morton reordering between fit blocks, checkpoints with
resume, recovery from non-finite parameters and mid-fit render dumps, and
several images fitted at once).

Usage:
  python -m gs2d_tpu_torch.fit assets/squirrel_cls_mini.npy --splats 1024 \
      --iters 200 --out runs/torch_fit
  python -m gs2d_tpu_torch.fit assets/squirrel_cls.npy --splats 10240 \
      --iters 200 --out runs/torch_fit_10k
  python -m gs2d_tpu_torch.fit assets/squirrel_cls_mini.npy --splats 1024 \
      --iters 200 --ssim 0.2 --binning dense --out runs/torch_fit_ssim
  python -m gs2d_tpu_torch.fit assets/squirrel_cls_mini.npy --iters 200 \
      --checkpoint-every 100 --out runs/torch_fit_ck    # then --resume
  python -m gs2d_tpu_torch.fit assets/squirrel_cls_mini.npy --splats 1024 \
      --iters 200 --scan-chunk 50 --rebin-margin 2 --out runs/torch_scan
  python -m gs2d_tpu_torch.fit assets/squirrel_cls_mini.npy --iters 400 \
      --optimize-opacity --densify-every 100 --opacity-reset-every 200 \
      --scan-chunk 50 --out runs/torch_adaptive
  python -m gs2d_tpu_torch.fit a.npy b.npy --splats 1024 --iters 200 \
      --scan-chunk 50 --out runs/torch_batch
  python -m gs2d_tpu_torch.fit assets/squirrel_cls_mini.npy --mesh 1,1,1 \
      --iters 200 --out runs/torch_mesh
  COORDINATOR_ADDRESS=127.0.0.1:29500 NUM_PROCESSES=2 PROCESS_ID=<0|1> \
      python -m gs2d_tpu_torch.fit assets/squirrel_cls_mini.npy --mesh 1,2,1 \
      --device cpu --iters 20 --out runs/torch_mesh_2   # one per process

Fits through the layout gs2d_tpu would pick (``--binning auto``: resident
for small populations, flat above 4096 splats, dense for small populations
whose resident table does not fit), then renders ``render_final.png``
through that layout's forward kernel with the fit's config. ``--ssim``
mixes lambda * (1 - SSIM) into the objective and trains on the modular
path (the layout's forward and backward kernels under autograd), with the
default per-tile capacity as gs2d_tpu's CLI does. The tile height follows
gs2d_tpu's policy unless ``--tile-h`` is given. ``--reorder-every N`` fits
in blocks of at most N iterations and re-sorts the population along the
Morton curve between blocks, as gs2d_tpu's CLI does. The window layout is
not a CLI choice, in gs2d_tpu or here: it is reached through
``train.loop.fit`` with ``cfg.binning = "window"``.
``--checkpoint-every N`` writes ``<out>/checkpoints/step_<n>.npz`` at every
N-th global iteration and at the end (gs2d_tpu's npz format, so either
package resumes the other's run); ``--resume`` continues from the newest
one and exits 2 when there is none. ``--recover`` fits through
``train.loop.fit_with_recovery``: on non-finite parameters it restores the
newest checkpoint and halves the learning rate instead of aborting.
``--save-render-every N`` dumps ``render_<iter>.png`` at every N-th
iteration. ``--scan-chunk N`` runs the iterations in blocks of N steps
without the host (on the card, one train step captured as a CUDA graph and
replayed; on the CPU the same step in a Python loop), logging and
checkpointing at block ends. ``--rebin-margin M`` bins with M pixels of
footprint slack and, in scanned resident and flat fits, rebuilds the
binning only on steps where a splat escaped it (-1 picks M from the
measured pair inflation). ``--opacity-cull [ALPHA]`` bins only the pairs
where a splat's alpha can reach ALPHA (1/256 for the bare flag; lossy by
design, off by default). ``--densify-every N`` prunes, clones and splits
every N iterations, on one of gs2d_tpu's two routes: by default
``train.densify.fit_adaptive``, which sums |dL/d pos| inside the fused
train step (``--opacity-reset-every M`` caps opacities at 0.3 there
whenever a window crosses a multiple of M, with ``--optimize-opacity``);
with ``--ssim`` or ``--checkpoint-every`` the block route of ``fit`` calls,
which densifies at block boundaries on the |dL/d pos| of one L2 gradient
through ``production_render`` (gs2d_tpu takes it from its scan renderer,
which the port does not have). Several images (of one size) fit one
population each through gs2d_tpu's batch route (``_fit_batch``:
``fit_batched``, eager or scanned, or ``fit_adaptive_batched`` with
``--densify-every``), writing ``render_final_<i>.png``; the flags that
route would ignore exit 2. ``--mesh D,T,S`` fits over a (data, tile,
splat) mesh (``parallel.sharded.fit_sharded``), one process a device:
started alone it runs a mesh of one device, and a larger mesh needs one
process a device started with COORDINATOR_ADDRESS, NUM_PROCESSES and
PROCESS_ID (NCCL on the card, gloo with ``--device cpu``); several images
are its data axis (the batch must divide over it), ``--resume``,
``--checkpoint-every`` (rank 0 writes the whole batched state), ``--ssim``,
``--scan-chunk``, ``--rebin-margin`` and ``--densify-every`` pass through,
``--reorder-every``, ``--save-render-every``, ``--recover`` and
``--opacity-reset-every`` exit 2, and rank 0 writes one
``render_final[_<i>].png`` a image (gs2d_tpu's ``render_pallas.render``,
``ops/render_dense.render``, with the fit's tuned cfg). ``--device`` defaults
to ``cuda`` and exits 2 when no GPU is visible; ``--device cpu`` runs the
kernels' plain PyTorch versions. Flags of ``gs2d_tpu.cli`` for features
this port does not have yet are not accepted (argparse exits 2), so
nothing a user asks for is silently ignored.
"""

from __future__ import annotations

import argparse
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gs2d_tpu_torch.fit",
        description="Fit 2D Gaussian splats to a target image (PyTorch/CUDA).")
    p.add_argument("image", nargs="+",
                   help="target image (.npy uint8 (H, W, 3), or a file PIL "
                        "can decode); more than one runs the batched fit "
                        "(the data axis with --mesh), "
                        "one population per image (equal sizes only)")
    p.add_argument("--splats", type=int, default=1024,
                   help="population size (reference default 1024)")
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--out", default="runs/fit", help="output directory")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--lr-decay-iters", type=int, default=0,
                   help="decay lr exponentially to --lr-final over this many "
                        "iterations, then hold (0 = constant lr, the "
                        "reference behavior)")
    p.add_argument("--lr-final", type=float, default=0.005)
    p.add_argument("--optimize-opacity", action="store_true",
                   help="update opacity too (reference toggle, default off)")
    p.add_argument("--exact-exp", action="store_true",
                   help="exact exp instead of the (1+x/8)^8 approximation")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --out")
    p.add_argument("--recover", action="store_true",
                   help="on non-finite parameters, restore the latest "
                        "checkpoint with halved lr instead of aborting")
    p.add_argument("--save-render-every", type=int, default=0)
    p.add_argument("--max-per-tile", type=int, default=0,
                   help="per-tile splat capacity (0 = tuned from the "
                        "initial population)")
    p.add_argument("--tile-h", type=int, default=0,
                   help="pixel-tile height (0 = auto: gs2d_tpu's policy, 32, "
                        "or 64 for deep, tall populations)")
    p.add_argument("--binning",
                   choices=["auto", "dense", "flat", "resident"],
                   default="auto",
                   help="tile binning layout (auto picks by population size "
                        "as gs2d_tpu does)")
    p.add_argument("--densify-every", type=int, default=0,
                   help="run densify/prune every N iterations (0 = off)")
    p.add_argument("--opacity-reset-every", type=int, default=0,
                   help="cap opacities at 0.3 and zero their Adam moments "
                        "every N iterations (3DGS floater control; needs "
                        "--optimize-opacity and --densify-every, and not "
                        "the modular route of --ssim / --checkpoint-every)")
    p.add_argument("--reorder-every", type=int, default=0,
                   help="re-sort splats along the Morton curve every N "
                        "iterations (changes the compositing order)")
    p.add_argument("--scan-chunk", type=int, default=0,
                   help="run iterations in blocks of this many steps without "
                        "the host (a CUDA graph of the step replayed on the "
                        "card; 0 = one host dispatch per iteration)")
    p.add_argument("--rebin-margin", type=float, default=0.0,
                   help="lazy rebinning: bin with this many pixels of "
                        "footprint slack and reuse the binning across "
                        "scanned steps until a splat escapes it (resident "
                        "or flat layout + --scan-chunk only; 0 = rebin every "
                        "step; -1 = auto from measured pair inflation)")
    p.add_argument("--opacity-cull", type=float, default=0.0,
                   nargs="?", const=1.0 / 256.0, metavar="ALPHA",
                   help="opacity-adaptive footprint culling: skip "
                        "(splat, tile) pairs whose every pixel alpha "
                        "would fall below ALPHA (bare flag = 1/256, the "
                        "reference's early-out constant). Lossy by < "
                        "ALPHA/pixel/pair; pays on trained or reset "
                        "opacities (op < 0.35)")
    p.add_argument("--ssim", type=float, default=0.0, metavar="LAMBDA",
                   help="mix lambda*(1-SSIM) into the objective (0 = pure "
                        "L2, the reference objective); runs on the modular "
                        "path")
    p.add_argument("--mesh", default="",
                   help="data,tile,splat axis sizes for a fit over several "
                        "devices (e.g. 1,2,2), one process a device started "
                        "with COORDINATOR_ADDRESS, NUM_PROCESSES and "
                        "PROCESS_ID; empty = one device")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda (default) requires a GPU, cpu "
                        "runs the kernels' plain PyTorch versions")
    return p


# Flags gs2d_tpu's batch route refuses (gs2d_tpu/cli.py:129-136; several
# images with --mesh take the mesh route). Every other flag of the port
# applies to it.
BATCH_REFUSED = ("resume", "recover", "checkpoint_every", "ssim",
                 "reorder_every", "save_render_every")
# Flags the mesh route refuses: gs2d_tpu's (cli.py:290-294), and the opacity
# reset, which gs2d_tpu's fit_sharded does not apply.
MESH_REFUSED = ("reorder_every", "save_render_every", "recover",
                "opacity_reset_every")


def _mesh_shape(parser, text: str) -> tuple:
    try:
        shape = tuple(int(x) for x in text.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 3 or min(shape) < 1:
        parser.error(f"--mesh {text!r}: need three positive sizes D,T,S")
    return shape


def _fit_mesh(args, parser, cfg, refs, device, state0) -> int:
    """The mesh route (gs2d_tpu's ``--mesh``, cli.py:287-330): the images
    are the data axis, the fit ``parallel.sharded.fit_sharded`` with the
    statics ``prepare_config`` tunes from the init; rank 0 logs, writes the
    metrics, the checkpoints (global steps) and one render per image."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gs2d_tpu_torch.io.checkpoint import (Checkpointer, restore_sharded,
                                              save_sharded)
    from gs2d_tpu_torch.io.image import save_image
    from gs2d_tpu_torch.ops import render_dense as rdn
    from gs2d_tpu_torch.parallel.mesh import make_mesh
    from gs2d_tpu_torch.parallel.multihost import initialize_cluster
    from gs2d_tpu_torch.parallel.sharded import fit_sharded, prepare_config
    from gs2d_tpu_torch.train.loop import init_batched_state, state_index
    from gs2d_tpu_torch.utils.profiling import JsonlLogger

    data, tile, splat = _mesh_shape(parser, args.mesh)
    started = not dist.is_initialized()
    initialize_cluster(backend="gloo" if device.type == "cpu" else "nccl")
    try:
        mesh = make_mesh(data, tile, splat, devices=(
            None if dist.is_initialized() else [device]))
    except ValueError as e:
        parser.error(f"--mesh {args.mesh}: {e}")
    try:
        writer = mesh.is_writer
        say = print if writer else None
        if len(refs) % data:
            print(f"error: batch of {len(refs)} images does not divide over "
                  f"data axis {data}")
            return 2
        cfg = prepare_config(cfg, mesh, state0.params.to(mesh.device))
        if args.rebin_margin < 0 and say:
            say(f"rebin margin {cfg.rebin_margin} (auto)")
        state = init_batched_state(cfg, len(refs), mesh.device)
        ck = Checkpointer(os.path.join(args.out, "checkpoints")) \
            if (args.checkpoint_every or args.resume) else None
        start_iter = 0
        if args.resume:
            step, state = restore_sharded(ck, state, mesh)
            if step is None:
                print(f"error: --resume found no checkpoint under "
                      f"{ck.directory}")
                return 2
            start_iter = step
            if say:
                say(f"resumed from checkpoint step {step}")
        t0 = time.perf_counter()
        state, hist = fit_sharded(
            np.stack(refs), cfg, mesh, args.iters, state=state,
            log_every=args.log_every, log_fn=say, ssim_lambda=args.ssim,
            scan_chunk=args.scan_chunk, densify_every=args.densify_every,
            checkpoint_every=args.checkpoint_every,
            checkpoint_fn=(lambda s, it: save_sharded(
                ck, start_iter + it, s, mesh, cfg))
            if args.checkpoint_every else None,
            iter_offset=start_iter)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        total = time.perf_counter() - t0
        if ck is not None:
            save_sharded(ck, start_iter + args.iters, state, mesh, cfg)
        if not writer:
            return 0
        logger = JsonlLogger(os.path.join(args.out, "metrics.jsonl"))
        for rec in hist:
            logger.log(**rec)
        rate = args.iters / max(total, 1e-9)
        print(f"fit {args.iters} iters in {total:.2f}s ({rate:.1f} iters/s)")
        logger.log(event="done", seconds=total, iters_per_s=rate)
        logger.close()
        for i in range(len(refs)):
            with torch.no_grad():
                img = rdn.render(state_index(state, i).params, cfg)
            name = "render_final.png" if len(refs) == 1 \
                else f"render_final_{i:02d}.png"
            save_image(os.path.join(args.out, name), img.cpu().numpy())
        print(f"done (sharded over {mesh.shape})")
        return 0
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _fit_batch(args, cfg, refs, device, logger, dump_render) -> int:
    """The several-image fit (gs2d_tpu's ``_fit_batch``, cli.py:108-205):
    one population per image, the binning statics tuned on the shared
    init. With ``--densify-every`` ``train.densify.fit_adaptive_batched``,
    else ``train.loop.fit_batched`` (scanned with ``--scan-chunk`` > 1,
    else eager). Unlike gs2d_tpu it reports the pairs dropped to capacity
    caps and renders ``render_final_<i>.png`` with the fit's tuned cfg."""
    import torch

    from gs2d_tpu_torch.train.densify import fit_adaptive_batched
    from gs2d_tpu_torch.train.loop import fit_batched, state_index

    t0 = time.perf_counter()
    if args.densify_every:
        state, hist, cfg = fit_adaptive_batched(
            refs, cfg, args.iters, args.densify_every, device,
            scan_chunk=max(args.scan_chunk, 1), log_every=args.log_every,
            opacity_reset_every=args.opacity_reset_every)
    else:
        state, hist = fit_batched(refs, cfg, args.iters, device,
                                  scan_chunk=args.scan_chunk,
                                  log_every=args.log_every)
    for rec in hist:
        logger.log(**rec)
    dropped = sum(rec.get("window_drops", 0) for rec in hist)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    total = time.perf_counter() - t0
    rate = args.iters / max(total, 1e-9)
    print(f"fit {len(refs)} images x {args.iters} iters in {total:.2f}s "
          f"({rate:.1f} batched iters/s); {dropped} splat-tile pairs "
          "dropped")
    logger.log(event="done", seconds=total, iters_per_s=rate,
               n_dropped=dropped)
    for i in range(len(refs)):
        dump_render(state_index(state, i).params,
                    f"render_final_{i:02d}.png", cfg)
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for flag in ("reorder_every", "checkpoint_every", "save_render_every",
                 "scan_chunk", "densify_every", "opacity_reset_every"):
        if getattr(args, flag) < 0:
            parser.error(f"--{flag.replace('_', '-')} must be >= 0")
    batch = len(args.image) > 1 and not args.mesh
    if args.mesh:
        _mesh_shape(parser, args.mesh)
        for flag in MESH_REFUSED:
            if getattr(args, flag):
                parser.error(f"--{flag.replace('_', '-')} is not supported "
                             "on the mesh path")
    if batch:
        # gs2d_tpu's batch route refuses what it would ignore (cli.py:129-136).
        for flag in BATCH_REFUSED:
            if getattr(args, flag):
                parser.error(f"--{flag.replace('_', '-')} is not supported "
                             "with several images (the batched fit)")
    # gs2d_tpu's routes: fit_adaptive, or the block route where the flags
    # fit_adaptive cannot honour ask for fit's modular blocks.
    modular = bool(args.densify_every and (args.ssim or args.checkpoint_every))
    adaptive = bool(args.densify_every) and not modular
    # The flags each route would ignore in gs2d_tpu are refused here.
    if args.opacity_reset_every:
        if not args.densify_every:
            parser.error("--opacity-reset-every needs --densify-every")
        if not args.optimize_opacity:
            parser.error("--opacity-reset-every needs --optimize-opacity "
                         "(opacity is frozen without it)")
        if modular:
            parser.error("--opacity-reset-every is not applied on the "
                         "modular densify route (--ssim / --checkpoint-every)")
    if args.densify_every and args.recover:
        parser.error("--recover fits without densify: drop --densify-every")
    if adaptive and args.save_render_every:
        parser.error("--save-render-every is not applied on the fit_adaptive "
                     "route of --densify-every (add --checkpoint-every for "
                     "the modular route)")

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print(f"error: --device {args.device} but no CUDA GPU is visible; "
              "pass --device cpu to run the plain PyTorch kernels")
        return 2
    device = torch.device(args.device)

    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.io.checkpoint import Checkpointer
    from gs2d_tpu_torch.io.image import load_image, save_image
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_dense as rdn
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import render_resident as rr
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.train.densify import (densify_and_prune,
                                              fit_adaptive, l2_grad_mag)
    from gs2d_tpu_torch.train.loop import (fit, fit_with_recovery,
                                           init_train_state)
    from gs2d_tpu_torch.train.reorder import reorder_state
    from gs2d_tpu_torch.utils.profiling import JsonlLogger, ThroughputCounter

    refs = [load_image(path) for path in args.image]
    if any(r.shape != refs[0].shape for r in refs):
        print("error: multi-image batch fitting requires equal dimensions")
        return 2
    ref = refs[0]
    h, w = ref.shape[:2]
    cfg = SplatConfig(
        width=w, height=h, n_splats=args.splats,
        learning_rate=args.lr,
        lr_final=args.lr_final, lr_decay_iters=args.lr_decay_iters,
        optimize_opacity=args.optimize_opacity,
        use_exp_approx=not args.exact_exp,
        max_splats_per_tile=args.max_per_tile or None,
        binning=args.binning,
        # The modular (SSIM) path rebins every step, as in gs2d_tpu.
        rebin_margin=0.0 if args.ssim else args.rebin_margin,
        opacity_cull_alpha=args.opacity_cull,
    )
    state = init_train_state(cfg, device)  # the init ignores the tiling
    if args.tile_h:
        cfg = cfg.replace(tile_h=args.tile_h)
    else:
        # The deterministic init lets the policy measure the pair depth.
        cfg = tl.tune_tile_height(cfg, state.params)
    os.makedirs(args.out, exist_ok=True)
    if args.mesh:
        return _fit_mesh(args, parser, cfg, refs, device, state)
    layout = rd.resolve_binning(cfg)  # "auto" depends on the tile grid
    if cfg.rebin_margin < 0:
        # Before the capacities below are sized for the margin.
        cfg = tl.tune_rebin_margin(state.params, cfg)
        print(f"rebin margin {cfg.rebin_margin} (auto)")
    # Binning statics are tuned here rather than inside fit() so the final
    # render below uses the fit's config. The SSIM path keeps the default
    # per-tile capacity, as gs2d_tpu's does.
    if layout == "flat":
        cfg = rf.tune_flat_config(state.params, cfg)
    elif cfg.max_splats_per_tile is None and not args.ssim:
        cfg = tl.tune_tile_capacity(state.params, cfg)

    def dump_render(params, name: str, cfg=cfg) -> None:
        """The layout's forward kernel with the fit's config, as a PNG."""
        if layout == "flat":
            color, n_dropped = rf.render_flat(params, cfg)
        elif layout == "dense":
            color, n_dropped = rdn.render_dense(params, cfg,
                                                rd._max_per_tile(cfg))
        else:
            color, n_dropped = rr.render_resident(params, cfg,
                                                  rd._max_per_tile(cfg))
        if int(n_dropped) > 0:
            print(f"WARNING: render {name} dropped {int(n_dropped)} "
                  "splat-tile pairs to binning capacity")
        save_image(os.path.join(args.out, name), color.cpu().numpy())

    os.makedirs(args.out, exist_ok=True)
    if batch:
        logger = JsonlLogger(os.path.join(args.out, "metrics.jsonl"))
        try:
            return _fit_batch(args, cfg, refs, device, logger, dump_render)
        finally:
            logger.close()
    ck_dir = os.path.join(args.out, "checkpoints")
    ck = Checkpointer(ck_dir) \
        if (args.checkpoint_every or args.resume or args.recover) else None
    start_iter = 0
    if args.resume:
        step, state = ck.restore_latest(state)
        if step is None:
            # Starting over silently would discard the run the user asked
            # to continue (and overwrite its artifacts at the end).
            print(f"error: --resume found no checkpoint under {ck_dir}")
            return 2
        start_iter = step
        print(f"resumed from checkpoint step {step}")
    logger = JsonlLogger(os.path.join(args.out, "metrics.jsonl"))

    if args.recover:
        # As in gs2d_tpu: iterations are counted from the checkpoint
        # directory's newest step, --iters is the total, the step is modular.
        state, hist, n_rec = fit_with_recovery(
            ref, cfg, args.iters, ck, device,
            checkpoint_every=args.checkpoint_every or 100,
            log_every=args.log_every)
        for rec in hist:
            logger.log(**rec)
        dump_render(state.params, "render_final.png")
        print(f"done ({n_rec} recoveries)")
        logger.close()
        return 0

    tc = ThroughputCounter(h, w, args.splats)
    t_start = time.perf_counter()
    hist, done = [], start_iter
    end = start_iter + args.iters

    def on_ckpt(st, it):
        # ``it`` is block-relative (fit() restarts at 0 each block); ``done``
        # is the global iteration across blocks and resume.
        ck.save(done + it, st, cfg)

    if adaptive:
        # The densify signal is summed on the device inside the train step.
        state, h = fit_adaptive(
            ref, cfg, args.iters, args.densify_every, device, state=state,
            scan_chunk=args.scan_chunk, log_every=args.log_every,
            log_fn=print, reorder_every=args.reorder_every,
            opacity_reset_every=args.opacity_reset_every,
            iter_offset=start_iter)
        hist += h
        done = end
    elif modular:
        # fit_adaptive takes the fused L2 objective and no checkpoint hook.
        print("note: --densify-every with --ssim/--checkpoint-every uses "
              "the modular (non-fused) block path")
    # Renders are dumped, splats densified and reordered at block
    # boundaries, so every N-iteration cadence bounds the block size.
    block = args.iters
    for every in (args.densify_every, args.reorder_every,
                  args.save_render_every):
        if every:
            block = min(block, every)
    while done < end:
        n = min(block, end - done)
        state, h = fit(ref, cfg, n, device, state=state,
                       log_every=args.log_every, log_fn=print,
                       checkpoint_every=args.checkpoint_every,
                       checkpoint_fn=on_ckpt if args.checkpoint_every else None,
                       scan_chunk=args.scan_chunk, ssim_lambda=args.ssim,
                       iter_offset=done)
        hist += h
        done += n
        if done < end and args.densify_every \
                and done % args.densify_every == 0:
            ref_t = torch.as_tensor(ref, dtype=torch.float32, device=device)
            state = densify_and_prune(
                state, l2_grad_mag(state.params, ref_t, cfg), cfg, seed=done)
            print(f"densify/prune at iter {done}")
        if done < end and args.reorder_every \
                and done % args.reorder_every == 0:
            state = reorder_state(state, cfg)
            print(f"morton reorder at iter {done}")
        if args.save_render_every and done % args.save_render_every == 0:
            dump_render(state.params, f"render_{done:06d}.png")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    total = time.perf_counter() - t_start
    for rec in hist:
        logger.log(**rec)
    rates = tc.rates(total / max(args.iters, 1))
    print(f"fit {args.iters} iters in {total:.2f}s "
          f"({rates['iters_per_s']:.1f} iters/s)")
    logger.log(event="done", seconds=total, **rates)

    dump_render(state.params, "render_final.png")
    if ck is not None:
        ck.save(end, state, cfg)
    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
