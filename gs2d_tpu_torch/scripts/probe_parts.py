"""Where the moment probes 15a, 15b and 15c spend their time: each built
again from ``csrc/probes.cu`` with one part of its work taken out, and
timed beside the whole kernel on the card; and 15a at each step batch G
its butterfly may take.

    python -m gs2d_tpu_torch.scripts.probe_parts

A part is taken out by removing its statements from a copy of the source,
or by putting a cheaper one in their place (``PARTS``; the tests check that
every statement is still in ``csrc/probes.cu``). Such a variant computes
wrong moments, so only its time is read. 15a at another G
(``BATCHES``, ``batch_source``) computes the same moments bit for bit,
which is checked. At the probe script's shape (K = 512 steps, one block per
SM), the device time of a call (``scripts/roofline.py::time_ms``), every
variant and its whole kernel in turn, twice. A kernel takes the sum of its
parts' times when they do not overlap, and its longest part's when they
do. Without a GPU it exits 2.
"""

from __future__ import annotations

import argparse
import re

# (kernel, part taken out, the statements that do it: each removed, or a
# pair (statement, what takes its place)); kernel "15a" is
# gs2d_moments_cuda_cores, "15b" gs2d_moments_tensor_cores, "15c"
# gs2d_moments_scratch_contraction.
PARTS = (
    # The values are added into the thread's sum instead (fold_into: one
    # FADD a value), so the arithmetic that makes them stays: 15a's
    # arithmetic and those adds.
    ("15a", "its reduction over the lanes",
     (("      butterfly_to_round(v, red_w + kk * kMoments);\n",
       "      fold_into(v, acc);\n"),
      ("      butterfly_to_round(t, red_w + kk * kMoments);\n",
       "      fold_into(t, acc);\n"))),
    # One warp's row is read where the sixteen were summed.
    ("15a", "the round close's cross-warp sum",
     (("close_round_steps<kMoments, kWarps>(",
       "close_round_steps<kMoments, 1>("),)),
    ("15b", "its tensor-core products",
     ("        wgmma_m64n16k8_rs(d1[s], a_hi[s], b_desc[s], 0);\n",
      "        wgmma_m64n8k8_rs(d2[s], a_lo[s], b_desc[s], 0);\n")),
    ("15c", "the consumer's products",
     ("        contract_chunk(acc, st0 + st * kStageBytes);\n",)),
    ("15c", "the producers' planes and V^T",
     ("        cr = kv == kPlanes ? produce_planes<false>(cr, k0, kv, a_hi, "
      "a_lo, sw)\n"
      "                           : produce_planes<true>(cr, k0, kv, a_hi, "
      "a_lo, sw);\n",
      "          b_hi[n * kBlockPx + sw[n & 7]] = hi;\n",
      "          b_lo[n * kBlockPx + sw[n & 7]] = lo;\n")),
    ("15c", "the stores of A lo", ("    a_lo[m * kBlockPx + sw[m & 7]] = lo;\n",)),
    ("15c", "the stores of V^T",
     ("          b_hi[n * kBlockPx + sw[n & 7]] = hi;\n",
      "          b_lo[n * kBlockPx + sw[n & 7]] = lo;\n")),
)
ENTRY = {"15a": "gs2d_moments_cuda_cores",
         "15b": "gs2d_moments_tensor_cores",
         "15c": "gs2d_moments_scratch_contraction"}
# The step batches G that 15a's butterfly may take: they divide kRound.
BATCHES = (1, 2, 4)
_BATCH_LINE = re.compile(r"constexpr int kStepBatch = (\d+);")


def variant_source(source: str, statements) -> str:
    """``source`` with ``statements`` taken out (each must occur exactly
    once): a string is removed, a pair (statement, replacement) replaced."""
    for item in statements:
        text, new = (item, "") if isinstance(item, str) else item
        if source.count(text) != 1:
            raise ValueError(f"not once in csrc/probes.cu: {text!r}")
        source = source.replace(text, new)
    return source


def source_batch(source: str) -> int:
    """15a's step batch G in ``source`` (csrc/probes.cu kStepBatch)."""
    found = _BATCH_LINE.findall(source)
    if len(found) != 1:
        raise ValueError("csrc/probes.cu sets kStepBatch not once")
    return int(found[0])


def batch_source(source: str, batch: int) -> str:
    """``source`` with 15a's step batch set to ``batch``."""
    source_batch(source)
    return _BATCH_LINE.sub(f"constexpr int kStepBatch = {batch};", source)


def variants(src: str) -> list:
    """(kernel, label, source, exact) of every variant: the PARTS, then 15a
    at each of BATCHES but the source's own (exact: its output must equal
    the whole kernel's bit for bit)."""
    own = source_batch(src)
    return ([(kernel, f"without {part}", variant_source(src, stmts), False)
             for kernel, part, stmts in PARTS]
            + [("15a", f"at G = {g} (the source's G = {own})",
                batch_source(src, g), True) for g in BATCHES if g != own])


def build_variants(out_dir, sources):
    """Compiles the whole source and ``sources`` (one nvcc each, all at
    once) into ``out_dir``; returns their library paths, whole first."""
    import subprocess

    from gs2d_tpu_torch.ops import _build

    src = (_build.CSRC_DIR / "probes.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = [src, *sources]
    libs, procs = [], []
    for i, text in enumerate(sources):
        cu, lib = out_dir / f"probes_{i}.cu", out_dir / f"probes_{i}.so"
        cu.write_text(text)
        cmd = [_build.toolkit_binary("nvcc"), *_build.NVCC_FLAGS, "-shared",
               "-I", str(_build.CSRC_DIR), "-o", str(lib), str(cu)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
        libs.append(lib)
    for cmd, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{log}")
    return libs


def main(argv=None, log=print, reps: int = 20) -> int:
    ap = argparse.ArgumentParser(prog="gs2d_tpu_torch.scripts.probe_parts",
                                 description=__doc__.splitlines()[0])
    ap.parse_args(argv)

    import ctypes

    import torch

    if not torch.cuda.is_available():
        log("error: no CUDA GPU is visible; the variants run only on the "
            "card")
        return 2
    from gs2d_tpu_torch.ops import _build
    from gs2d_tpu_torch.ops.probes import N_K, TILE_W
    from gs2d_tpu_torch.scripts.roofline import time_ms
    from gs2d_tpu_torch.utils.hardware import card_line

    device = torch.device("cuda")
    card = card_line(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    todo = variants((_build.CSRC_DIR / "probes.cu").read_text())
    libs = build_variants(_build.BUILD_DIR / "probe_parts",
                          [text for _, _, text, _ in todo])

    def launcher(path, kernel, out):
        fn = getattr(ctypes.CDLL(str(path)), ENTRY[kernel])
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call():
            err = fn(out.data_ptr(), None, N_K, sms,
                     torch.cuda.current_stream(device).cuda_stream)
            if err:
                raise RuntimeError(f"{ENTRY[kernel]} variant: CUDA error "
                                   f"{err}")
        return call

    def output(call, out):
        call()
        torch.cuda.synchronize(device)
        return out.clone()

    outs = [torch.empty((sms, TILE_W), dtype=torch.float32, device=device)
            for _ in range(2)]
    whole = {k: launcher(libs[0], k, outs[0]) for k in ENTRY}
    log(f"parts of 15a, 15b and 15c, 15a at other step batches: K = {N_K}, "
        f"{sms} blocks, device ms a call [{card}]")
    for (kernel, label, _, exact), lib in zip(todo, libs[1:]):
        if exact:
            want = output(whole[kernel], outs[0])
            got = output(launcher(lib, kernel, outs[1]), outs[1])
            if not torch.equal(got, want):
                raise AssertionError(f"{kernel} {label} differs from the "
                                     "whole kernel")
            log(f"  {kernel} {label}: equal to the whole kernel bit for "
                "bit")
    for rnd in range(2):
        for (kernel, label, _, _), lib in zip(todo, libs[1:]):
            ms_all = time_ms(whole[kernel], reps, device)
            ms_part = time_ms(launcher(lib, kernel, outs[1]), reps, device)
            log(f"  {kernel} {label}: {ms_part:.4f} ms (whole "
                f"{ms_all:.4f} ms; round {rnd + 1}) [{card}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
