"""Where the tensor-core moment probes 15b and 15c spend their time: each
built again from ``csrc/probes.cu`` with one part of its work taken out, and
timed beside the whole kernel on the card.

    python -m gs2d_tpu_torch.scripts.probe_parts

A part is taken out by removing its statements from a copy of the source
(``PARTS``; the tests check that every statement is still in
``csrc/probes.cu``). Such a variant computes wrong moments, so only its
time is read: at the probe script's shape (K = 512 steps, one block per
SM), the device time of a call (``scripts/roofline.py::time_ms``), every
variant and its whole kernel in turn, twice. A kernel takes the sum of its
parts' times when they do not overlap, and its longest part's when they
do. Without a GPU it exits 2.
"""

from __future__ import annotations

import argparse

# (kernel, part taken out, the statements that do it); kernel "15b" is
# gs2d_moments_tensor_cores, "15c" gs2d_moments_scratch_contraction.
PARTS = (
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
ENTRY = {"15b": "gs2d_moments_tensor_cores",
         "15c": "gs2d_moments_scratch_contraction"}


def variant_source(source: str, statements) -> str:
    """``source`` without ``statements`` (each must occur exactly once)."""
    for text in statements:
        if source.count(text) != 1:
            raise ValueError(f"not once in csrc/probes.cu: {text!r}")
        source = source.replace(text, "")
    return source


def build_variants(out_dir):
    """Compiles the whole source and every PARTS variant (one nvcc each, all
    at once) into ``out_dir``; returns their library paths, whole first."""
    import subprocess

    from gs2d_tpu_torch.ops import _build

    src = (_build.CSRC_DIR / "probes.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = [src] + [variant_source(src, stmts) for _, _, stmts in PARTS]
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
    libs = build_variants(_build.BUILD_DIR / "probe_parts")
    out = torch.empty((sms, TILE_W), dtype=torch.float32, device=device)

    def launcher(path, kernel):
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

    whole = {k: launcher(libs[0], k) for k in ENTRY}
    log(f"parts of 15b and 15c: K = {N_K}, {sms} blocks, device ms a call "
        f"[{card}]")
    for rnd in range(2):
        for (kernel, part, _), lib in zip(PARTS, libs[1:]):
            ms_all = time_ms(whole[kernel], reps, device)
            ms_part = time_ms(launcher(lib, kernel), reps, device)
            log(f"  {kernel} without {part}: {ms_part:.4f} ms (whole "
                f"{ms_all:.4f} ms; round {rnd + 1}) [{card}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
