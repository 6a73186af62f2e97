"""Build and load the port's CUDA kernels (``gs2d_tpu_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per source,
all started together) and links the objects into one shared library with a
plain C interface, which ``ctypes`` loads (no PyTorch headers, so a build
takes seconds). The library lands in ``gs2d_tpu_torch/_build/`` under
a name that carries a hash of the sources and flags, so any edit rebuilds
and an unchanged tree reuses the library. Nothing here runs at import time;
the kernel wrappers call ``library()`` on first launch. A failed build
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# -fmad=false: no FMA contraction, so the float32 operation order is the
# Pallas kernels' (and the plain twin's); no --use_fast_math, so division,
# sqrt and expf stay IEEE.
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                     "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C entry points and their argument types (csrc/render_resident.cu,
# csrc/render_flat.cu, csrc/render_dense.cu, csrc/render_mxu.cu,
# csrc/probes.cu, csrc/graph_cond.cu, csrc/tiles_flat.cu).
SIGNATURES = {
    "gs2d_l2_resident": [_P] * 8 + [_I] * 10 + [_F, _F, _I, _P],
    "gs2d_fwd_resident": [_P] * 6 + [_I] * 8 + [_F, _F, _I, _P],
    "gs2d_bwd_resident": [_P] * 10 + [_I] * 10 + [_F, _F, _I, _P],
    "gs2d_l2_window": [_P] * 9 + [_I] * 10 + [_F, _F, _I, _P],
    "gs2d_rows_per_thread": [],
    "gs2d_max_threads": [],
    "gs2d_max_smem_per_block": [],
    "gs2d_fwd_flat": [_P] * 8 + [_I] * 10 + [_F, _F, _I, _P],
    "gs2d_flat_nonfinite_mask": [_P, _P, _I, _P],
    "gs2d_bwd_flat": [_P] * 14 + [_I] * 11 + [_F, _F, _F, _I, _P],
    "gs2d_fwd_dense": [_P] * 5 + [_I] * 8 + [_F, _F, _I, _P],
    "gs2d_fwd_chunk": [_P] * 4 + [_I] * 9 + [_F, _F, _I, _P],
    "gs2d_bwd_dense": [_P] * 10 + [_I] * 9 + [_F, _F, _I, _P],
    "gs2d_bwd_chunk": [_P] * 9 + [_I] * 10 + [_F, _F, _I, _P],
    "gs2d_l2_dense": [_P] * 8 + [_I] * 9 + [_F, _F, _I, _P],
    "gs2d_l2_mxu": [_P] * 9 + [_I] * 8 + [_F, _F, _I, _P],
    "gs2d_l2_mxu_chunk": [_P] * 8 + [_I] * 9 + [_F, _F, _I, _P],
    "gs2d_fma_threads": [],
    "gs2d_fma_unroll": [],
    "gs2d_probe_batch": [],
    "gs2d_fma_peak": [_P, _I, _I, _I, _F, _F, _P],
    "gs2d_moments_cuda_cores": [_P, _P, _I, _I, _P],
    "gs2d_moments_cuda_cores_tree": [_P, _I, _I, _P],
    "gs2d_moments_tensor_cores": [_P, _P, _I, _I, _P],
    "gs2d_moments_tensor_cores_staged": [_P, _I, _I, _P],
    "gs2d_moments_scratch_contraction": [_P, _P, _I, _I, _P],
    "gs2d_moments_scratch_contraction_sync": [_P, _I, _I, _P],
    "gs2d_contraction_smem_bytes": [_I],
    "gs2d_contraction_sync_smem_bytes": [_I],
    "gs2d_graph_if": [_P, _P, _P],
    "gs2d_cudart_build_version": [],
    "gs2d_cudart_version": [],
    "gs2d_expand_count": [_P] * 6 + [_I] * 9 + [_F] * 3 + [_P],
    "gs2d_expand_emit": [_P] * 9 + [_I] * 11 + [_F] * 6 + [_P],
    "gs2d_expand_trig": [_P] * 3 + [_L, _P],  # verification only
}


def toolkit_binary(name: str) -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump)."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", name)):
            return os.path.join(home, "bin", name)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(
            f"{name} not found (set CUDA_HOME); the CUDA kernels are built "
            "from gs2d_tpu_torch/csrc at first use")
    return found


def _nvcc() -> str:
    return toolkit_binary("nvcc")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + cuh:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a library for this source hash exists;
    returns its path. ``<lib>.log`` keeps nvcc's ptxas report (registers,
    shared memory, spills per kernel)."""
    out = BUILD_DIR / f"libgs2d_kernels_{source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    cu, _ = _sources()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in cu]
    steps = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
             for src, obj in zip(cu, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in steps]
    logs = [proc.communicate()[0] for proc in procs]
    try:
        for cmd, proc, log in zip(steps, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{log}")
        link = [_nvcc(), *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(link)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, out)  # atomic: a concurrent build never loads half
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gs2d_error_string.argtypes = [ctypes.c_int]
    lib.gs2d_error_string.restype = ctypes.c_char_p
    return lib


def on_card(t) -> bool:
    """Whether a kernel wrapper launches its kernel for tensor ``t`` (CUDA)
    or runs its plain PyTorch version (CPU); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def stream(t) -> int:
    """The handle of PyTorch's current CUDA stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().gs2d_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
