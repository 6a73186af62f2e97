"""Hardware guard for the port's policy constants and allocation limits
(the counterpart of ``gs2d_tpu/utils/hardware.py``).

Two kinds of numbers depend on the card:

- **Allocation limits**, resolved through ``resolve_budget``: the shared
  memory one block may use, which bounds the per-tile capacity K of the
  resident kernels, the chunk of the MXU-form kernel and the steps of the
  contraction probe. The H100 table below takes the place of gs2d_tpu's
  v5e SMEM/VMEM budgets.
- **Policy constants** the port inherited from gs2d_tpu's sweeps on a TPU
  v5e and has NOT swept on any GPU: the binning-layout thresholds
  (``ops/render.py`` RESIDENT_THRESHOLD / FLAT_THRESHOLD and the resident
  byte budget), the saturating-walk gate (``ops/render.py``
  SAT_WALK_THRESHOLD) and the tile-height breakpoints
  (``ops/tiles.py::tune_tile_height``). They are kept so that both packages
  resolve a configuration alike; the H100 is the card the port was brought
  up and checked on with them.

This module does not re-derive anything (that needs sweeps); it makes the
hazard loud: the first time a policy is consulted on a CUDA device that is
not an H100, one warning names the constants. The CPU (tests, plain
versions) is exempt: policies there shape nothing that is allocated.
"""

from __future__ import annotations

import functools
import os
import warnings

# Device kinds (lowercased substrings of torch.cuda.get_device_name) the
# port's kernels and inherited policies were checked on.
MEASURED_KINDS = ("h100",)

_POLICY_CONSTANTS = (
    "ops/render.py RESIDENT_THRESHOLD/FLAT_THRESHOLD and the resident byte "
    "budget (binning layout)",
    "ops/render.py SAT_WALK_THRESHOLD (in-loop saturation exit gate)",
    "ops/tiles.py tune_tile_height breakpoints (DEEP_TILE_THRESHOLD pairs "
    "per 32-row tile, TALL_TILE_MIN_SPAN)",
)


@functools.lru_cache(maxsize=None)
def _device_kind() -> str:
    """Lowercased name of the current CUDA device, "cpu" without one."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(torch.cuda.current_device()).lower()


def _measured(kind: str) -> bool:
    return any(tag in kind for tag in MEASURED_KINDS)


@functools.lru_cache(maxsize=None)
def warn_if_untuned() -> bool:
    """Warn once when the inherited policy runs on a CUDA device other than
    the one the port was checked on. Returns True on that device and on the
    CPU, where the constants are harmless."""
    kind = _device_kind()
    if kind == "cpu" or _measured(kind):
        return True
    warnings.warn(
        f"policy constants were inherited from TPU v5e sweeps and checked "
        f"on an H100 only, but this device reports {kind!r}; re-sweep before "
        "trusting: " + "; ".join(_POLICY_CONSTANTS),
        stacklevel=3)
    return False


# --- allocation limits -------------------------------------------------------
#
# NVIDIA H100 (Hopper architecture white paper): a block may use 227 KB of
# the SM's 256 KB of shared memory, above 48 KB as dynamic shared memory.
# Env override (bytes): GS2D_SMEM_PER_BLOCK, the counterpart of gs2d_tpu's
# GS2D_SMEM_TABLE_BUDGET (renamed: it bounds a block's shared memory, not a
# whole-array SMEM table; the G-cache budget has no counterpart yet).

_H100_BUDGETS = {
    "smem_per_block": 232_448,
}

_ENV_KEYS = {"smem_per_block": "GS2D_SMEM_PER_BLOCK"}


def resolve_budget(name: str, measured_default: int) -> int:
    """Value of an allocation limit (bytes) for the current device.

    ``measured_default`` is the caller's own figure (for shared memory, what
    the CUDA runtime reports for the device); it is returned unchanged on an H100
    and on the CPU. The env override wins everywhere. Another CUDA device
    gets the smaller of the caller's figure and the H100 table's, the most
    the kernels were checked with, and the warning of warn_if_untuned."""
    env = os.environ.get(_ENV_KEYS.get(name, ""))
    if env:
        return int(env)
    kind = _device_kind()
    if kind == "cpu" or _measured(kind):
        return measured_default
    warn_if_untuned()
    return min(measured_default, _H100_BUDGETS[name])


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (a card may be set below
    its maximum and then runs slower, so the line goes beside every number
    measured on it); "cpu" for the CPU."""
    import subprocess

    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[index] if index < len(out) else out[0]
