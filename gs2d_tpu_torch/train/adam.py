"""Reference-faithful Adam on the splat parameters (the counterpart of
``gs2d_tpu/train/adam.py``).

External bias-correction powers beta1t/beta2t multiplied *before* the
update each iteration (main.cpp:718-719), the exact formula
value - lr * m_hat / (sqrt(v_hat) + 1e-15) (main.cpp:144-156), the opacity
gate (main.cpp:735-738), the optional exponential lr decay, clamps
(main.cpp:740-749) and dead-slot freezing. Elementwise PyTorch, as the JAX
package left it to XLA; the state is replaced, not updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.params import (FIELDS, GaussianParams, clamp_params,
                                   freeze_dead_slots, params_from_numpy,
                                   params_to_numpy, zeros_like_params)


@dataclasses.dataclass
class AdamState:
    """First/second moments plus the running bias powers (0-d float32) and
    the step count (0-d int32), all on the parameters' device."""

    m: GaussianParams
    v: GaussianParams
    beta1t: torch.Tensor
    beta2t: torch.Tensor
    step: torch.Tensor


def init_adam_state(params: GaussianParams) -> AdamState:
    dev = params.device
    return AdamState(
        m=zeros_like_params(params),
        v=zeros_like_params(params),
        beta1t=torch.tensor(1.0, dtype=torch.float32, device=dev),
        beta2t=torch.tensor(1.0, dtype=torch.float32, device=dev),
        step=torch.tensor(0, dtype=torch.int32, device=dev),
    )


def adam_update(params: GaussianParams, grads: GaussianParams,
                state: AdamState, cfg: SplatConfig):
    """One optimizer step: bias powers, 9 per-splat Adam updates (opacity
    gated by cfg.optimize_opacity), then clamps. Returns (params, state)."""
    b1 = np.float32(cfg.adam_beta1)
    b2 = np.float32(cfg.adam_beta2)
    one_b1 = float(np.float32(1.0) - b1)
    one_b2 = float(np.float32(1.0) - b2)
    b1, b2 = float(b1), float(b2)
    dev = params.device
    # torch.full, not torch.tensor: fill kernels, where torch.tensor copies
    # from the host, which a CUDA graph of the step cannot capture.
    lr = torch.full((), cfg.learning_rate, dtype=torch.float32, device=dev)
    if cfg.lr_decay_iters > 0:
        # lr * (lr_final/lr)^(min(t, T)/T), from the step counter.
        frac = torch.clamp(state.step.to(torch.float32)
                           / np.float32(cfg.lr_decay_iters), max=1.0)
        ratio = torch.full((), cfg.lr_final / cfg.learning_rate,
                           dtype=torch.float32, device=dev)
        lr = lr * torch.pow(ratio, frac)
    eps = float(np.float32(cfg.adam_eps))
    beta1t = state.beta1t * b1
    beta2t = state.beta2t * b2

    def upd(value, g, m, v):
        m_new = b1 * m + one_b1 * g
        v_new = b2 * v + one_b2 * g * g
        m_hat = m_new / (1.0 - beta1t)
        v_hat = v_new / (1.0 - beta2t)
        return value - lr * m_hat / (torch.sqrt(v_hat) + eps), m_new, v_new

    new_p, new_m, new_v = {}, {}, {}
    for f in FIELDS:
        value, g = getattr(params, f), getattr(grads, f)
        m, v = getattr(state.m, f), getattr(state.v, f)
        if f == "opacity" and not cfg.optimize_opacity:
            # Value and moments untouched when the toggle is off.
            new_p[f], new_m[f], new_v[f] = value, m, v
        else:
            new_p[f], new_m[f], new_v[f] = upd(value, g, m, v)

    params = freeze_dead_slots(params,
                               clamp_params(GaussianParams(**new_p), cfg))
    return params, AdamState(
        m=GaussianParams(**new_m), v=GaussianParams(**new_v),
        beta1t=beta1t, beta2t=beta2t, step=state.step + 1)


def adam_state_from_numpy(d: Dict, device) -> AdamState:
    """The JAX package's AdamState as numpy: {"m": {field: array},
    "v": {...}, "beta1t", "beta2t", "step"} -> the port's AdamState."""
    return AdamState(
        m=params_from_numpy(d["m"], device),
        v=params_from_numpy(d["v"], device),
        beta1t=torch.tensor(np.float32(d["beta1t"]), device=device),
        beta2t=torch.tensor(np.float32(d["beta2t"]), device=device),
        step=torch.tensor(np.int32(d["step"]), device=device),
    )


def adam_state_to_numpy(s: AdamState) -> Dict:
    """The inverse of ``adam_state_from_numpy``."""
    return {
        "m": params_to_numpy(s.m), "v": params_to_numpy(s.v),
        "beta1t": np.float32(s.beta1t.item()),
        "beta2t": np.float32(s.beta2t.item()),
        "step": np.int32(s.step.item()),
    }
