"""Checkpoint / resume (the counterpart of ``gs2d_tpu/io/checkpoint.py``,
npz backend).

The reference keeps all fitting state in RAM and can only restart from
scratch (main.cpp:828-831). The resume contract is the exact state list the
reference would need: splat parameters, the per-parameter Adam moments, the
running bias-correction powers beta1t/beta2t, and the iteration count
(main.cpp:271-278).

The file format is gs2d_tpu's own, key for key, so a checkpoint written by
either package loads into the other: ``leaf_0 ... leaf_20`` in the order
``jax.tree.flatten(TrainState)`` gives (``LEAF_ORDER`` below), plus
``config_json``, the config's fields as JSON bytes. gs2d_tpu's orbax
backend is not ported (ROADMAP.md, "Deliberately not ported"): files are
single ``step_{n}.npz`` archives, written atomically.

Under a mesh (``parallel/``) a checkpoint is the whole batched state in the
same format: ``save_sharded`` writes it from rank 0, every rank holding it
whole (``parallel.sharded.gather_state``), and ``restore_sharded`` reads it
on rank 0 and sends it to every rank, whatever the world size and the mesh
it was saved from; ``fit_sharded`` then keeps each rank's shard.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.params import FIELDS
from gs2d_tpu_torch.train.loop import TrainState
from gs2d_tpu_torch.train.loop import state_from_leaves as _from_leaves
from gs2d_tpu_torch.train.loop import state_leaves as _leaves

# The leaves of gs2d_tpu's TrainState in jax.tree.flatten order: params,
# then opt.m, opt.v (each in FIELDS order), beta1t, beta2t (0-d float32),
# step (0-d int32). tests/test_torch_checkpoint.py proves it against JAX.
LEAF_ORDER = tuple(
    [("params", f) for f in FIELDS] + [("opt.m", f) for f in FIELDS]
    + [("opt.v", f) for f in FIELDS]
    + [("opt", "beta1t"), ("opt", "beta2t"), ("opt", "step")])


def save_npz(path: str, state: TrainState,
             cfg: Optional[SplatConfig] = None):
    """Write the full train state (and config) to a single .npz file,
    atomically: a reader never sees half a file."""
    payload = {f"leaf_{i}": x.detach().cpu().numpy()
               for i, x in enumerate(_leaves(state))}
    if cfg is not None:
        payload["config_json"] = np.frombuffer(
            json.dumps(cfg.__dict__).encode(), dtype=np.uint8)
    tmp = path + ".tmp.npz"  # np.savez appends .npz to any other ending
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_npz(path: str, like: TrainState) -> TrainState:
    """The state in ``path``, each leaf with the dtype and on the device of
    its counterpart in ``like``."""
    with np.load(path) as z:
        return _from_leaves([
            torch.as_tensor(z[f"leaf_{i}"]).to(device=x.device, dtype=x.dtype)
            for i, x in enumerate(_leaves(like))])


def load_npz_config(path: str) -> Optional[SplatConfig]:
    with np.load(path) as z:
        if "config_json" not in z:
            return None
        raw = json.loads(bytes(z["config_json"]).decode())
        return SplatConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in raw.items()})


class Checkpointer:
    """Directory-based checkpoint manager with step retention: files named
    ``step_{n}.npz``, the newest ``keep`` kept."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.npz")

    def save(self, step: int, state: TrainState,
             cfg: Optional[SplatConfig] = None):
        save_npz(self._path(step), state, cfg)
        for s in self.all_steps()[: -self.keep]:
            os.remove(self._path(s))

    def all_steps(self) -> list:
        out = []
        for f in os.listdir(self.directory):
            if f.startswith("step_") and f.endswith(".npz") \
                    and f[len("step_"):-len(".npz")].isdigit():
                out.append(int(f[len("step_"):-len(".npz")]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: TrainState) -> TrainState:
        """The state of ``step``, on the device of ``like``'s leaves."""
        return load_npz(self._path(step), like)

    def restore_latest(self, like: TrainState):
        """(step, state) of the newest checkpoint; (None, ``like``) when the
        directory holds none."""
        step = self.latest_step()
        if step is None:
            return None, like
        return step, self.restore(step, like)


def save_sharded(checkpointer: "Checkpointer", step: int, state: TrainState,
                 mesh, cfg: Optional[SplatConfig] = None) -> None:
    """Save the whole batched ``state`` (every rank holds it) from the
    mesh's writer, rank 0; the other ranks wait until it is written."""
    if mesh.is_writer:
        checkpointer.save(step, state, cfg)
    if mesh.device_mesh is not None:
        import torch.distributed as dist

        dist.barrier()


def restore_sharded(checkpointer: "Checkpointer", like: TrainState, mesh):
    """(step, state) of the newest checkpoint, read on rank 0 and sent to
    every rank of the mesh (any world size or mesh shape); (None, ``like``)
    when there is none. ``like`` is the whole batched state's template (its
    devices and dtypes)."""
    if mesh.device_mesh is None:
        return checkpointer.restore_latest(like)
    import torch.distributed as dist

    payload = [None, None]
    if dist.get_rank() == 0:
        step = checkpointer.latest_step()
        if step is not None:
            with np.load(checkpointer._path(step)) as z:
                payload = [step, [z[f"leaf_{i}"]
                                  for i in range(len(LEAF_ORDER))]]
    dist.broadcast_object_list(payload, src=0)
    step, leaves = payload
    if step is None:
        return None, like
    return step, _from_leaves([
        torch.as_tensor(x).to(device=t.device, dtype=t.dtype)
        for x, t in zip(leaves, _leaves(like))])
