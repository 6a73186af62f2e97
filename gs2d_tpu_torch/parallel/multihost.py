"""Multi-process runtime setup (the counterpart of
``gs2d_tpu/parallel/multihost.py``).

One process per device; ``initialize_cluster`` starts the default
``torch.distributed`` process group (NCCL between GPUs, gloo on the CPU),
after which ``mesh.make_mesh`` lays the (data, tile, splat) mesh over its
ranks. Axis placement as in gs2d_tpu: the splat axis innermost (its ordered
combine talks to neighbours), data outermost (its images never talk), the
tile axis's gradient all-reduce (36 bytes a splat a step) in between.

The state is held whole on every rank between steps (``put_global`` takes a
rank's shard of it, ``fetch_replicated`` gathers a shard back), as
gs2d_tpu's ``put_global`` builds each global array from a host value every
process holds.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gs2d_tpu_torch.parallel.mesh import AXES, local_device, make_mesh


def initialize_cluster(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       backend: Optional[str] = None) -> None:
    """Start the default process group from the arguments or the variables
    gs2d_tpu reads (COORDINATOR_ADDRESS host:port, NUM_PROCESSES,
    PROCESS_ID): ``backend`` "nccl" (the default; each rank on
    ``cuda:<local rank>``) or "gloo" (the CPU). Does nothing for a single
    process (no address and no count) or when the group is already up."""
    if dist.is_initialized():
        return
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr is None and num_processes is None:
        return  # single-process run
    world = num_processes or int(os.environ.get("NUM_PROCESSES", "1"))
    rank = process_id if process_id is not None \
        else int(os.environ.get("PROCESS_ID", "0"))
    backend = backend or "nccl"
    if backend == "nccl":
        os.environ.setdefault("LOCAL_RANK",
                              str(rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local_device("nccl"))
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=world, rank=rank)


def shard_index(mesh, coord, spec, shape) -> tuple:
    """The slices of coordinate ``coord``'s shard of a leaf of ``shape``
    whose dimension i is split over the mesh axis ``spec[i]`` (None: not
    split)."""
    out = []
    for n, axis in zip(shape, spec):
        if axis is None:
            out.append(slice(None))
        else:
            k = n // mesh.shape[axis]
            i = coord[AXES.index(axis)]
            out.append(slice(i * k, (i + 1) * k))
    return tuple(out)


def put_global(leaves, specs, mesh, device=None) -> dict:
    """Each coordinate's shard of leaves that every process holds whole
    (gs2d_tpu's ``put_global``): ``leaves`` are tensors or arrays, ``specs``
    their splits, one mesh axis or None a dimension (sharded.state_pspec,
    ref_pspec). Returns {coord: [shard leaves]} on ``device`` (the
    mesh's)."""
    device = mesh.device if device is None else device
    leaves = [x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
              for x in leaves]
    return {c: [x[shard_index(mesh, c, spec, x.shape)].to(device).contiguous()
                for x, spec in zip(leaves, specs)] for c in mesh.coords}


def gather_leaves(shards: dict, specs, mesh) -> dict:
    """{coord: the leaves gathered from the coordinates' shards}: each
    dimension gathered over the axis ``specs`` names for it, innermost axis
    first (the inverse of ``put_global`` over those axes)."""
    out = {c: [] for c in shards}
    for i, spec in enumerate(specs):
        xs = {c: v[i] for c, v in shards.items()}
        for axis in reversed(AXES):
            if axis in spec:
                xs = {c: torch.cat(g, dim=spec.index(axis))
                      for c, g in mesh.comm.all_gather(axis, xs).items()}
        for c in out:
            out[c].append(xs[c])
    return out


def fetch_replicated(shards: dict, specs, mesh) -> list:
    """The whole leaves from every coordinate's shards (the inverse of
    ``put_global``), on every process; the copies along an axis a leaf is
    not split over are equal. Returns the leaves on the mesh's device."""
    return gather_leaves(shards, specs, mesh)[mesh.coords[0]]


def default_pod_mesh(data: int = 1, tile: Optional[int] = None,
                     splat: Optional[int] = None):
    """A mesh over every rank of the cluster (gs2d_tpu's default): splat
    innermost, then tile, data outermost; without sizes, splat and tile
    split the ranks evenly."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if tile is None and splat is None:
        splat = 1
        while splat * splat * data <= n and n % (splat * 2 * data) == 0:
            splat *= 2
        tile = n // (data * splat)
    elif splat is None:
        splat = n // (data * tile)
    elif tile is None:
        tile = n // (data * splat)
    return make_mesh(data=data, tile=tile, splat=splat)

