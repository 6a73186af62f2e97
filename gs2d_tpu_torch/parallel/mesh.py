"""Device-mesh construction (the counterpart of ``gs2d_tpu/parallel/mesh.py``).

The fitter shards over up to three logical axes:

- ``data``:  independent target images, each with its own splat population
             (data parallel; no cross-talk)
- ``tile``:  horizontal bands of screen rows; per-splat gradients are summed
             over this axis
- ``splat``: contiguous index-ordered slices of the splat population;
             per-pixel (C, T) composite partials are combined in index order
             over this axis

A ``Mesh`` is either a process mesh, one ``torch.distributed`` rank per
device (``make_mesh``: a ``DeviceMesh`` over the default process group,
one process group per axis, ranks in row-major (data, tile, splat) order so
the splat axis is innermost), or a virtual mesh (``virtual_mesh``): one
process holds every coordinate on one device and the collectives are
computed in place, in index order, which is how the tests and
``chip_smoke.py`` run several bands and splat shards on one device. Both
carry the same ``comm`` (``parallel/sharded.py``'s collectives), so the
sharded step is one program for either.
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
TILE_AXIS = "tile"
SPLAT_AXIS = "splat"
AXES = (DATA_AXIS, TILE_AXIS, SPLAT_AXIS)


class Mesh:
    """A (data, tile, splat) mesh: ``shape`` (axis -> size, as gs2d_tpu's
    ``Mesh.shape``), the coordinates this process holds (``coords``, each a
    (d, t, s) tuple), its device, and ``comm``, the collectives over the
    coordinates. ``device_mesh`` is the torch ``DeviceMesh`` of a process
    mesh, None for a virtual one."""

    def __init__(self, data: int, tile: int, splat: int, coords, device,
                 device_mesh=None):
        from gs2d_tpu_torch.parallel.sharded import DistComm, VirtualComm

        self.shape = {DATA_AXIS: data, TILE_AXIS: tile, SPLAT_AXIS: splat}
        self.coords = list(coords)
        self.device = torch.device(device)
        self.device_mesh = device_mesh
        self.comm = (VirtualComm(self) if device_mesh is None
                     else DistComm(self))

    @property
    def size(self) -> int:
        return (self.shape[DATA_AXIS] * self.shape[TILE_AXIS]
                * self.shape[SPLAT_AXIS])

    def rank_of(self, coord) -> int:
        """The rank of coordinate (d, t, s): row-major, splat innermost."""
        d, t, s = coord
        return (d * self.shape[TILE_AXIS] + t) * self.shape[SPLAT_AXIS] + s

    def coord_of(self, rank: int) -> tuple:
        s = rank % self.shape[SPLAT_AXIS]
        t = rank // self.shape[SPLAT_AXIS] % self.shape[TILE_AXIS]
        return (rank // (self.shape[SPLAT_AXIS] * self.shape[TILE_AXIS]), t,
                s)

    @property
    def is_writer(self) -> bool:
        """Whether this process writes what the whole mesh shares (files,
        the log): rank 0, or the process of a virtual mesh."""
        return self.device_mesh is None or dist.get_rank() == 0

    def __repr__(self) -> str:
        kind = "virtual" if self.device_mesh is None else "process"
        return (f"Mesh({kind}, data={self.shape[DATA_AXIS]}, "
                f"tile={self.shape[TILE_AXIS]}, "
                f"splat={self.shape[SPLAT_AXIS]}, device={self.device})")


def local_device(backend: Optional[str] = None) -> torch.device:
    """This rank's device: the CPU under gloo, else ``cuda:<local rank>``
    (under NCCL, and by default where no process group is up). The local
    rank is ``LOCAL_RANK`` where set, else the rank modulo the visible
    GPUs. Raises where that needs a GPU and none is visible."""
    if backend is None and dist.is_initialized():
        backend = dist.get_backend()
    if backend == "gloo":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; for the CPU start a gloo process "
            "group (multihost.initialize_cluster(backend='gloo')) or pass "
            "devices=['cpu']")
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK",
                               rank % max(torch.cuda.device_count(), 1)))
    return torch.device("cuda", local)


def _indexed(device) -> torch.device:
    """``device`` with its index: the current CUDA device for a bare
    "cuda"."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _world_of_one(device: torch.device) -> None:
    """Start a process group of this process alone (NCCL for a CUDA device,
    gloo for the CPU) at a free localhost port."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)


def make_mesh(data: int = 1, tile: int = 1, splat: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A process mesh of (data, tile, splat) over the ranks of the default
    process group (``multihost.initialize_cluster``), one device a rank:
    ``devices[rank]`` where given, else ``local_device()``. The axis sizes
    must multiply to the world size, as gs2d_tpu's must to the device
    count; with no process group a one-device mesh starts a world of this
    process alone, so it too runs through the real collectives."""
    n = data * tile * splat
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"need {n} devices, have 1 (start {n} "
                             "processes: multihost.initialize_cluster)")
        dev = _indexed(devices[0]) if devices else local_device(None)
        _world_of_one(dev)
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} devices, have {world}")
    if world != n:
        raise ValueError(f"a mesh of {n} devices on a world of {world} "
                         "ranks: the axis sizes must multiply to the world")
    rank = dist.get_rank()
    dev = _indexed(devices[rank]) if devices else local_device()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (data, tile, splat), mesh_dim_names=AXES)
    mesh = Mesh(data, tile, splat, [], dev, dm)
    mesh.coords = [mesh.coord_of(rank)]
    return mesh


def virtual_mesh(data: int = 1, tile: int = 1, splat: int = 1,
                 device="cuda") -> Mesh:
    """A (data, tile, splat) mesh whose every coordinate this one process
    holds on ``device`` (the card unless the caller asks for the CPU), the
    collectives computed in place in index order (the port's counterpart of
    the JAX tests' virtual CPU devices)."""
    m = Mesh(data, tile, splat, [], device)
    m.coords = [m.coord_of(r) for r in range(m.size)]
    return m


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1, 1)
