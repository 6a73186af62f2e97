"""One rank of a gloo cluster running the port's sharded fit on the CPU.

Launched by tests/test_torch_sharded.py, one process a rank. Imports only
torch and gs2d_tpu_torch. Phases:

- ``fit_save``: ``fit_sharded`` in scanned blocks (``parallel.sharded.
  _Blocks``, as on every mesh) over a process mesh of the given shape (the
  collectives cross processes), held bit for bit against the same fit on a
  virtual mesh of that shape computed in this process; with ``save`` the
  whole batched state is checkpointed at step 3 (rank 0 writes).
- ``restore_check``: restore that checkpoint on this cluster (another world
  size and mesh), check it bit for bit against the saving cluster's fit
  recomputed on a virtual mesh of its shape, then fit two more steps and
  hold them bit for bit against the virtual mesh of this cluster's shape.

argv: port pid nproc ckdir combine phase data tile splat [saved D,T,S]
Prints MP_WORKER_OK and the last MSE on success; any failure kills the exit
code.
"""

import sys

port, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
ckdir, combine, phase = sys.argv[4], sys.argv[5], sys.argv[6]
shape = tuple(int(x) for x in sys.argv[7:10])
saved = tuple(int(x) for x in sys.argv[10].split(",")) \
    if len(sys.argv) > 10 else None

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from gs2d_tpu_torch.config import SplatConfig  # noqa: E402
from gs2d_tpu_torch.io.checkpoint import (Checkpointer,  # noqa: E402
                                          restore_sharded, save_sharded)
from gs2d_tpu_torch.io.image import synthetic_target  # noqa: E402
from gs2d_tpu_torch.parallel.mesh import make_mesh, virtual_mesh  # noqa
from gs2d_tpu_torch.parallel.multihost import initialize_cluster  # noqa
from gs2d_tpu_torch.parallel.sharded import (_Blocks,  # noqa: E402
                                             fit_sharded,
                                             make_fit_scan_sharded)
from gs2d_tpu_torch.train.loop import (init_batched_state,  # noqa: E402
                                       state_leaves)

initialize_cluster(coordinator_address=f"127.0.0.1:{port}",
                   num_processes=nproc, process_id=pid, backend="gloo")
mesh = make_mesh(*shape)
assert mesh.coords == [mesh.coord_of(pid)], mesh.coords

H, W = 32, 64
cfg = SplatConfig(width=W, height=H, n_splats=64, min_throughput=0.0,
                  max_splats_per_tile=64, binning="resident",
                  rebin_margin=2.0)
refs = np.stack([synthetic_target(H, W, seed=d) for d in range(shape[0])])
kw = dict(log_every=1, log_fn=None, combine=combine, scan_chunk=3)
# The scanned blocks of a process mesh: the one block class of every mesh,
# its step's collectives over gloo.
assert type(make_fit_scan_sharded(cfg, mesh)[0]) is _Blocks


def same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in
               zip(state_leaves(a), state_leaves(b)))


ck = Checkpointer(ckdir)
if phase == "fit_save":
    state, hist = fit_sharded(
        refs, cfg, mesh, 3, checkpoint_every=3,
        checkpoint_fn=lambda s, it: save_sharded(ck, it, s, mesh, cfg),
        **kw)
    want, want_hist = fit_sharded(refs, cfg, virtual_mesh(*shape, "cpu"), 3,
                                  **kw)
    assert same_bits(state, want), "process mesh != virtual mesh"
    assert [r["mse"] for r in hist] == [r["mse"] for r in want_hist]
    assert ck.latest_step() == 3
else:
    assert phase == "restore_check", phase
    refs_saved = np.stack([synthetic_target(H, W, seed=d)
                           for d in range(saved[0])])
    template = init_batched_state(cfg, shape[0], mesh.device)
    step, state = restore_sharded(ck, template, mesh)
    assert step == 3, step
    was, _ = fit_sharded(refs_saved, cfg, virtual_mesh(*saved, "cpu"), 3,
                         **kw)
    assert same_bits(state, was), "restored != the saving cluster's fit"
    state, hist = fit_sharded(refs, cfg, mesh, 2, state=state, **kw)
    want, want_hist = fit_sharded(refs, cfg, virtual_mesh(*shape, "cpu"), 2,
                                  state=was, **kw)
    assert same_bits(state, want), "resumed process mesh != virtual mesh"
    assert [r["mse"] for r in hist] == [r["mse"] for r in want_hist]
print(f"MP_WORKER_OK p{pid} phase={phase} mse={hist[-1]['mse'][0]:.6f}",
      flush=True)
