"""The port's sharded fit (gs2d_tpu_torch/parallel/) against gs2d_tpu's.

- Every mesh of ``tests/test_sharding.py::MESHES``: the port's
  ``fit_sharded`` on a virtual mesh (one process holds every coordinate)
  against gs2d_tpu's ``fit_sharded(renderer="pallas")`` on the 8-device
  virtual CPU mesh of tests/conftest.py, from the same init and target, at
  the JAX tests' tolerances (tests/test_sharding.py:49-101: parameters after
  three Adam steps at lr 0.05 within atol 2e-2, rtol 1e-4; MSE rtol 1e-3).
- Three gloo clusters (tests/_torch_mp_worker.py, one process a rank, 120 s
  each at most): 2 ranks on tile=2; 4 ranks on tile=2, splat=2 with the
  scan combine, saving a checkpoint; 2 ranks restoring it on another mesh.
  Each holds the process mesh bit for bit against the virtual mesh of its
  shape, as tests/test_multiprocess.py holds its clusters.

tests/test_torch_sharded_parts.py holds the layouts, the options and the
band arguments of the kernels and the binning.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.io.image import synthetic_target
from gs2d_tpu.parallel.mesh import make_mesh as jax_mesh
from gs2d_tpu.parallel.sharded import fit_sharded as jax_fit_sharded
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.parallel.mesh import virtual_mesh
from gs2d_tpu_torch.parallel.sharded import fit_sharded
from gs2d_tpu_torch.params import FIELDS
from tests.test_sharding import MESHES

H, W = 32, 64


def mesh_id(axes) -> str:
    return "x".join(f"{k}{v}" for k, v in axes.items())


def both_fits(axes, iters=3, **kw):
    """(gs2d_tpu's, the port's) (state, history) of fit_sharded on the mesh
    ``axes`` from the same deterministic init and targets."""
    kw = dict(width=W, height=H, n_splats=64, min_throughput=0.0,
              max_splats_per_tile=64, **kw)
    refs = np.stack([synthetic_target(H, W)] * axes["data"])
    jax_out = jax_fit_sharded(refs, JaxConfig(**kw), jax_mesh(**axes),
                              iterations=iters, log_every=1, log_fn=None,
                              renderer="pallas")
    port_out = fit_sharded(refs, SplatConfig(**kw),
                           virtual_mesh(**axes, device="cpu"), iters,
                           log_every=1, log_fn=None)
    return jax_out, port_out


def assert_params_close(port_state, jax_state, atol, rtol=1e-4):
    for f in FIELDS:
        np.testing.assert_allclose(
            getattr(port_state.params, f).numpy(),
            np.asarray(getattr(jax_state.params, f)), rtol=rtol, atol=atol,
            err_msg=f)


@pytest.mark.parametrize("axes", MESHES, ids=mesh_id)
def test_fit_matches_gs2d_tpu(axes):
    """Three sharded steps (resident layout, the fused kernel a sub-band
    with one splat shard, fold combine with more) track gs2d_tpu's."""
    (j_state, j_hist), (t_state, t_hist) = both_fits(axes)
    assert t_state.params.pos.shape == (axes["data"], 64, 2)
    assert_params_close(t_state, j_state, atol=2e-2)
    for t, j in zip(t_hist, j_hist):
        assert t["iter"] == j["iter"]
        np.testing.assert_allclose(t["mse"], j["mse"], rtol=1e-3)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_cluster(nproc, shape, ckdir, combine, phase, saved=None,
                 timeout=120):
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    worker = os.path.join(repo, "tests", "_torch_mp_worker.py")
    extra = [",".join(map(str, saved))] if saved else []
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(pid), str(nproc),
         str(ckdir), combine, phase, *map(str, shape), *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{out[-4000:]}"
        assert "MP_WORKER_OK" in out, out[-4000:]
    # Every rank reports the same loss.
    assert len({out.split("mse=")[1].split()[0] for out in outs}) == 1
    return outs


def test_two_rank_tile_cluster(tmp_path):
    """tile=2 across two processes: the gradient all-reduce over gloo."""
    _run_cluster(2, (1, 2, 1), tmp_path / "ck", "fold", "fit_save")


def test_four_rank_cluster_then_two_rank_restore(tmp_path):
    """tile=2, splat=2 across four processes with the scan combine
    (neighbour exchanges over gloo) saves a checkpoint at step 3; a
    two-rank cluster on splat=2 restores it (rank 0 reads and sends it)
    bit for bit and resumes."""
    ck = tmp_path / "ck"
    _run_cluster(4, (1, 2, 2), ck, "scan", "fit_save")
    _run_cluster(2, (1, 1, 2), ck, "scan", "restore_check",
                 saved=(1, 2, 2))
