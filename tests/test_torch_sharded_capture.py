"""The port's scanned mesh blocks (``parallel/sharded.py::_Blocks``, one
step a process replayed as a block, the aux reduced over the mesh at the
block's end) on the CPU, where the same step body runs in a Python loop.

- On virtual meshes (1,2,1) fold, (1,1,2) scan, (1,2,2) fold and (2,1,1)
  with two images: blocks of 2 and 1 steps equal 3 per-step sharded steps
  (``make_sharded_train_step``) bit for bit at margin 0, the state and every
  field of the aux; ``fit_sharded`` with ``scan_chunk`` and densify equals
  its per-step fit bit for bit.
- The blocks against gs2d_tpu's ``make_fit_scan_sharded(renderer=
  "pallas")`` on the JAX CPU mesh at the JAX tests' tolerances
  (tests/test_sharding.py: parameters atol 2e-2, rtol 1e-4; MSE rtol
  1e-3), lazy rebinning included, with gs2d_tpu's ``rebinned`` flags.
- The block-end reductions against the per-step ones where they matter: a
  non-finite splat on one coordinate, pairs dropped in one band only, and
  a rebin in one band only (``rebinned`` 1 on every coordinate).
- The block path reads nothing back to the host, and a process mesh on
  the card refuses an NCCL that cannot capture collectives.

tests/test_torch_sharded.py runs the gloo clusters through the same class;
tests/test_torch_cuda.py holds the captured block to its eager steps on the
card.
"""

import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.parallel.mesh import make_mesh as jax_mesh
from gs2d_tpu.parallel.sharded import init_batched_state as jax_init
from gs2d_tpu.parallel.sharded import make_fit_scan_sharded as jax_fit_scan
from gs2d_tpu.parallel.sharded import pad_ref_batch as jax_pad
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.io.image import synthetic_target
from gs2d_tpu_torch.parallel import sharded as tsh
from gs2d_tpu_torch.parallel.mesh import virtual_mesh
from gs2d_tpu_torch.params import FIELDS
from gs2d_tpu_torch.train.loop import (STEP_FIELDS, init_batched_state,
                                       state_index, state_leaves)

torch.set_num_threads(1)

H, W = 32, 64
MESHES = [((1, 2, 1), "fold"), ((1, 1, 2), "scan"), ((1, 2, 2), "fold"),
          ((2, 1, 1), "fold")]


def mesh_id(case) -> str:
    (d, t, s), combine = case
    return f"d{d}t{t}s{s}-{combine}"


def small_cfg(**kw) -> SplatConfig:
    return SplatConfig(**{**dict(width=W, height=H, n_splats=64,
                                 min_throughput=0.0, max_splats_per_tile=64,
                                 binning="resident"), **kw})


def targets(batch: int) -> np.ndarray:
    return np.stack([synthetic_target(H, W, seed=d) for d in range(batch)])


def blocks_and_steps(cfg, shape, combine="fold", state=None,
                     blocks=(2, 1)):
    """From one init on a virtual mesh of ``shape``: the blocks of
    ``make_fit_scan_sharded`` and as many per-step sharded steps. Returns
    (fit_k, mesh, (block states, [block auxes]), (step states, [step
    auxes]))."""
    mesh = virtual_mesh(*shape, device="cpu")
    if state is None:
        state = init_batched_state(cfg, shape[0], "cpu")
    cfg = tsh.prepare_config(cfg, mesh, state_index(state, 0).params)
    fit_k, sh = tsh.make_fit_scan_sharded(cfg, mesh, combine=combine)
    step, _ = tsh.make_sharded_train_step(cfg, mesh, combine=combine)
    refs = sh["ref"](tsh.pad_ref_batch(targets(shape[0]), cfg, "cpu"))
    st_b, a_b = sh["state"](state), []
    for n in blocks:
        st_b, a = fit_k(st_b, refs, n)
        a_b.append(a)
    st_s, a_s = sh["state"](state), []
    for _ in range(sum(blocks)):
        st_s, a = step(st_s, refs)
        a_s.append(a)
    return fit_k, mesh, (st_b, a_b), (st_s, a_s)


def stacked_steps(auxes: list, c, f: str) -> torch.Tensor:
    return torch.stack([torch.as_tensor(getattr(a[c], f)) for a in auxes])


def joined_blocks(auxes: list, c, f: str) -> torch.Tensor:
    return torch.cat([getattr(a[c], f) for a in auxes])


def assert_same_states(a: dict, b: dict) -> None:
    for c in a:
        for x, y in zip(state_leaves(a[c]), state_leaves(b[c])):
            assert torch.equal(x, y), c


@pytest.mark.parametrize("case", MESHES, ids=mesh_id)
def test_blocks_equal_per_step(case):
    """Blocks of 2 and 1 steps equal 3 per-step steps bit for bit: the
    state of every coordinate and each step's mse, psnr, all_finite and
    n_dropped (rebinned 0 at margin 0)."""
    shape, combine = case
    fit_k, mesh, (st_b, a_b), (st_s, a_s) = blocks_and_steps(
        small_cfg(), shape, combine)
    assert fit_k.mode == tsh._Blocks.mode
    assert_same_states(st_b, st_s)
    for c in mesh.coords:
        for f in STEP_FIELDS:
            got = joined_blocks(a_b, c, f)
            if f == "rebinned":
                assert got.dtype == torch.int32 and not got.any()
                continue
            want = stacked_steps(a_s, c, f)
            assert got.shape == want.shape and torch.equal(got, want), f


@pytest.mark.parametrize("case", [((1, 2, 2), "fold"), ((2, 1, 1), "fold")],
                         ids=mesh_id)
def test_fit_sharded_blocks_with_densify_equal_per_step(case):
    """``fit_sharded`` in blocks of 2 with densify every 3 and a margin of
    2 px equals the per-step fit bit for bit: the blocks' signal sum
    continues from block to block in the order of single steps."""
    shape, combine = case
    cfg = small_cfg(rebin_margin=2.0)
    kw = dict(log_every=1, log_fn=None, combine=combine, densify_every=3)
    mesh = virtual_mesh(*shape, device="cpu")
    got, h_got = tsh.fit_sharded(targets(shape[0]), cfg, mesh, 5,
                                 scan_chunk=2, **kw)
    want, h_want = tsh.fit_sharded(targets(shape[0]), cfg, mesh, 5, **kw)
    for x, y in zip(state_leaves(got), state_leaves(want)):
        assert torch.equal(x, y)
    assert [r["mse"] for r in h_got] == [r["mse"] for r in h_want]
    assert [r["psnr"] for r in h_got] == [r["psnr"] for r in h_want]


@pytest.mark.parametrize("shape,layout,margin", [
    ((1, 2, 2), "resident", 2.0), ((2, 1, 2), "dense", 0.0)])
def test_blocks_match_gs2d_tpu(shape, layout, margin):
    """A block of 3 steps against gs2d_tpu's make_fit_scan_sharded on the
    JAX CPU mesh from the same init: parameters, MSE and gs2d_tpu's
    rebinned flags (its pmax over the mesh)."""
    kw = dict(width=W, height=H, n_splats=64, min_throughput=0.0,
              max_splats_per_tile=64, binning=layout, rebin_margin=margin)
    if layout == "flat":
        kw["flat_chunk"] = 32
    mesh = virtual_mesh(*shape, device="cpu")
    cfg = SplatConfig(**kw)
    state = init_batched_state(cfg, shape[0], "cpu")
    cfg = tsh.prepare_config(cfg, mesh, state_index(state, 0).params)
    fit_k, sh = tsh.make_fit_scan_sharded(cfg, mesh)
    refs = targets(shape[0])
    st, aux = fit_k(sh["state"](state),
                    sh["ref"](tsh.pad_ref_batch(refs, cfg, "cpu")), 3)
    got = tsh.gather_state(st, mesh)

    jcfg = JaxConfig(**{**kw, "flat_capacity": cfg.flat_capacity,
                        "flat_max_chunks": cfg.flat_max_chunks,
                        "tile_rows_multiple": cfg.tile_rows_multiple})
    jm = jax_mesh(*shape)
    j_fit, j_sh = jax_fit_scan(jcfg, jm, renderer="pallas")
    j_state = jax.device_put(jax_init(jcfg, shape[0]), j_sh["state"])
    j_refs = jax.device_put(jax_pad(jnp.asarray(refs), jcfg), j_sh["ref"])
    j_state, j_aux = j_fit(j_state, j_refs, 3)
    for f in FIELDS:
        np.testing.assert_allclose(
            getattr(got.params, f).numpy(),
            np.asarray(getattr(j_state.params, f)), rtol=1e-4, atol=2e-2,
            err_msg=f)
    a = aux[mesh.coords[0]]
    mse = torch.cat([aux[c].mse for c in mesh.coords
                     if c[1:] == (0, 0)], dim=-1)
    np.testing.assert_allclose(mse.numpy(), np.asarray(j_aux.mse),
                               rtol=1e-3)
    assert a.rebinned.tolist() == np.asarray(j_aux.rebinned).tolist()
    assert a.n_dropped.tolist() == np.asarray(j_aux.n_dropped).tolist()


def test_block_aux_non_finite_on_one_coordinate():
    """A NaN splat in image 1's second splat shard on a (2,1,2) mesh: the
    block's all_finite is False on image 1's coordinates and True on image
    0's, step for step as the per-step reductions give it."""
    cfg = small_cfg()
    state = init_batched_state(cfg, 2, "cpu")
    state.params.sx[1, 40] = float("nan")
    _, mesh, (_, a_b), (_, a_s) = blocks_and_steps(cfg, (2, 1, 2),
                                                   state=state)
    for c in mesh.coords:
        got = joined_blocks(a_b, c, "all_finite")
        assert torch.equal(got, stacked_steps(a_s, c, "all_finite"))
        assert bool(got.all()) if c[0] == 0 else not bool(got.any())


def in_top_rows(state):
    """The population moved into rows 1-3 with sigma 1 px: its footprints
    stay in the top band of a (1,2,1) mesh (16 rows) for a few steps."""
    state.params.pos[..., 1] = state.params.pos[..., 1] / H * 2.0 + 1.0
    state.params.sx[:] = 1.0
    state.params.sy[:] = 1.0
    return state


def test_block_aux_drops_in_one_band():
    """Every splat in the top band and 8 slots a tile on a (1,2,1) mesh:
    only band 0 drops pairs (its local counts), and the block's n_dropped,
    summed over the mesh at its end, equals the per-step sums."""
    cfg = small_cfg(max_splats_per_tile=8)
    state = in_top_rows(init_batched_state(cfg, 1, "cpu"))
    fit_k, mesh, (_, a_b), (_, a_s) = blocks_and_steps(cfg, (1, 2, 1),
                                                       state=state)
    for c in mesh.coords:
        got = joined_blocks(a_b, c, "n_dropped")
        assert torch.equal(got, stacked_steps(a_s, c, "n_dropped"))
        assert bool((got > 0).all())
    plan = fit_k.plan
    drops = [int(tsh._bin_band(state_index(state, 0).params, plan,
                               tsh._band_r0(plan, c)).n_dropped)
             for c in mesh.coords]
    assert drops[0] > 0 and drops[1] == 0


def test_block_aux_rebin_in_one_band():
    """Every splat in the top rows of a (1,2,1) mesh at a 2 px margin and 8
    slots a tile: band 0's margined cache drops pairs, so it never
    validates and band 0 rebins every step (its local flag), while band
    1's holds (the tripwire itself measures the whole population's drift
    on every band, as gs2d_tpu's does); the block's rebinned, the max over
    the mesh, is 1 on both coordinates, as gs2d_tpu's pmax gives it."""
    cfg = small_cfg(max_splats_per_tile=8, rebin_margin=2.0)
    mesh = virtual_mesh(1, 2, 1, device="cpu")
    state = in_top_rows(init_batched_state(cfg, 1, "cpu"))
    fit_k, sh = tsh.make_fit_scan_sharded(cfg, mesh)
    refs = sh["ref"](tsh.pad_ref_batch(targets(1), cfg, "cpu"))
    states = sh["state"](state)
    # The local flags, before the block-end max: the runner's own aux.
    leaves = [t for c in mesh.coords for t in state_leaves(states[c])]
    ref = torch.stack([refs[c] for c in mesh.coords])
    _, local, _ = fit_k._runner(1)(leaves, ref, 3)
    assert local["reb"][:, 0].tolist() == [1, 1, 1]
    assert local["reb"][:, 1].tolist() == [0, 0, 0]
    _, aux = fit_k(states, refs, 3)
    for c in mesh.coords:
        assert aux[c].rebinned.tolist() == [1, 1, 1]


def test_block_path_reads_nothing_back():
    """From the comms to the block class, sharded.py calls no host read:
    the block's steps run with no host work in between (on the card
    tests/test_torch_cuda.py replays them under sync debug mode "error")."""
    src = inspect.getsource(tsh)
    body = src[src.index("class VirtualComm"):
               src.index("def make_fit_scan_sharded")]
    for call in ("bool(", ".item()", ".cpu()", ".tolist()", ".numpy()"):
        assert call not in body, call


@pytest.mark.parametrize("version,raises", [((2, 9, 5), True),
                                            ((2, 9, 6), False),
                                            ((2, 27, 3, "+cuda12.9"), False)])
def test_nccl_must_capture_collectives(monkeypatch, version, raises):
    """A process mesh of several cards needs NCCL 2.9.6 or later to capture
    its collectives; a virtual mesh, a mesh of one card and a CPU mesh do
    not ask."""
    monkeypatch.setattr(torch.cuda.nccl, "version", lambda: version)
    mesh = types.SimpleNamespace(device_mesh=object(), size=2,
                                 device=torch.device("cuda", 0))
    if raises:
        with pytest.raises(RuntimeError, match="2.9.6"):
            tsh._require_nccl_capture(mesh)
    else:
        tsh._require_nccl_capture(mesh)
    monkeypatch.setattr(torch.cuda.nccl, "version", lambda: (2, 0, 0))
    for other in (dict(device_mesh=None), dict(size=1),
                  dict(device=torch.device("cpu"))):
        tsh._require_nccl_capture(types.SimpleNamespace(**{
            **vars(mesh), **other}))
