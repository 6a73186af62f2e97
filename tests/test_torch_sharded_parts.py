"""The parts of the port's sharded fit against gs2d_tpu's, on the CPU
(tests/test_torch_sharded_bands.py holds the band arguments of the binning
and the kernels).

- The dense and flat layouts on a (1, 2, 2) mesh, and the resident layout
  at lr 1e-4, against gs2d_tpu's ``fit_sharded(renderer="pallas")`` at the
  JAX tests' tolerances (tests/test_sharding.py:49-101).
- Within the port, as tests/test_sharding.py holds gs2d_tpu: overlap_chunks
  1 against 2, the scan combine against the fold, lazy rebinning under the
  mesh (``rebinned`` fires on a margin escape), scan_chunk blocks with
  densify, a checkpointed fit resumed bit for bit, the mesh validation
  errors, and the CLI's ``--mesh``.
"""

import os

import numpy as np
import pytest
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.parallel.sharded import fit_sharded as jax_fit_sharded
from gs2d_tpu_torch import cli
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.io.checkpoint import Checkpointer
from gs2d_tpu_torch.io.image import synthetic_target
from gs2d_tpu_torch.ops import render_flat as trf
from gs2d_tpu_torch.parallel import sharded as tsh
from gs2d_tpu_torch.parallel.mesh import virtual_mesh
from gs2d_tpu_torch.train.densify import live_mask
from gs2d_tpu_torch.train.loop import init_batched_state, state_leaves
from tests.test_torch_sharded import assert_params_close, both_fits

torch.set_num_threads(1)

H, W = 32, 64
MINI = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "squirrel_cls_mini.npy")


# --- the sharded fit ---

@pytest.mark.parametrize("layout", ["dense", "flat"])
def test_layouts_match_gs2d_tpu(layout):
    """The dense layout (split forward / combine / backward over the
    pregathered rows) and the flat one (each band flat-binned with a
    per-band capacity) on tile 2 x splat 2, with two overlap sub-bands."""
    kw = dict(binning=layout)
    if layout == "flat":
        kw["flat_chunk"] = 32
    (j_state, j_hist), (t_state, t_hist) = both_fits(
        {"data": 1, "tile": 2, "splat": 2}, **kw)
    assert_params_close(t_state, j_state, atol=2e-2)
    np.testing.assert_allclose([r["mse"] for r in t_hist],
                               [r["mse"] for r in j_hist], rtol=1e-3)


@pytest.mark.parametrize("axes", [{"data": 1, "tile": 2, "splat": 2},
                                  {"data": 2, "tile": 2, "splat": 2}],
                         ids=["d1t2s2", "d2t2s2"])
def test_tight_at_small_lr(axes):
    """At lr 1e-4 Adam no longer amplifies an ulp of a gradient to O(lr):
    every parameter within atol 1e-4 of gs2d_tpu's."""
    (j_state, _), (t_state, _) = both_fits(axes, learning_rate=1e-4)
    assert_params_close(t_state, j_state, atol=1e-4, rtol=0)


def small_cfg(**kw) -> SplatConfig:
    return SplatConfig(**{**dict(width=W, height=H, n_splats=64,
                                  min_throughput=0.0,
                                  max_splats_per_tile=64), **kw})


def one_step(cfg, axes, **kw):
    mesh = virtual_mesh(**axes, device="cpu")
    step, sh = tsh.make_sharded_train_step(cfg, mesh, **kw)
    state = init_batched_state(cfg, axes.get("data", 1), "cpu")
    refs = tsh.pad_ref_batch(synthetic_target(H, W)[None], cfg, "cpu")
    states, auxes = step(sh["state"](state), sh["ref"](refs))
    return tsh.gather_state(states, mesh), auxes[mesh.coords[0]]


@pytest.mark.parametrize("binning", ["resident", "flat"])
def test_overlap_chunks_equivalent(binning):
    """Sub-bands, each all-reduced as it ends, == one sub-band."""
    cfg = small_cfg(binning=binning, flat_chunk=32)
    if binning == "flat":
        cfg = trf.tune_flat_config(
            init_batched_state(cfg, 1, "cpu").params.map(lambda x: x[0]),
            cfg, n_bands=2)
    axes = {"tile": 2, "splat": 2}
    (a, aux_a), (b, aux_b) = (one_step(cfg, axes, overlap_chunks=oc)
                              for oc in (1, 2))
    np.testing.assert_allclose(float(aux_a.mse[0]), float(aux_b.mse[0]),
                               rtol=1e-6)
    for x, y in zip(state_leaves(a), state_leaves(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("splat", [2, 4])
def test_scan_combine_matches_fold(splat):
    """The Hillis-Steele neighbour rounds == the all-gather fold."""
    cfg = small_cfg()
    (a, aux_a), (b, aux_b) = (one_step(cfg, {"splat": splat},
                                       combine=combine)
                              for combine in ("fold", "scan"))
    assert np.isclose(float(aux_a.mse[0]), float(aux_b.mse[0]), rtol=1e-5)
    for x, y in zip(state_leaves(a), state_leaves(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=2e-4)


def test_fold_stack_is_the_sequential_composite():
    """fold_stack on shards' partials == compositing the shards in order."""
    g = torch.Generator().manual_seed(0)
    C = torch.rand((3, 4, 5, 3), generator=g)
    T = torch.rand((3, 4, 5), generator=g)
    fin, T_fin, C_in, T_in = tsh.fold_stack(C, T, 2)
    acc, tr = torch.zeros_like(C[0]), torch.ones_like(T[0])
    for s in range(3):
        if s == 2:
            torch.testing.assert_close(C_in, acc)
            torch.testing.assert_close(T_in, tr)
        acc, tr = acc + tr[..., None] * C[s], tr * T[s]
    torch.testing.assert_close(fin, acc)
    torch.testing.assert_close(T_fin, tr)


def test_lazy_rebin_fires_on_margin_escape():
    """lr 3.0 moves footprints past a 0.5 px margin: a later step of the
    block rebins its band, and the fit still tracks eager binning."""
    cfg = small_cfg(binning="resident", rebin_margin=0.5, learning_rate=3.0)
    mesh = virtual_mesh(tile=2, device="cpu")
    fit_k, sh = tsh.make_fit_scan_sharded(cfg, mesh)
    state = init_batched_state(cfg, 1, "cpu")
    refs = sh["ref"](tsh.pad_ref_batch(synthetic_target(H, W)[None], cfg,
                                       "cpu"))
    states, auxes = fit_k(sh["state"](state), refs, 4)
    reb = auxes[mesh.coords[0]].rebinned
    assert reb.dtype == torch.int32 and reb.shape == (4,)
    assert int(reb[1:].sum()) >= 1
    eager, _ = tsh.make_fit_scan_sharded(cfg.replace(rebin_margin=0.0), mesh)
    st0, _ = eager(sh["state"](state), refs, 4)
    np.testing.assert_allclose(
        tsh.gather_state(states, mesh).params.pos.numpy(),
        tsh.gather_state(st0, mesh).params.pos.numpy(), rtol=1e-4, atol=2e-2)


def test_scan_chunk_with_densify():
    """Blocks clipped to densify boundaries on a (2, 2, 2) mesh, the
    signal summed across blocks, densify on the whole population: finite,
    static capacity, live splats, and the MSE history of gs2d_tpu's same
    fit."""
    kw = dict(width=W, height=H, n_splats=64, min_throughput=0.0,
              max_splats_per_tile=64, binning="resident", rebin_margin=2.0)
    refs = np.stack([synthetic_target(H, W)] * 2)
    args = dict(iterations=8, log_every=4, log_fn=None, scan_chunk=3,
                densify_every=4)
    state, hist = tsh.fit_sharded(refs, SplatConfig(**kw),
                                  virtual_mesh(2, 2, 2, "cpu"), **args)
    assert torch.isfinite(state.params.pos).all()
    assert state.params.pos.shape == (2, 64, 2)
    assert int(live_mask(state.params.map(lambda x: x[0])).sum()) > 0
    assert [r["iter"] for r in hist] == [0, 4, 7] and len(hist[-1]["mse"]) == 2
    from gs2d_tpu.parallel.mesh import make_mesh as jax_mesh

    _, j_hist = jax_fit_sharded(refs, JaxConfig(**kw),
                                jax_mesh(data=2, tile=2, splat=2),
                                renderer="pallas", **args)
    np.testing.assert_allclose([r["mse"] for r in hist],
                               [r["mse"] for r in j_hist], rtol=1e-3)


def test_checkpoint_resume_bitwise(tmp_path):
    """A fit resumed from its checkpoint continues the unbroken fit bit for
    bit (the reference's resume contract under the mesh)."""
    cfg = small_cfg(binning="resident", rebin_margin=2.0)
    refs = synthetic_target(H, W)[None]
    mesh = virtual_mesh(tile=2, splat=2, device="cpu")
    full, _ = tsh.fit_sharded(refs, cfg, mesh, 6, log_fn=None, scan_chunk=3)
    ck = Checkpointer(str(tmp_path / "ck"))
    tsh.fit_sharded(refs, cfg, mesh, 3, log_fn=None, scan_chunk=3,
                    checkpoint_every=3,
                    checkpoint_fn=lambda s, it: ck.save(it, s, cfg))
    step, restored = ck.restore_latest(init_batched_state(cfg, 1, "cpu"))
    assert step == 3
    resumed, _ = tsh.fit_sharded(refs, cfg, mesh, 3, state=restored,
                                 log_fn=None, scan_chunk=3)
    for x, y in zip(state_leaves(resumed), state_leaves(full)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("cfg_kw,mesh_kw,step_kw,match", [
    ({"n_splats": 50}, {"splat": 4}, {}, "n_splats"),
    ({}, {"tile": 3}, {}, "padded height"),
    ({"tile_h": 16}, {"tile": 4}, {}, "align to tile_h"),
    ({}, {}, {"combine": "ring"}, "unknown combine"),
    ({}, {}, {"renderer": "scan"}, "not ported"),
    ({}, {"tile": 2}, {"overlap_chunks": 3}, "overlap_chunks"),
    ({"binning": "flat"}, {}, {}, "flat binning statics unset"),
])
def test_mesh_validation(cfg_kw, mesh_kw, step_kw, match):
    with pytest.raises(ValueError, match=match):
        tsh.make_sharded_train_step(small_cfg(**cfg_kw),
                                    virtual_mesh(**mesh_kw, device="cpu"),
                                    **step_kw)


def test_batch_must_divide_over_the_data_axis():
    with pytest.raises(ValueError, match="data axis"):
        tsh.fit_sharded(np.stack([synthetic_target(H, W)] * 3), small_cfg(),
                        virtual_mesh(data=2, device="cpu"), 1, log_fn=None)


# --- devices and the process mesh ---

@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host with "
                    "no CUDA device")
def test_the_card_by_default():
    """The mesh entry points default to the card: ``virtual_mesh`` takes
    "cuda", and with no CUDA device ``local_device`` and a process mesh
    with no gloo group or CPU device raise instead of running on the
    CPU."""
    from gs2d_tpu_torch.parallel.mesh import local_device, make_mesh

    assert virtual_mesh(1, 2, 1).device.type == "cuda"
    for call in (local_device, lambda: make_mesh(1, 1, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert local_device("gloo").type == "cpu"


def test_process_mesh_calls_no_collective_on_an_axis_of_one(monkeypatch):
    """On a world of one rank every axis has size 1: the collectives
    return their input (contiguous) and call no torch.distributed
    collective, as the virtual mesh computes them."""
    import torch.distributed as dist

    from gs2d_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, 1, 1, devices=["cpu"])
    try:
        def refuse(*args, **kwargs):
            raise AssertionError("a collective ran on an axis of size 1")

        for name in ("all_reduce", "all_gather", "batch_isend_irecv"):
            monkeypatch.setattr(dist, name, refuse)
        (c,) = mesh.coords
        x = torch.arange(6.0).reshape(2, 3).t()
        for axis in ("data", "tile", "splat"):
            assert torch.equal(mesh.comm.all_reduce(axis, {c: x})[c], x)
            assert torch.equal(mesh.comm.all_reduce(axis, {c: x}, "max")[c],
                               x)
            assert torch.equal(mesh.comm.all_reduce_start(axis, {c: x})()[c],
                               x)
            (g,) = mesh.comm.all_gather(axis, {c: x})[c]
            assert torch.equal(g, x) and g.is_contiguous()
            assert mesh.comm.shift(axis, 1, {c: x})[c] is x
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()


# --- the CLI ---

@pytest.mark.parametrize("argv", [
    ["--reorder-every", "2"], ["--save-render-every", "2"], ["--recover"],
    ["--densify-every", "2", "--optimize-opacity",
     "--opacity-reset-every", "4"],
    ["--mesh", "1,2"], ["--mesh", "1,2,x"],
], ids=["reorder", "save-render", "recover", "opacity-reset", "two-axes",
        "not-a-size"])
def test_cli_mesh_refuses(tmp_path, argv):
    args = ["--mesh", "1,1,1", *argv] if argv[0] != "--mesh" else argv
    with pytest.raises(SystemExit) as e:
        cli.main([MINI, "--device", "cpu", "--out", str(tmp_path), *args])
    assert e.value.code == 2


def test_cli_mesh_of_one_device(tmp_path, capsys):
    """``--mesh 1,1,1`` on the CPU: the one-image fit's MSEs (the mesh's
    are gs2d_tpu's sum-over-bands form, within rtol 1e-6), a checkpoint a
    resume continues at global steps, and one render a image."""
    base = [MINI, "--splats", "32", "--log-every", "1", "--device", "cpu"]
    assert cli.main([*base, "--iters", "3", "--out",
                     str(tmp_path / "one")]) == 0
    one = capsys.readouterr().out
    assert cli.main([*base, "--iters", "3", "--mesh", "1,1,1",
                     "--checkpoint-every", "2", "--out",
                     str(tmp_path / "m")]) == 0
    mesh = capsys.readouterr().out
    got = [float(ln.split("mse ")[1]) for ln in mesh.splitlines()
           if " itr, mse" in ln]
    want = [float(ln.split("mse ")[1].split(",")[0])
            for ln in one.splitlines() if " itr, mse" in ln]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert "done (sharded over" in mesh
    assert (tmp_path / "m" / "render_final.png").exists()
    assert sorted(Checkpointer(str(tmp_path / "m" / "checkpoints"))
                  .all_steps()) == [2, 3]
    assert cli.main([*base, "--iters", "1", "--mesh", "1,1,1", "--resume",
                     "--out", str(tmp_path / "m")]) == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 3" in out and "3 itr, mse" in out
    assert cli.main([MINI, MINI, "--splats", "32", "--iters", "1",
                     "--device", "cpu", "--mesh", "1,1,1", "--out",
                     str(tmp_path / "two")]) == 0
    assert (tmp_path / "two" / "render_final_01.png").exists()
