"""PyTorch port flat layout vs the JAX package on the CPU: the flat binning
(integer-equal ids, starts, counts and n_dropped through all three
overflows), the row pregather, capacity and tile-height tuning, the plain
versions of kernels 10 and 11 against the JAX flat Pallas kernels in
interpret mode, the L2 step, five fit steps, and the CLI; the binning's
expansion dispatch (CPU tensors run the plain twin) and the schedule of its
emission kernel (csrc/tiles_flat.cu) emulated against that twin.

Kernel inputs (the flat binning) are built by the JAX package and handed to
both sides where a test isolates a kernel. Tolerances follow
tests/test_torch_render.py: colour and T atol 1e-6, gradients atol
1e-4 * max(1, |g|max) (float32 sums in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_tpu.config import SplatConfig as JaxConfig
from gs2d_tpu.ops import render_pallas as jrp
from gs2d_tpu.ops import render_pallas_flat as jrpf
from gs2d_tpu.ops import tiles as jtl
from gs2d_tpu.ops import tiles_flat as jtlf
from gs2d_tpu.train import loop as jloop
from gs2d_tpu_torch import cli
from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.io.image import synthetic_target
from gs2d_tpu_torch.ops import render as trd
from gs2d_tpu_torch.ops import render_flat as trf
from gs2d_tpu_torch.ops import tiles as ttl
from gs2d_tpu_torch.ops import tiles_flat as ttlf
from gs2d_tpu_torch.params import FIELDS, params_from_numpy
from gs2d_tpu_torch.train import loop as tloop
from tests.helpers import random_splats, to_params

torch.set_num_threads(1)

H, W = 48, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "assets", "squirrel_cls_mini.npy")


def case(rng, n, tile_h, kc, **kw):
    kw = dict(width=W, height=H, n_splats=n, tile_h=tile_h, flat_chunk=kc,
              binning="flat", **kw)
    jp = to_params(random_splats(rng, n, W, H))
    tp = params_from_numpy({f: np.asarray(getattr(jp, f)) for f in FIELDS},
                           "cpu")
    return JaxConfig(**kw), SplatConfig(**kw), jp, tp


# One compiled program per shape instead of op-by-op eager dispatch (the
# test file's time is mostly JAX compiling).
jax_bin_flat = jax.jit(jtlf.bin_splats_flat, static_argnums=(1, 2),
                       static_argnames=("kc", "max_chunks"))


def to_torch(jb) -> ttlf.FlatBinning:
    return ttlf.FlatBinning(*(torch.tensor(np.asarray(x)) for x in jb))


def jax_binning(jp, cfg_j):
    cfg_j = jrpf.tune_flat_config(jp, cfg_j)
    jb = jax_bin_flat(jp, cfg_j, cfg_j.flat_capacity, kc=cfg_j.flat_chunk,
                      max_chunks=cfg_j.flat_max_chunks)
    assert int(jb.n_dropped) == 0
    return cfg_j, jb


def assert_grads_close(g_port, g_ref):
    for f in FIELDS:
        want = np.asarray(getattr(g_ref, f))
        atol = 1e-4 * max(1.0, np.abs(want).max())
        np.testing.assert_allclose(getattr(g_port, f).numpy(), want,
                                   atol=atol, err_msg=f)


# (n, tile_h, kc, caps): "tuned" capacities, a chunk cap of one chunk, and a
# capacity of four chunks (the expansion and the capacity overflow).
FLAT_BIN_CASES = [(200, 8, 8, "tuned"), (300, 32, 16, "tuned"),
                  (200, 8, 8, "chunk"), (300, 32, 16, "chunk"),
                  (200, 8, 8, "capacity"), (300, 32, 16, "capacity")]


@pytest.mark.parametrize("n,tile_h,kc,caps", FLAT_BIN_CASES)
def test_bin_splats_flat_equal(rng, n, tile_h, kc, caps):
    cfg_j, cfg_t, jp, tp = case(rng, n, tile_h, kc)
    m, mc = jtlf.tune_flat_capacity(jp, cfg_j, kc=kc)
    m, mc = {"tuned": (m, mc), "chunk": (m, 1), "capacity": (4 * kc, mc)}[
        caps]
    jb = jax_bin_flat(jp, cfg_j, m, kc=kc, max_chunks=mc)
    tb = ttlf.bin_splats_flat(tp, cfg_t, m, kc=kc, max_chunks=mc,
                              ids_only=True)
    for f in ("ids", "start", "count"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
        assert getattr(tb, f).dtype == torch.int32
    assert int(tb.n_dropped) == int(jb.n_dropped)
    assert tuple(tb.rows.shape) == (1, ttl.N_FIELDS)
    if caps == "tuned":
        assert int(tb.n_dropped) == 0
    else:
        assert int(tb.n_dropped) > 0  # the overflow cases really overflow
    if caps == "capacity":  # the expansion alone overflows the capacity
        tx0, tx1, ty0, ty1, off = ttl.splat_tile_bbox(tp, cfg_t)
        total = int(torch.where(off, 0, (tx1 - tx0 + 1) * (ty1 - ty0 + 1))
                    .sum())
        assert total > m


def test_pregather_rows_bitwise(rng, monkeypatch):
    """Same ids, same packed fields: the gathered rows and the benign
    padding rows are bitwise equal. Both sides gather from one packed-field
    array (the fields themselves differ by an ulp between XLA and libm, see
    test_torch_tiles.test_packed_fields)."""
    cfg_j, cfg_t, jp, tp = case(rng, 150, 32, 16)
    fields = np.asarray(jtl.packed_fields(jp, 3.0))
    monkeypatch.setattr(jtl, "packed_fields",
                        lambda p, bounds=3.0: jnp.asarray(fields))
    monkeypatch.setattr(ttl, "packed_fields",
                        lambda p, bounds=3.0: torch.tensor(fields))
    cfg_j = jrpf.tune_flat_config(jp, cfg_j)
    # Eager, not jax_bin_flat: a cached trace would hold the real fields.
    jb = jtlf.bin_splats_flat(jp, cfg_j, cfg_j.flat_capacity, kc=16,
                              max_chunks=cfg_j.flat_max_chunks)
    assert int((np.asarray(jb.ids) < 0).sum()) > 0  # padding rows exist
    rows = ttlf.pregather_rows(torch.tensor(np.asarray(jb.ids)), tp, cfg_t)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jb.rows))
    tb = ttlf.bin_splats_flat(tp, cfg_t, cfg_j.flat_capacity, kc=16,
                              max_chunks=cfg_j.flat_max_chunks)
    np.testing.assert_array_equal(tb.rows.numpy(), np.asarray(jb.rows))


@pytest.mark.parametrize("kc,margin", [(8, 1.5), (16, 1.5), (256, 2.0)])
def test_tune_flat_capacity_equal(rng, kc, margin):
    cfg_j, cfg_t, jp, tp = case(rng, 250, 32, kc)
    assert ttlf.tune_flat_capacity(tp, cfg_t, kc=kc, margin=margin) == \
        jtlf.tune_flat_capacity(jp, cfg_j, kc=kc, margin=margin)
    tc = trf.tune_flat_config(tp, cfg_t)
    jc = jrpf.tune_flat_config(jp, cfg_j)
    assert (tc.flat_capacity, tc.flat_max_chunks) == \
        (jc.flat_capacity, jc.flat_max_chunks)


@pytest.mark.parametrize("deep", [False, True])
def test_tune_tile_height_equal(rng, deep):
    """Default population: 32. A deep, tall one (3000 splats spanning both
    32-row tile rows of a 48-row image, > 2500 pairs per tile): 64."""
    n = 3000 if deep else 200
    cfg_j, cfg_t, jp, tp = case(rng, n, 8, 16)
    if deep:
        big = np.full(n, 30.0, np.float32)
        jp = jp.replace(sy=big, sx=big)
        tp = tp.replace(sy=torch.tensor(big), sx=torch.tensor(big))
    want = jtl.tune_tile_height(cfg_j, jp).tile_h
    assert ttl.tune_tile_height(cfg_t, tp).tile_h == want == (
        64 if deep else 32)
    assert ttl.tune_tile_height(cfg_t).tile_h == 32


@pytest.mark.parametrize("tile_h,kc,sat", [(32, 16, False), (8, 8, True)])
def test_forward_flat_matches_jax(rng, monkeypatch, tile_h, kc, sat):
    """Plain kernel 10 vs the JAX flat forward in interpret mode; ``sat``
    forces the saturating walk on both sides."""
    if sat:
        monkeypatch.setattr(jrp, "SAT_WALK_THRESHOLD", 1)
        monkeypatch.setattr(trd, "SAT_WALK_THRESHOLD", 1)
    cfg_j, cfg_t, jp, _ = case(rng, 300, tile_h, kc)
    cfg_j, jb = jax_binning(jp, cfg_j)
    mc = cfg_j.flat_max_chunks
    Cj, Tj = jrpf.forward_flat(jb, cfg_j, kc, mc)
    before = dict(trf.launches)
    Ct, Tt = trf.forward_flat(to_torch(jb), cfg_t, kc, mc)
    assert trf.launches == before  # the CPU path launches no kernel
    assert Ct.shape == (cfg_t.padded_height, cfg_t.padded_width, 3)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), atol=1e-6)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-6)
    assert float(Tt[:, W:].abs().max()) == 0.0  # identity T on padding


def port_forward(tp, cfg_t):
    """The port's own flat binning and (color (Hp, Wp, 3), T) of ``tp``."""
    cfg_t = trf.tune_flat_config(tp, cfg_t)
    b = ttlf.bin_splats_flat(tp, cfg_t, cfg_t.flat_capacity,
                             kc=cfg_t.flat_chunk,
                             max_chunks=cfg_t.flat_max_chunks)
    return cfg_t, b, trf.forward_flat(b, cfg_t, cfg_t.flat_chunk,
                                      cfg_t.flat_max_chunks)


def test_backward_flat_carry_and_cotangent_match_jax(rng):
    """Plain kernel 11 from a non-identity carry-in (another population's
    composite) under an arbitrary upstream cotangent; both sides get the
    same final colour, carry and cotangent."""
    cfg_j, cfg_t, jp, tp = case(rng, 200, 32, 16)
    cfg_j, jb = jax_binning(jp, cfg_j)
    kc, mc = 16, cfg_j.flat_max_chunks
    _, _, (fin, _) = port_forward(tp, cfg_t)
    pre = random_splats(rng, 100, W, H)
    _, _, (c_in, t_in) = port_forward(params_from_numpy(
        {f: getattr(pre, f) for f in FIELDS}, "cpu"),
        cfg_t.replace(n_splats=100))
    g = rng.normal(size=tuple(fin.shape)).astype(np.float32)
    gj = jrpf.backward_flat(jb, jnp.asarray(fin.numpy()), jnp.asarray(g),
                            200, cfg_j, kc, mc, params=jp,
                            carry_in=(jnp.asarray(c_in.numpy()),
                                      jnp.asarray(t_in.numpy())))
    gt = trf.backward_flat(to_torch(jb), fin, torch.tensor(g), 200, cfg_t,
                           kc, mc, tp, carry_in=(c_in, t_in))
    assert_grads_close(gt, gj)


def test_l2_step_flat_matches_jax(rng):
    cfg_j, cfg_t, jp, tp = case(rng, 250, 32, 16)
    cfg_j = jrpf.tune_flat_config(jp, cfg_j)
    cfg_t = trf.tune_flat_config(tp, cfg_t)
    ref = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    Cj, gj, dj = jrpf.l2_step_flat(
        jp, jrp.pad_ref_chw(jnp.asarray(ref), cfg_j), cfg_j)
    Ct, gt, dt = trf.l2_step_flat(tp, trd.pad_ref_chw(ref, cfg_t), cfg_t)
    assert int(dt) == int(dj) == 0
    assert Ct.shape == (H, W, 3)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), atol=1e-6)
    assert_grads_close(gt, gj)
    color, dropped = trf.render_flat(tp, cfg_t)
    np.testing.assert_array_equal(color.numpy(), Ct.numpy())
    assert int(dropped) == 0


def test_five_step_flat_fit_matches_jax():
    """Five steps of the port's flat fit against gs2d_tpu's fit with the
    fused flat step on the same pcg3d init and target: per-step MSE within
    rtol 1e-5."""
    kw = dict(width=W, height=H, n_splats=64, tile_h=32, flat_chunk=16,
              binning="flat")
    ref = synthetic_target(H, W)
    _, hist_j = jloop.fit(jnp.asarray(ref), JaxConfig(**kw), 5, log_every=1,
                          log_fn=None, use_fused=True)
    _, hist_t = tloop.fit(ref, SplatConfig(**kw), 5, "cpu", log_every=1,
                          log_fn=None)
    got = [rec["mse"] for rec in hist_t]
    np.testing.assert_allclose(got, [rec["mse"] for rec in hist_j],
                               rtol=1e-5)
    assert got[-1] < got[0]


def test_split_step_capacity_refused():
    """Above SPLIT_STEP_ROWS the one-image step is built as at every other
    capacity (tests/test_torch_split.py holds it against gs2d_tpu's split
    step), and the batched steps refuse the capacity, as gs2d_tpu's do."""
    cfg = SplatConfig(width=W, height=H, n_splats=64, binning="flat",
                      flat_capacity=tloop.SPLIT_STEP_ROWS + 256,
                      flat_max_chunks=4)
    assert tloop._needs_split(cfg)
    assert callable(tloop.make_train_step_fused(cfg))
    with pytest.raises(ValueError, match="SPLIT_STEP_ROWS"):
        tloop.make_batched_train_step_fused(cfg)
    with pytest.raises(ValueError, match="SPLIT_STEP_ROWS"):
        tloop.make_fit_scan_batched(cfg)


def test_flat_later_slices_raise(rng):
    """Banded binning, which later slices brought (tile-axis sharding),
    now equals gs2d_tpu's band for band; unset flat statics still raise."""
    cfg_j, cfg_t, jp, tp = case(rng, 16, 8, 8)
    assert ttlf.tune_flat_capacity(tp, cfg_t, kc=8, n_bands=2) \
        == jtlf.tune_flat_capacity(jp, cfg_j, kc=8, n_bands=2)
    for r0 in (0, 2):
        got = ttlf.bin_splats_flat(tp, cfg_t, 64, kc=8, band_row0=r0,
                                   band_rows=2)
        want = jtlf.bin_splats_flat(jp, cfg_j, 64, kc=8, band_row0=r0,
                                    band_rows=2)
        for f in ("ids", "start", "count", "n_dropped"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
    with pytest.raises(ValueError):
        trf.l2_step_flat(tp, trd.pad_ref_chw(np.zeros((H, W, 3)), cfg_t),
                         cfg_t)  # statics unset


def test_flat_wrapper_rejects_other_devices(rng):
    _, cfg_t, _, tp = case(rng, 32, 32, 16)
    cfg_t, b, _ = port_forward(tp, cfg_t)
    with pytest.raises(ValueError):
        trf.forward_flat(b._replace(rows=b.rows.to("meta")), cfg_t, 16,
                         cfg_t.flat_max_chunks)


def test_cli_flat_fit_on_cpu(tmp_path, capsys):
    rc = cli.main([MINI, "--splats", "40", "--iters", "2", "--log-every",
                   "1", "--device", "cpu", "--binning", "flat", "--out",
                   str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "0 itr, mse" in out and "1 itr, mse" in out
    assert (tmp_path / "render_final.png").read_bytes()[:8] \
        == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("layout", ["window"])
def test_cli_unported_layouts_exit_2(tmp_path, capsys, layout):
    """Layouts gs2d_tpu's CLI does not offer exit 2 through argparse."""
    with pytest.raises(SystemExit) as e:
        cli.main([MINI, "--splats", "40", "--iters", "1", "--device", "cpu",
                  "--binning", layout, "--out", str(tmp_path)])
    assert e.value.code == 2
    assert f"invalid choice: '{layout}'" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The expansion's dispatch: CPU tensors run the plain twin, CUDA tensors the
# kernels of csrc/tiles_flat.cu (held to the twin on the card by
# tests/test_torch_cuda.py), any other device raises.
# ---------------------------------------------------------------------------

EXPAND_SOURCE = os.path.join(REPO, "gs2d_tpu_torch", "csrc", "tiles_flat.cu")
EXPAND_ENTRIES = ("gs2d_expand_count", "gs2d_expand_emit",
                  "gs2d_expand_trig")


@pytest.mark.parametrize("margin,band", [(0.0, None), (2.0, (2, 2))])
def test_expansion_runs_the_plain_twin_on_cpu(rng, monkeypatch, margin,
                                              band):
    """CPU tensors take _expand_plain, whose binning is JAX's; the kernel
    path is never entered and the launch counter stays 0."""
    cfg_j, cfg_t, jp, tp = case(rng, 120, 8, 8)
    kw = {} if band is None else dict(band_row0=band[0], band_rows=band[1])
    calls = []
    plain = ttlf._expand_plain
    monkeypatch.setattr(ttlf, "_expand_plain",
                        lambda *a, **k: calls.append(a) or plain(*a, **k))

    def refuse(*a, **k):
        raise AssertionError("the kernel path ran on CPU tensors")

    monkeypatch.setattr(ttlf, "_expand_cuda", refuse)
    ttlf.reset_launch_counts()
    got = ttlf.bin_splats_flat(tp, cfg_t, 256, kc=8, margin=margin, **kw)
    want = jtlf.bin_splats_flat(jp, cfg_j, 256, kc=8, margin=margin, **kw)
    assert len(calls) == 1 and ttlf.launches == {"expand_flat": 0}
    for f in ("ids", "start", "count", "n_dropped"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_expansion_refuses_other_devices(rng):
    _, cfg_t, _, tp = case(rng, 16, 8, 8)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ttlf.bin_splats_flat(tp.to("meta"), cfg_t, 64, kc=8)


def test_expansion_counter_is_a_launch_counter():
    """The expansion's counter is one of train/graphs.launch_counters, so a
    captured step's replays add its launches as they add every kernel's."""
    from gs2d_tpu_torch.train import graphs

    assert any(c is ttlf.launches for c in graphs.launch_counters())


@pytest.mark.parametrize("name", EXPAND_ENTRIES)
def test_expansion_entry_points_are_in_the_source(name):
    """Every SIGNATURES entry of the expansion is a C entry point of
    csrc/tiles_flat.cu, with as many parameters as ctypes passes it."""
    from gs2d_tpu_torch.ops import _build

    src = open(EXPAND_SOURCE).read()
    head = src.index(f"int {name}(")
    params = src[head:src.index(")", head)].split("(", 1)[1]
    assert len(params.split(",")) == len(_build.SIGNATURES[name])


def emulate_emission(tp, cfg, m_cap, block=256, band_row0=0, band_rows=None,
                     margin=0.0):
    """csrc/tiles_flat.cu's schedule in numpy: the per-splat counts, their
    inclusive scan, each block's splats with the starts in shared memory
    (INT_MAX past the population), its rows walked with the branchless
    owner search, the grid's fill of the dead rows, dropped_exp. The box
    and the cull are the plain twin's per-splat and per-pair values."""
    (tx0, tx1, ty0, ty1, off), (px, py, a, b, d, k2) = \
        ttl._bbox_and_quad(tp, cfg, margin)
    if band_rows is None:
        band_rows, band_row0 = cfg.n_tiles_y, 0
    else:
        ty0, ty1, off = ttl._band_clip(ty0, ty1, off, band_row0, band_rows)
    w_t = (tx1 - tx0 + 1).numpy()
    cnt = np.where(off.numpy(), 0, w_t * (ty1 - ty0 + 1).numpy())
    incl = np.cumsum(cnt).astype(np.int64)
    n, total = len(cnt), int(incl[-1])
    dead = band_rows * cfg.n_tiles_x
    tile_e = np.full(m_cap, -7, np.int64)
    splat_e = np.full(m_cap, -7, np.int64)
    for base in range(0, n, block):
        idx = np.arange(base, base + block)
        s_start = np.where(idx < n, np.concatenate([[0], incl])[
            np.minimum(idx, n - 1)], np.iinfo(np.int32).max)
        end = min(int(incl[min(base + block, n) - 1]), m_cap)
        e = np.arange(max(int(s_start[0]), 0), end)
        o = np.zeros_like(e)
        step = block // 2
        while step:
            o = np.where(s_start[o + step] <= e, o + step, o)
            step //= 2
        owner = base + o
        rank = e - s_start[o]
        wb = np.maximum(w_t[owner], 1)
        ly = rank // wb
        ty = ty0.numpy()[owner] + ly
        tx = tx0.numpy()[owner] + (rank - ly * wb)
        own = torch.from_numpy(owner)
        live = np.ones(len(e), bool)
        if cfg.exact_cull:
            live = ttl.tile_may_touch(
                px[own], py[own], a[own], b[own], d[own],
                torch.from_numpy(tx), torch.from_numpy(ty + band_row0), cfg,
                margin, k2=None if k2 is None else k2[own]).numpy()
        tile_e[e] = np.where(live, ty * cfg.n_tiles_x + tx, dead)
        splat_e[e] = np.where(live, owner, -1)
    tile_e[total:] = dead
    splat_e[total:] = -1
    return tile_e, splat_e, max(total - m_cap, 0)


@pytest.mark.parametrize("case_name", ["tuned", "overflow", "band-margin",
                                       "offscreen-runs"])
def test_emission_schedule_equals_the_plain_twin(rng, case_name):
    """The emission kernel's block schedule and owner search, emulated with
    blocks of 4 and 256 splats, write every row the plain twin writes, the
    same integers, and no other row."""
    n = 700
    cfg_j, cfg_t, jp, tp = case(rng, n, 8, 8)
    kw = {}
    m_cap = 4096
    if case_name == "overflow":
        m_cap = 256
    elif case_name == "band-margin":
        kw = dict(band_row0=2, band_rows=3, margin=2.0)
    elif case_name == "offscreen-runs":  # long runs of empty splats
        tp.pos[100:400] += 10.0 * W
    want = ttlf._expand_plain(tp, cfg_t, m_cap, **kw)
    for block in (4, 256):
        got = emulate_emission(tp, cfg_t, m_cap, block=block, **kw)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())
        assert got[2] == int(want[2])
    if case_name == "overflow":
        assert int(want[2]) > 0


# ---- the non-finite mask before kernel 10 (its plain twin) -----------------

FLAT_SOURCE = os.path.join(REPO, "gs2d_tpu_torch", "csrc", "render_flat.cu")
WALK_SOURCE = os.path.join(REPO, "gs2d_tpu_torch", "csrc", "patch_walk.cuh")
# The fields the cull tests for finiteness (cull_slot: kPx..kOp, kH among
# them), and the others.
CULLED_FIELDS = list(range(ttl.FIELD_PX, ttl.FIELD_OP + 1))
OTHER_FIELDS = list(range(ttl.FIELD_OP + 1, ttl.N_FIELDS))


def mask_bits(words, m):
    """The first m bits of int32 mask words, row order."""
    w = [int(x) & 0xFFFFFFFF for x in words.tolist()]
    return [(w[r // 32] >> (r % 32)) & 1 for r in range(m)]


def benign_rows(m):
    return ttl.pad_row("cpu").repeat(m, 1)


def test_nonfinite_mask_words_hold_the_rows_in_order(rng):
    """Bit j of word w is row 32 w + j's flag, on seeded rows with
    non-finite values planted at random rows and culled fields."""
    rows = torch.from_numpy(rng.normal(size=(320, ttl.N_FIELDS))
                            .astype(np.float32))
    hit = rng.choice(320, 48, replace=False)
    for i, r in enumerate(hit):
        rows[r, CULLED_FIELDS[i % 10]] = (np.nan, np.inf, -np.inf)[i % 3]
    words = trf._nonfinite_mask_plain(rows)
    assert words.dtype == torch.int32 and tuple(words.shape) == (10,)
    assert mask_bits(words, 320) == [int(r in set(hit.tolist()))
                                     for r in range(320)]


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf],
                         ids=["nan", "inf", "-inf"])
@pytest.mark.parametrize("field", CULLED_FIELDS)
def test_nonfinite_mask_flags_each_culled_field(field, value):
    """A NaN, +inf or -inf in any field the cull tests flags that row and
    no other: cull_slot's bad, FIELD_H included (its loop runs kPx..kOp)."""
    rows = benign_rows(64)
    rows[37, field] = float(value)
    assert trf._nonfinite_mask_plain(rows).tolist() == [0, 1 << 5]


@pytest.mark.parametrize("field", OTHER_FIELDS)
def test_nonfinite_mask_ignores_the_other_fields(field):
    """Non-finite values past FIELD_OP (the scales, rotation and validity
    fields, which the walk never reads) leave the row unflagged."""
    rows = benign_rows(64)
    rows[3, field] = float("nan")
    rows[40, field] = float("inf")
    assert trf._nonfinite_mask_plain(rows).tolist() == [0, 0]


@pytest.mark.parametrize("m", [1, 16, 31, 32, 33, 70])
def test_nonfinite_mask_ragged_last_word(m):
    """ceil(M / 32) words; the bits past M are clear when every row is
    flagged."""
    rows = benign_rows(m)
    rows[:, ttl.FIELD_CR] = float("nan")
    words = trf._nonfinite_mask_plain(rows)
    assert tuple(words.shape) == (-(-m // 32),)
    w = [int(x) & 0xFFFFFFFF for x in words.tolist()]
    assert w[:-1] == [0xFFFFFFFF] * (len(w) - 1)
    assert w[-1] == (1 << (m - 32 * (len(w) - 1))) - 1


def test_nonfinite_mask_is_the_culls_test_in_the_source():
    """The mask kernel tests the rows as cull_slot does: the same loop over
    kPx..kOp with the same isfinite."""
    loop = "for (int f = kPx; f <= kOp; ++f)"
    mask_src = open(FLAT_SOURCE).read()
    body = mask_src[mask_src.index("nonfinite_mask_kernel("):]
    walk_src = open(WALK_SOURCE).read()
    cull = walk_src[walk_src.index("Slot cull_slot("):]
    assert f"{loop} bad |= !isfinite(row[f]);" in body[:body.index("}\n")]
    assert f"{loop} sl.bad |= !isfinite(row[f]);" in cull[:cull.index("}\n")]


@pytest.mark.parametrize("name", ["gs2d_fwd_flat",
                                  "gs2d_flat_nonfinite_mask"])
def test_kernel_10_entry_points_are_in_the_source(name):
    """Kernel 10's and the mask pass's SIGNATURES entries are C entry points
    of csrc/render_flat.cu with as many parameters as ctypes passes."""
    from gs2d_tpu_torch.ops import _build

    src = open(FLAT_SOURCE).read()
    head = src.index(f"int {name}(")
    params = src[head:src.index(")", head)].split("(", 1)[1]
    assert len(params.split(",")) == len(_build.SIGNATURES[name])


def test_mask_counter_is_a_launch_counter():
    """The mask pass counts in render_flat.launches, one of
    train/graphs.launch_counters, so captured replays add it."""
    from gs2d_tpu_torch.train import graphs

    assert "fwd_flat_mask" in trf.launches
    assert any(c is trf.launches for c in graphs.launch_counters())
