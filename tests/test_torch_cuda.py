"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the scanned fit's captured step (a CUDA graph, lazy rebinning under a
conditional node) against the eager step; the flat binning's expansion
kernels against their plain twin, alone, in render_flat and in captured
fits.

Every test is marked ``cuda`` and skips where no GPU is visible (a CUDA
kernel has no CPU mode). This file imports neither jax nor gs2d_tpu, so it
also runs on a GPU host without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import probes
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_dense as rdn
from gs2d_tpu_torch.ops import render_flat as rf
from gs2d_tpu_torch.ops import render_mxu as rm
from gs2d_tpu_torch.ops import render_resident as rr
from gs2d_tpu_torch.ops import render_window as rw
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.ops import tiles_flat as tlf
from gs2d_tpu_torch.params import FIELDS, GaussianParams, params_from_numpy
from gs2d_tpu_torch.scripts.roofline import flat_listed_rows
from gs2d_tpu_torch.utils.profiling import device_time

pytestmark = pytest.mark.cuda

H, W = 48, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def population(seed, n, width, height, opacity=(0.3, 1.0)):
    """Seeded random splats (the distribution of tests/helpers.py)."""
    rng = np.random.default_rng(seed)
    return {
        "pos": np.stack([rng.uniform(-3, width + 3, n),
                         rng.uniform(-3, height + 3, n)], -1),
        "sx": rng.uniform(1.5, 12.0, n), "sy": rng.uniform(1.5, 12.0, n),
        "rot": rng.uniform(0.0, np.pi, n),
        "color": rng.uniform(0.0, 1.0, (n, 3)),
        "opacity": rng.uniform(*opacity, n),
    }, rng.uniform(0, 1, (height, width, 3)).astype(np.float32)


def inputs(dev, seed, n, tile_h, k=128):
    cfg = SplatConfig(width=W, height=H, n_splats=n, tile_h=tile_h,
                      max_splats_per_tile=k)
    d, ref = population(seed, n, W, H)
    p = params_from_numpy({f: v.astype(np.float32) for f, v in d.items()},
                          dev)
    b = tl.bin_splats(p, cfg, k, ids_only=True)
    assert int(b.n_dropped) == 0
    return (cfg, rr.resident_table(p, cfg), rr._remap_ids(b, n), b.count,
            rd.pad_ref_chw(ref, cfg, dev))


@pytest.mark.parametrize("n,tile_h", [(130, 8), (130, 32), (64, 16)])
def test_kernels_match_plain(dev, n, tile_h):
    cfg, table, ids, count, ref = inputs(dev, n + tile_h, n, tile_h)
    before = dict(rr.launches)
    c_k, g_k = rr._l2_resident_cuda(table, ids, count, ref, n, cfg)
    c_p, g_p = rr._l2_resident_plain(table, ids, count, ref, n, cfg)
    torch.cuda.synchronize()
    torch.testing.assert_close(c_k, c_p, rtol=0, atol=1e-6)
    atol = 1e-4 * max(1.0, float(g_p.abs().max()))
    torch.testing.assert_close(g_k, g_p, rtol=0, atol=atol)
    f_k, t_k = rr._fwd_resident_cuda(table, ids, count, cfg)
    f_p, t_p = rr._fwd_resident_plain(table, ids, count, cfg)
    torch.testing.assert_close(f_k, f_p, rtol=0, atol=1e-6)
    torch.testing.assert_close(t_k, t_p, rtol=0, atol=1e-6)
    assert rr.launches["l2_resident"] == before["l2_resident"] + 1
    assert rr.launches["fwd_resident"] == before["fwd_resident"] + 1


def test_l2_kernel_repeats_bit_for_bit(dev):
    cfg, table, ids, count, ref = inputs(dev, 7, 130, 32)
    a = rr._l2_resident_cuda(table, ids, count, ref, 130, cfg)
    b = rr._l2_resident_cuda(table, ids, count, ref, 130, cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_alpha_one_finite_on_card(dev):
    cfg = SplatConfig(width=W, height=H, n_splats=2, tile_h=8,
                      max_splats_per_tile=8)
    p = params_from_numpy({
        "pos": np.array([[10.5, 12.5], [10.5, 12.5]], np.float32),
        "sx": np.array([3.0, 5.0], np.float32),
        "sy": np.array([2.0, 4.0], np.float32),
        "rot": np.array([0.3, 1.0], np.float32),
        "color": np.array([[1, 0, 0], [0, 1, 0]], np.float32),
        "opacity": np.ones(2, np.float32)}, dev)
    ref = rd.pad_ref_chw(np.full((H, W, 3), 0.25, np.float32), cfg, dev)
    color, grads, _ = rr.l2_step_resident(p, ref, cfg, 8)
    assert float(color[12, 10, 0]) == 1.0
    for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
        assert torch.isfinite(getattr(grads, f)).all(), f


def test_unsupported_tile_shape_raises(dev):
    cfg, table, ids, count, ref = inputs(dev, 3, 16, 8)
    with pytest.raises(ValueError):
        rr._fwd_resident_cuda(table, ids, count, cfg.replace(tile_h=4))


def flat_params(dev, seed, n, opacity=(0.3, 1.0)):
    d, ref = population(seed, n, W, H, opacity)
    return params_from_numpy({f: v.astype(np.float32) for f, v in d.items()},
                             dev), ref


def flat_fields(dev, seed, n, cfg):
    """The packed fields of flat_inputs' population (kernel 11's boxes)."""
    return tl.packed_fields(flat_params(dev, seed, n)[0], cfg.splat_bounds)


def flat_inputs(dev, seed, n, tile_h, kc):
    """A flat binning and the L2 backward's planes for a seeded population."""
    cfg = SplatConfig(width=W, height=H, n_splats=n, tile_h=tile_h,
                      flat_chunk=kc, binning="flat")
    d, ref = population(seed, n, W, H)
    p = params_from_numpy({f: v.astype(np.float32) for f, v in d.items()},
                          dev)
    cfg = rf.tune_flat_config(p, cfg)
    b = tlf.bin_splats_flat(p, cfg, cfg.flat_capacity, kc=kc,
                            max_chunks=cfg.flat_max_chunks)
    assert int(b.n_dropped) == 0
    return cfg, b, rd.pad_ref_chw(ref, cfg, dev)[0]


@pytest.mark.parametrize("n,tile_h,kc,sat", [
    (200, 32, 16, False), (200, 64, 32, False), (300, 32, 32, True),
    (300, 64, 16, True)])
def test_flat_kernels_match_plain(dev, monkeypatch, n, tile_h, kc, sat):
    if sat:
        monkeypatch.setattr(rd, "SAT_WALK_THRESHOLD", 1)
    cfg, b, ref = flat_inputs(dev, n + tile_h + kc, n, tile_h, kc)
    mc = cfg.flat_max_chunks
    before = dict(rf.launches)
    c_k, t_k = rf._fwd_flat_cuda(b.rows, b.start, b.count, cfg, kc, mc)
    c_p, t_p = rf._fwd_flat_plain(b.rows, b.start, b.count, cfg, kc, mc)
    torch.cuda.synchronize()
    torch.testing.assert_close(c_k, c_p, rtol=0, atol=1e-6)
    torch.testing.assert_close(t_k, t_p, rtol=0, atol=1e-6)
    cin, tin = rd.identity_carry(cfg, dev)
    args = (b.rows, b.ids, b.start, b.count, c_p, (c_p - ref).contiguous(),
            cin, tin, n, cfg, kc, mc)
    m_k, g_k = rf._bwd_flat_cuda(*args, fields=flat_fields(dev, n + tile_h
                                                           + kc, n, cfg))
    m_p, g_p = rf._bwd_flat_plain(*args)
    torch.cuda.synchronize()
    for got, want in ((m_k, m_p), (g_k, g_p)):
        atol = 1e-4 * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=0, atol=atol)
    assert rf.launches["fwd_flat"] == before["fwd_flat"] + 1
    assert rf.launches["bwd_flat"] == before["bwd_flat"] + 1


def test_flat_backward_repeats_bit_for_bit_with_carry(dev):
    cfg, b, ref = flat_inputs(dev, 5, 250, 32, 32)
    kc, mc = cfg.flat_chunk, cfg.flat_max_chunks
    c_in, t_in = rf._fwd_flat_plain(b.rows, b.start, b.count, cfg, kc, mc)
    gen = torch.Generator(dev).manual_seed(0)
    g = torch.randn(c_in.shape, generator=gen, device=dev)
    args = (b.rows, b.ids, b.start, b.count, c_in, g, c_in * 0.5,
            t_in * 0.5, 250, cfg, kc, mc)
    fields = flat_fields(dev, 5, 250, cfg)
    first = rf._bwd_flat_cuda(*args, fields=fields)
    again = rf._bwd_flat_cuda(*args, fields=fields)
    plain = rf._bwd_flat_plain(*args)
    torch.cuda.synchronize()
    for x, y, z in zip(first, again, plain):
        assert torch.equal(x, y)
        atol = 1e-4 * max(1.0, float(z.abs().max()))
        torch.testing.assert_close(x, z, rtol=0, atol=atol)


def test_flat_unsupported_tile_shape_raises(dev):
    cfg, b, _ = flat_inputs(dev, 3, 64, 32, 16)
    with pytest.raises(ValueError):
        rf._fwd_flat_cuda(b.rows, b.start, b.count, cfg.replace(tile_h=16),
                          16, cfg.flat_max_chunks)


def flat_and_dense(dev, seed, n, tile_h, kc, nan_splat=None):
    """One population binned both ways (the dense K at the largest count, no
    drop); ``nan_splat``'s position NaN in both layouts' pregathered rows.
    Returns (params, cfg, flat binning, flat rows, dense binning, dense
    rows, ref (3, Hp, Wp))."""
    p, ref = flat_params(dev, seed, n)
    cfg = rf.tune_flat_config(p, SplatConfig(
        width=W, height=H, n_splats=n, tile_h=tile_h, flat_chunk=kc,
        binning="flat"))
    b = tlf.bin_splats_flat(p, cfg, cfg.flat_capacity, kc=kc,
                            max_chunks=cfg.flat_max_chunks)
    bd = tl.bin_splats(p, cfg.replace(binning="dense"),
                       max(1, int(b.count.max())))
    assert int(b.n_dropped) == 0 and int(bd.n_dropped) == 0
    assert torch.equal(b.count, bd.count)
    rows, tp = b.rows.clone(), bd.tile_params.clone()
    if nan_splat is not None:
        rows[b.ids == nan_splat, tl.FIELD_PX] = float("nan")
        tp[bd.ids == nan_splat, tl.FIELD_PX] = float("nan")
    return p, cfg, b, rows, bd, tp, rd.pad_ref_chw(ref, cfg, dev)[0]


@pytest.mark.parametrize("case", ["200/32/16", "300/32/32", "200/64/32",
                                  "300/64/16/sat", "carry", "nan"])
def test_flat_kernels_equal_dense_bit_for_bit(dev, monkeypatch, case):
    """Kernels 10 and 11 on warp patches against the dense kernels 6/7 and
    the chunk reference (the backward kernels 8/9 had before their warp
    patches), which keep the one-block-per-tile chunk walk over the same
    rows in the same order: colour, T, the per-pair moments matched by
    (tile, slot) and the (9, n) splat sums, bit for bit; kernel 11 repeats.
    The NaN case (splat 40 at a NaN position in both layouts) holds where
    no 32-row pass of its tiles saturates, the condition under which the
    chunk walk's block-wide exits stop nowhere (render_flat.cu)."""
    parts = case.split("/")
    if "sat" in parts:
        monkeypatch.setattr(rd, "SAT_WALK_THRESHOLD", 1)
    n, tile_h, kc = ((int(parts[0]), int(parts[1]), int(parts[2]))
                     if parts[0].isdigit() else (130, 32, 32))
    nan = 40 if case == "nan" else None
    p, cfg, b, rows, bd, tp, ref = flat_and_dense(dev, n + kc, n, tile_h, kc,
                                                  nan)
    mc = cfg.flat_max_chunks
    c_k, t_k = rf._fwd_flat_cuda(rows, b.start, b.count, cfg, kc, mc)
    c_d, t_d = rdn._fwd_dense_cuda(tp, bd.count, cfg)
    if case == "carry":
        cin, tin = 0.5 * c_d, (0.5 * t_d).contiguous()
        gc = random_cotangent(dev, cfg, n)
    else:
        cin, tin = rd.identity_carry(cfg, dev)
        gc = (c_d - ref).contiguous()
    args = (c_d, gc, cin, tin, n, cfg)
    fields = tl.packed_fields(p, cfg.splat_bounds)
    m_k, g_k = rf._bwd_flat_cuda(rows, b.ids, b.start, b.count, *args, kc,
                                 mc, fields=fields)
    m_k2, g_k2 = rf._bwd_flat_cuda(rows, b.ids, b.start, b.count, *args, kc,
                                   mc, fields=fields)
    part_d, g_d = rdn._bwd_chunk_cuda(tp, bd.ids, bd.count, *args)
    torch.cuda.synchronize()
    k = torch.arange(tp.shape[1], device=dev)
    listed = k[None] < b.count[:, None]
    pair = (b.start[:, None] + k[None]).long()[listed]
    assert_same_bits(c_k, c_d)
    assert_same_bits(t_k, t_d)
    assert_same_bits(m_k[pair], part_d[listed])
    assert_same_bits(g_k, g_d)
    assert torch.equal(m_k.nan_to_num(), m_k2.nan_to_num())
    assert torch.equal(g_k.nan_to_num(), g_k2.nan_to_num())
    unlisted = torch.ones(m_k.shape[0], dtype=torch.bool, device=dev)
    unlisted[pair] = False
    assert bool((m_k[unlisted] == 0).all())
    if nan is not None:
        assert torch.isnan(g_k).any() and torch.isfinite(c_k).any()
        tiles = rd.to_tiles(t_d[None], cfg)[0].reshape(
            cfg.n_tiles_x * cfg.n_tiles_y, -1, 32 * cfg.tile_w)
        assert bool((tiles >= cfg.min_throughput).any(dim=-1).all())
    else:
        assert torch.isfinite(g_k).all()


def test_flat_partials_never_read_unwritten(dev):
    """Kernel 11's partial scratch is not zeroed: a buffer pre-filled with
    NaN gives the same moments bit for bit."""
    cfg, b, ref = flat_inputs(dev, 11, 300, 64, 32)
    kc, mc = cfg.flat_chunk, cfg.flat_max_chunks
    c, _ = rf._fwd_flat_cuda(b.rows, b.start, b.count, cfg, kc, mc)
    cin, tin = rd.identity_carry(cfg, dev)
    args = (b.rows, b.ids, b.start, b.count, c, (c - ref).contiguous(), cin,
            tin, 300, cfg, kc, mc)
    fields = flat_fields(dev, 11, 300, cfg)
    filled = torch.full(rf.partial_shape(cfg, b.rows.shape[0]),
                        float("nan"), device=dev)
    m_a, g_a = rf._bwd_flat_cuda(*args, fields=fields, partial=filled)
    m_b, g_b = rf._bwd_flat_cuda(*args, fields=fields)
    torch.cuda.synchronize()
    assert torch.isfinite(m_a).all() and torch.isfinite(g_a).all()
    assert torch.equal(m_a, m_b) and torch.equal(g_a, g_b)


@pytest.mark.parametrize("tile_h", [32, 64])
def test_flat_survivors_are_the_plain_mask(dev, tile_h):
    """Each warp's survivors in kernels 10 and 11 are listed_cover_mask's
    slots of the flat runs, patch by patch; each walks at most them."""
    cfg, b, ref = flat_inputs(dev, 3 + tile_h, 300, tile_h, 32)
    kc, mc = cfg.flat_chunk, cfg.flat_max_chunks
    mask = rr.listed_cover_mask(flat_listed_rows(b, dev), b.count, cfg,
                                rr.patch_rows())
    want = mask.sum(dim=-1).reshape(-1).to(torch.int32)
    got = [torch.full((want.numel(), 2), -1, dtype=torch.int32, device=dev)
           for _ in range(2)]
    c, _ = rf._fwd_flat_cuda(b.rows, b.start, b.count, cfg, kc, mc,
                             walked=got[0])
    cin, tin = rd.identity_carry(cfg, dev)
    rf._bwd_flat_cuda(b.rows, b.ids, b.start, b.count, c,
                      (c - ref).contiguous(), cin, tin, 300, cfg, kc, mc,
                      fields=flat_fields(dev, 3 + tile_h, 300, cfg),
                      walked=got[1])
    torch.cuda.synchronize()
    for walked in got:
        assert torch.equal(walked[:, 0], want)
        assert bool((walked[:, 1] <= walked[:, 0]).all())
        assert bool((walked[:, 1] >= 0).all())


def test_flat_boxes_are_the_binnings(dev):
    """Kernel 11's splat sum searches each splat's tile box, computed in the
    kernel from the packed fields: it equals tiles._bbox_and_quad's, empty
    for offscreen splats."""
    cfg, b, ref = flat_inputs(dev, 21, 300, 32, 32)
    p, _ = flat_params(dev, 21, 300)
    p.pos[:40] += torch.tensor([4.0 * W, -3.0 * H], device=dev)
    fields = tl.packed_fields(p, cfg.splat_bounds)
    kc, mc = cfg.flat_chunk, cfg.flat_max_chunks
    cin, tin = rd.identity_carry(cfg, dev)
    boxes = torch.full((300, 4), -7, dtype=torch.int32, device=dev)
    rf._bwd_flat_cuda(b.rows, b.ids, b.start, b.count, cin, cin, cin, tin,
                      300, cfg, kc, mc, fields=fields, boxes=boxes)
    torch.cuda.synchronize()
    (tx0, tx1, ty0, ty1, off), _ = tl._bbox_and_quad(p, cfg)
    on = ~off
    assert int(off.sum()) >= 40
    want = torch.stack([tx0, tx1, ty0, ty1], dim=1).to(torch.int32)
    assert torch.equal(boxes[on], want[on])
    assert bool((boxes[off, 2] > boxes[off, 3]).all())


def random_cotangent(dev, cfg, seed):
    gen = torch.Generator(dev).manual_seed(seed)
    return torch.randn((3, cfg.padded_height, cfg.padded_width),
                       generator=gen, device=dev)


@pytest.mark.parametrize("n,tile_h", [(130, 8), (130, 32)])
def test_bwd_resident_matches_plain_and_repeats(dev, n, tile_h):
    """Kernel 3 under a random cotangent from a non-identity carry-in."""
    cfg, table, ids, count, _ = inputs(dev, n + tile_h, n, tile_h)
    fin, trans = rr._fwd_resident_plain(table, ids, count, cfg)
    args = (table, ids, count, fin[0].contiguous(),
            random_cotangent(dev, cfg, n), 0.5 * fin[0],
            (0.5 * trans[0]).contiguous(), n, cfg)
    before = rr.launches["bwd_resident"]
    first = rr._bwd_resident_cuda(*args)
    again = rr._bwd_resident_cuda(*args)
    plain = rr._bwd_resident_plain(*args)
    torch.cuda.synchronize()
    assert rr.launches["bwd_resident"] == before + 2
    assert torch.equal(first, again)
    atol = 1e-4 * max(1.0, float(plain.abs().max()))
    torch.testing.assert_close(first, plain, rtol=0, atol=atol)


def dense_inputs(dev, seed, n, tile_h, k):
    cfg = SplatConfig(width=W, height=H, n_splats=n, tile_h=tile_h,
                      max_splats_per_tile=k, binning="dense")
    d, ref = population(seed, n, W, H)
    p = params_from_numpy({f: v.astype(np.float32) for f, v in d.items()},
                          dev)
    b = tl.bin_splats(p, cfg, k)
    assert int(b.n_dropped) == 0
    return cfg, b, rd.pad_ref_chw(ref, cfg, dev)


@pytest.mark.parametrize("n,tile_h,k,sat", [
    (200, 32, 256, False), (300, 32, 512, False), (200, 64, 256, False),
    (300, 64, 512, True)])
def test_dense_kernels_match_plain(dev, monkeypatch, n, tile_h, k, sat):
    if sat:
        monkeypatch.setattr(rd, "SAT_WALK_THRESHOLD", 1)
    cfg, b, ref = dense_inputs(dev, n + tile_h + k, n, tile_h, k)
    tp, ids, count = b.tile_params, b.ids, b.count
    before = dict(rdn.launches)
    c_k, t_k = rdn._fwd_dense_cuda(tp, count, cfg)
    c_p, t_p = rdn._fwd_dense_plain(tp, count, cfg)
    torch.cuda.synchronize()
    torch.testing.assert_close(c_k, c_p, rtol=0, atol=1e-6)
    torch.testing.assert_close(t_k, t_p, rtol=0, atol=1e-6)
    args = (tp, ids, count, c_p, random_cotangent(dev, cfg, n), 0.5 * c_p,
            (0.5 * t_p).contiguous(), n, cfg)
    first = rdn._bwd_dense_cuda(*args)
    again = rdn._bwd_dense_cuda(*args)
    plain = rdn._bwd_dense_plain(*args)
    first = (rr.patch_slot_sums(first[0], count, rr.patch_passes(cfg)),
             first[1])
    again = (rr.patch_slot_sums(again[0], count, rr.patch_passes(cfg)),
             again[1])
    l2_k = rdn._l2_dense_cuda(tp, ids, count, ref, n, cfg)
    l2_k = (l2_k[0], rr.patch_slot_sums(l2_k[1], count, rr.patch_passes(cfg)),
            l2_k[2])
    l2_p = rdn._l2_dense_plain(tp, ids, count, ref, n, cfg)
    torch.cuda.synchronize()
    for x, y in zip(first, again):
        assert torch.equal(x, y)
    torch.testing.assert_close(l2_k[0], l2_p[0], rtol=0, atol=1e-6)
    for got, want in (*zip(first, plain), *zip(l2_k[1:], l2_p[1:])):
        atol = 1e-4 * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=0, atol=atol)
    assert rdn.launches == {"fwd_dense": before["fwd_dense"] + 1,
                            "bwd_dense": before["bwd_dense"] + 2,
                            "l2_dense": before["l2_dense"] + 1,
                            "fwd_chunk": before["fwd_chunk"],
                            "bwd_chunk": before["bwd_chunk"]}


def test_dense_l2_equals_resident_l2_bit_for_bit(dev):
    """The dense and resident L2 kernels share the per-pixel arithmetic and
    the moments' sum order, so on one population they agree exactly."""
    cfg, table, ids, count, ref = inputs(dev, 9, 130, 32, k=256)
    c_r, g_r = rr._l2_resident_cuda(table, ids, count, ref, 130, cfg)
    d, _ = population(9, 130, W, H)
    p = params_from_numpy({f: v.astype(np.float32) for f, v in d.items()},
                          dev)
    b = tl.bin_splats(p, cfg.replace(binning="dense"), 256)
    c_d, _, g_d = rdn._l2_dense_cuda(b.tile_params, b.ids, b.count, ref, 130,
                                     cfg)
    torch.cuda.synchronize()
    assert torch.equal(c_r, c_d[None])
    assert torch.equal(g_r[:9, :130], g_d)


def test_dense_unsupported_tile_shape_raises(dev):
    cfg, b, _ = dense_inputs(dev, 3, 64, 32, 64)
    with pytest.raises(ValueError):
        rdn._fwd_dense_cuda(b.tile_params, b.count, cfg.replace(tile_h=16))


@pytest.mark.parametrize("n", [130, 300])
def test_resident_kernels_take_64_row_tiles(dev, n):
    """Kernels 1-3 walk a 64x128 tile in two 32-row passes."""
    cfg, table, ids, count, ref = inputs(dev, n + 64, n, 64, k=512)
    c_k, g_k = rr._l2_resident_cuda(table, ids, count, ref, n, cfg)
    c_p, g_p = rr._l2_resident_plain(table, ids, count, ref, n, cfg)
    f_k, t_k = rr._fwd_resident_cuda(table, ids, count, cfg)
    f_p, t_p = rr._fwd_resident_plain(table, ids, count, cfg)
    args = (table, ids, count, f_p[0].contiguous(),
            random_cotangent(dev, cfg, n), 0.5 * f_p[0],
            (0.5 * t_p[0]).contiguous(), n, cfg)
    m_k = rr._bwd_resident_cuda(*args)
    m_p = rr._bwd_resident_plain(*args)
    torch.cuda.synchronize()
    for got, want in ((c_k, c_p), (f_k, f_p), (t_k, t_p)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    for got, want in ((g_k, g_p), (m_k, m_p)):
        atol = 1e-4 * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=0, atol=atol)


def test_resident_kernels_refuse_too_much_shared_memory(dev):
    """K = 4096 table rows, which needed 256 KiB of shared memory in the
    one-block-per-tile kernel 3 and were refused: the warp-patch kernels 1,
    3 and 12 stage nothing in shared memory, take that K and match their
    plain versions (the name is the test's history)."""
    cfg, table, ids, count, ref = inputs(dev, 4, 16, 32, k=4096)
    fin, trans = rr._fwd_resident_plain(table, ids, count, cfg)
    args = (table, ids, count, fin[0].contiguous(),
            random_cotangent(dev, cfg, 4), 0.5 * fin[0],
            (0.5 * trans[0]).contiguous(), 16, cfg)
    m_k = rr._bwd_resident_cuda(*args)
    m_p = rr._bwd_resident_plain(*args)
    c_k, g_k = rr._l2_resident_cuda(table, ids, count, ref, 16, cfg)
    c_w, g_w = full_width_window(table, ids, count, ref, 16, cfg)
    c_p, g_p = rr._l2_resident_plain(table, ids, count, ref, 16, cfg)
    torch.cuda.synchronize()
    assert torch.equal(c_w, c_k) and torch.equal(g_w, g_k)
    torch.testing.assert_close(c_k, c_p, rtol=0, atol=1e-6)
    for got, want in ((g_k, g_p), (m_k, m_p)):
        atol = 1e-4 * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=0, atol=atol)


def test_window_kernel_equals_resident_at_full_width(dev):
    """Kernel 12 at W = n_pad: colour and moments equal kernel 1's bit for
    bit."""
    n = 300
    cfg, table, ids, count, ref = inputs(dev, 31, n, 32, k=512)
    b = tl.TileBinning(ids=torch.where(ids < n, ids, -1), count=count,
                       n_dropped=torch.zeros((), dtype=torch.int32))
    bases, escaped = rw.window_bases(b, n, rw._n_pad(n))
    before = rw.launches["l2_window"]
    c_w, g_w = rw._l2_window_cuda(table, ids, count, bases, ref, n, cfg,
                                  rw._n_pad(n))
    c_r, g_r = rr._l2_resident_cuda(table, ids, count, ref, n, cfg)
    torch.cuda.synchronize()
    assert rw.launches["l2_window"] == before + 1 and int(escaped) == 0
    assert torch.equal(c_w, c_r) and torch.equal(g_w, g_r)


def full_width_window(table, ids, count, ref, n, cfg):
    """Kernel 12 at W = n_pad, where it computes kernel 1's function."""
    b = tl.TileBinning(ids=torch.where(ids < n, ids, -1), count=count,
                       n_dropped=torch.zeros((), dtype=torch.int32))
    bases, _ = rw.window_bases(b, n, rw._n_pad(n))
    return rw._l2_window_cuda(table, ids, count, bases, ref, n, cfg,
                              rw._n_pad(n))


def nan_splat_inputs(dev, tile_h=32):
    """130 random splats with a NaN position at splat 40: every tile that
    lists it must come out NaN exactly where the unculled walk's does."""
    cfg, table, ids, count, ref = inputs(dev, 77, 130, tile_h)
    rows = table.reshape(-1, tl.N_FIELDS)
    rows[40, tl.FIELD_PX] = float("nan")
    return cfg, table, ids, count, ref


def assert_same_bits(got, want):
    """torch.equal on the finite entries and equal NaN masks."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


def chain(tp, ids, count, ref, n, cfg):
    """The in-call reference of the warp-patch L2 kernels (chip_smoke.py's
    chain): the forward reference, then gC = C - ref, then the backward
    reference (the kernels 6/7 and 8/9 had before their warp patches),
    which keep the one-block-per-tile chunk walk, over the rows tp
    (n_tiles, K, 16). Returns (colour, T, slot partials, moments (9, n))."""
    color, trans = rdn._fwd_chunk_cuda(tp, count, cfg)
    cin, tin = rd.identity_carry(cfg, tp.device)
    part, g9 = rdn._bwd_chunk_cuda(tp, ids, count, color,
                                   (color - ref[0]).contiguous(), cin, tin,
                                   n, cfg)
    return color, trans, part, g9


def gathered(table, ids):
    """The dense (n_tiles, K, 16) rows of a resident binning."""
    return table.reshape(-1, tl.N_FIELDS)[ids.long()].contiguous()


def patch_case(dev, case):
    """(cfg, table, ids, count, ref) of a case of the warp-patch tests:
    "n/tile_h" random populations, opacity-1 splats centred on pixel
    centres, and 130 random splats with a NaN position at splat 40."""
    if case == "nan":
        cfg, table, ids, count, ref = nan_splat_inputs(dev)
    elif case == "opacity-1":
        d, ref = population(5, 64, W, H, opacity=(1.0, 1.0))
        d["pos"][:16] = np.floor(d["pos"][:16]) + 0.5
        cfg = SplatConfig(width=W, height=H, n_splats=64, tile_h=32,
                          max_splats_per_tile=64)
        p = params_from_numpy({f: v.astype(np.float32)
                               for f, v in d.items()}, dev)
        b = tl.bin_splats(p, cfg, 64, ids_only=True)
        table, ids, count = (rr.resident_table(p, cfg), rr._remap_ids(b, 64),
                             b.count)
        ref = rd.pad_ref_chw(ref, cfg, dev)
    else:
        n, tile_h = map(int, case.split("/"))
        cfg, table, ids, count, ref = inputs(dev, n + tile_h, n, tile_h,
                                             k=512 if tile_h == 64 else 128)
    return cfg, table, ids, count, ref


@pytest.mark.parametrize("case", ["130/32", "64/64", "300/64", "opacity-1",
                                  "nan"])
def test_patch_kernels_equal_one_block_per_tile(dev, case):
    """Kernels 1, 12 (at W = n_pad) and 4/5 (on the table rows the ids
    name) on warp patches equal the one-block-per-tile chunk walk (chain)
    bit for bit: colour, moments, 4/5's slot partials; kernel 2's colour
    equals kernel 1's and its T the chain's."""
    cfg, table, ids, count, ref = patch_case(dev, case)
    n = cfg.n_splats
    tp = gathered(table, ids)
    c_ch, t_ch, part_ch, g_ch = chain(tp, ids, count, ref, n, cfg)
    c_k, g_k = rr._l2_resident_cuda(table, ids, count, ref, n, cfg)
    c_w, g_w = full_width_window(table, ids, count, ref, n, cfg)
    c_d, part_d, g_d = rdn._l2_dense_cuda(tp, ids, count, ref, n, cfg)
    f_k, t_k = rr._fwd_resident_cuda(table, ids, count, cfg)
    torch.cuda.synchronize()
    for color, moments in ((c_k[0], g_k[:9, :n]), (c_w[0], g_w[:9, :n]),
                           (c_d, g_d)):
        assert_same_bits(color, c_ch)
        assert_same_bits(moments, g_ch)
    assert_same_bits(rr.patch_slot_sums(part_d, count, rr.patch_passes(cfg)),
                     part_ch)
    assert_same_bits(f_k, c_k)
    assert_same_bits(t_k[0], t_ch)
    if case == "nan":
        assert torch.isnan(g_k).any() and torch.isfinite(c_k).any()


@pytest.mark.parametrize("n,tile_h,k,sat", [
    (200, 32, 256, False), (300, 32, 512, True), (300, 64, 512, True)])
def test_dense_l2_equals_the_chunk_walk(dev, monkeypatch, n, tile_h, k, sat):
    """Kernels 4/5 on a dense binning equal the chunk walk over the same
    tile_params bit for bit (the chunked member's saturating walk forced
    where ``sat``)."""
    if sat:
        monkeypatch.setattr(rd, "SAT_WALK_THRESHOLD", 1)
    cfg, b, ref = dense_inputs(dev, n + tile_h, n, tile_h, k)
    tp, ids, count = b.tile_params, b.ids, b.count
    c_ch, _, part_ch, g_ch = chain(tp, ids, count, ref, n, cfg)
    c_d, part_d, g_d = rdn._l2_dense_cuda(tp, ids, count, ref, n, cfg)
    torch.cuda.synchronize()
    assert torch.equal(c_d, c_ch) and torch.equal(g_d, g_ch)
    assert torch.equal(rr.patch_slot_sums(part_d, count, rr.patch_passes(cfg)),
                       part_ch)


def replay_inputs(dev, case):
    """Kernel 3's inputs for a case of test_replays_equal_the_chunk_walk:
    (cfg, table, ids, count, planes (fin, gc, cin, tin)). The NaN case
    replays from the identity carry, where the chunk walk has no exit."""
    if case == "nan":
        cfg, table, ids, count, _ = nan_splat_inputs(dev)
    elif case == "opacity-1":
        d, _ = population(5, 64, W, H, opacity=(1.0, 1.0))
        d["pos"][:16] = np.floor(d["pos"][:16]) + 0.5
        cfg = SplatConfig(width=W, height=H, n_splats=64, tile_h=32,
                          max_splats_per_tile=64)
        p = params_from_numpy({f: v.astype(np.float32)
                               for f, v in d.items()}, dev)
        b = tl.bin_splats(p, cfg, 64, ids_only=True)
        table, ids, count = (rr.resident_table(p, cfg), rr._remap_ids(b, 64),
                             b.count)
    else:
        n, tile_h = map(int, case.split("/"))
        cfg, table, ids, count, _ = inputs(dev, n + tile_h, n, tile_h,
                                           k=512 if tile_h == 64 else 128)
    fin, trans = rr._fwd_resident_plain(table, ids, count, cfg)
    if case == "nan":
        cin, tin = rd.identity_carry(cfg, dev)
    else:
        cin, tin = 0.5 * fin[0], (0.5 * trans[0]).contiguous()
    gc = random_cotangent(dev, cfg, cfg.n_splats)
    return cfg, table, ids, count, (fin[0].contiguous(), gc, cin, tin)


@pytest.mark.parametrize("case", ["130/32", "64/64", "300/64", "opacity-1",
                                  "nan"])
def test_replays_equal_the_chunk_walk(dev, case):
    """Kernel 3 and kernels 8/9 (on the table rows the ids name) on warp
    patches equal the chunk reference, the unchanged one-block-per-tile
    backward, bit for bit from a carry-in under a random cotangent:
    moments and 8/9's slot partials (equal NaN masks in the NaN case);
    their survivors per patch are patch_cover_mask's."""
    cfg, table, ids, count, planes = replay_inputs(dev, case)
    n = cfg.n_splats
    tp = gathered(table, ids)
    part_ch, g_ch = rdn._bwd_chunk_cuda(tp, ids, count, *planes, n, cfg)
    mask = rr.patch_cover_mask(table, ids, count, cfg, rr.patch_rows())
    want = mask.sum(dim=-1).reshape(-1).to(torch.int32)
    walked = [torch.full((want.numel(), 2), -1, dtype=torch.int32,
                         device=dev) for _ in range(2)]
    m_3 = rr._bwd_resident_cuda(table, ids, count, *planes, n, cfg,
                                walked=walked[0])
    part_d, g_d = rdn._bwd_dense_cuda(tp, ids, count, *planes, n, cfg,
                                      walked=walked[1])
    torch.cuda.synchronize()
    assert_same_bits(m_3[:9, :n], g_ch)
    assert_same_bits(g_d, g_ch)
    assert_same_bits(rr.patch_slot_sums(part_d, count, rr.patch_passes(cfg)),
                     part_ch)
    for got in walked:
        assert torch.equal(got[:, 0], want)
    if case == "nan":
        assert torch.isnan(g_ch).any() and torch.isfinite(g_ch).any()
        # A poisoned patch walks every later slot, survivor or not.
        assert bool((walked[0][:, 1] > walked[0][:, 0]).any())
    else:
        assert torch.isfinite(g_ch).all()
        for got in walked:
            assert bool((got[:, 1] <= got[:, 0]).all())


def test_replay_partials_never_read_unwritten(dev):
    """Kernels 3 and 8/9 leave their partial scratch unzeroed: a buffer
    pre-filled with NaN gives the same moments bit for bit."""
    cfg, table, ids, count, planes = replay_inputs(dev, "300/64")
    n = cfg.n_splats
    tp = gathered(table, ids)
    shape = rr.patch_partial_shape(cfg, ids.shape[1])
    m_a = rr._bwd_resident_cuda(table, ids, count, *planes, n, cfg,
                                partial=torch.full(shape, float("nan"),
                                                   device=dev))
    m_b = rr._bwd_resident_cuda(table, ids, count, *planes, n, cfg)
    _, g_a = rdn._bwd_dense_cuda(tp, ids, count, *planes, n, cfg,
                                 partial=torch.full(shape, float("nan"),
                                                    device=dev))
    _, g_b = rdn._bwd_dense_cuda(tp, ids, count, *planes, n, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(m_a).all() and torch.isfinite(g_a).all()
    assert torch.equal(m_a, m_b) and torch.equal(g_a, g_b)


def test_backward_entry_points_never_launch_the_chunk_reference(dev):
    """backward_resident and backward_tiled launch kernels 3 and 8/9, once
    each, and never the chunk reference."""
    n = 130
    cfg, table, ids, count, planes = replay_inputs(dev, "130/32")
    b = tl.TileBinning(ids=torch.where(ids < n, ids, -1), count=count,
                       n_dropped=torch.zeros((), dtype=torch.int32))
    d, _ = population(n + 32, n, W, H)
    p = params_from_numpy({f: v.astype(np.float32) for f, v in d.items()},
                          dev)
    bd = tl.bin_splats(p, cfg.replace(binning="dense"), 128)
    fin = planes[0][:, :H, :W].permute(1, 2, 0)
    g = planes[1][:, :H, :W].permute(1, 2, 0)
    before_r, before_d = dict(rr.launches), dict(rdn.launches)
    rr.backward_resident(b, table, fin, g, n, cfg)
    rdn.backward_tiled(bd, fin, g, n, cfg, p)
    torch.cuda.synchronize()
    assert rr.launches == {**before_r,
                           "bwd_resident": before_r["bwd_resident"] + 1}
    assert rdn.launches == {**before_d,
                            "bwd_dense": before_d["bwd_dense"] + 1}


def test_patch_partials_never_read_unwritten(dev):
    """The partial scratch of kernels 1 and 4/5 is not zeroed: a buffer
    pre-filled with NaN gives the same moments bit for bit, so every entry
    the sum reads is written (a culled or saturated slot's zero
    included)."""
    cfg, table, ids, count, ref = inputs(dev, 11, 300, 32, k=512)
    filled = torch.full(rr.patch_partial_shape(cfg, 512), float("nan"),
                        device=dev)
    c_a, g_a = rr._l2_resident_cuda(table, ids, count, ref, 300, cfg,
                                    partial=filled)
    c_b, g_b = rr._l2_resident_cuda(table, ids, count, ref, 300, cfg)
    tp = gathered(table, ids)
    d_a = rdn._l2_dense_cuda(tp, ids, count, ref, 300, cfg,
                             partial=torch.full_like(filled, float("nan")))
    d_b = rdn._l2_dense_cuda(tp, ids, count, ref, 300, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(g_a).all() and torch.isfinite(d_a[2]).all()
    assert torch.equal(c_a, c_b) and torch.equal(g_a, g_b)
    assert torch.equal(d_a[0], d_b[0]) and torch.equal(d_a[2], d_b[2])


@pytest.mark.parametrize("tile_h", [8, 32, 64])
def test_patch_survivors_are_the_plain_mask(dev, tile_h):
    """Each warp's survivors are patch_cover_mask's slots, patch by patch,
    in kernels 1, 2, 12 and (at the dense kernels' tile heights) 4/5 alike;
    the saturation exit walks at most them."""
    cfg, table, ids, count, ref = inputs(dev, 3 + tile_h, 300, tile_h, k=512)
    mask = rr.patch_cover_mask(table, ids, count, cfg, rr.patch_rows())
    want = mask.sum(dim=-1).reshape(-1).to(torch.int32)
    b = tl.TileBinning(ids=torch.where(ids < 300, ids, -1), count=count,
                       n_dropped=torch.zeros((), dtype=torch.int32))
    bases, _ = rw.window_bases(b, 300, rw._n_pad(300))
    launches = [
        lambda w: rr._l2_resident_cuda(table, ids, count, ref, 300, cfg,
                                       walked=w),
        lambda w: rr._fwd_resident_cuda(table, ids, count, cfg, walked=w),
        lambda w: rw._l2_window_cuda(table, ids, count, bases, ref, 300, cfg,
                                     rw._n_pad(300), walked=w)]
    if tile_h in rdn.CUDA_TILE_HS:
        launches.append(lambda w: rdn._l2_dense_cuda(
            gathered(table, ids), ids, count, ref, 300, cfg, walked=w))
    for launch in launches:
        walked = torch.full((want.numel(), 2), -1, dtype=torch.int32,
                            device=dev)
        launch(walked)
        torch.cuda.synchronize()
        assert torch.equal(walked[:, 0], want)
        assert bool((walked[:, 1] <= walked[:, 0]).all())
        assert bool((walked[:, 1] >= 0).all())


def test_window_kernel_drops_escapes_like_plain(dev):
    """Kernel 12 at W = 128 with escapes: colour equal to kernel 1's, the
    moments within the resident tolerance of the plain twin's."""
    n = 300
    cfg, table, ids, count, ref = inputs(dev, 32, n, 32, k=512)
    b = tl.TileBinning(ids=torch.where(ids < n, ids, -1), count=count,
                       n_dropped=torch.zeros((), dtype=torch.int32))
    bases, escaped = rw.window_bases(b, n, 128)
    assert int(escaped) > 0
    c_w, g_w = rw._l2_window_cuda(table, ids, count, bases, ref, n, cfg, 128)
    c_p, g_p = rw._l2_window_plain(table, ids, count, bases, ref, n, cfg,
                                   128)
    c_r, _ = rr._l2_resident_cuda(table, ids, count, ref, n, cfg)
    torch.cuda.synchronize()
    assert torch.equal(c_w, c_r)
    atol = 1e-4 * max(1.0, float(g_p.abs().max()))
    torch.testing.assert_close(g_w, g_p, rtol=0, atol=atol)


@pytest.mark.parametrize("n,tile_h,k,kc", [(200, 32, 256, 128),
                                           (300, 64, 512, 256)])
def test_mxu_kernel_matches_plain_and_dense(dev, n, tile_h, k, kc):
    """Kernel 13 against its plain twin: the colour from the same
    per-pixel float32 program (1e-6), the gradient rows from pixel sums
    taken in another order, whose rounding the combine's cancellation
    (s_xx = m_xx - 2 ex m_x + ex^2 m_1, |ex| up to the tile's half-width)
    lifts to about 1e-4 of a field's scale (1e-3 allowed). Against the
    dense L2 kernel: tests/test_fused.py's 2e-3 * max(1, |g|) for the
    gradients; the colour within 2e-4, since with sx down to 1.5 px the
    coefficient c_0 = a ex^2 + ... reaches about 1800 and its float32
    rounding moves D2 by about 1e-4 (the default fit's 6-10 px splats stay
    within gs2d_tpu's 5e-5, which chip_smoke.py gates)."""
    cfg, b, ref = dense_inputs(dev, n + k, n, tile_h, k)
    args = (b.tile_params, b.ids, b.count, ref, n, cfg, kc)
    before = rm.launches["l2_mxu"]
    c_k, rows_k, g_k = rm._l2_mxu_cuda(*args)
    c_p, rows_p, g_p = rm._l2_mxu_plain(*args)
    c_d, _, g9 = rdn._l2_dense_cuda(b.tile_params, b.ids, b.count, ref, n,
                                    cfg)
    torch.cuda.synchronize()
    assert rm.launches["l2_mxu"] == before + 1
    torch.testing.assert_close(c_k, c_p, rtol=0, atol=1e-6)
    for got, want in ((rows_k.reshape(-1, 9).T, rows_p.reshape(-1, 9).T),
                      (g_k, g_p)):
        for f in range(rd.N_MOMENTS):
            atol = 1e-3 * max(1.0, float(want[f].abs().max()))
            torch.testing.assert_close(got[f], want[f], rtol=0, atol=atol)
    torch.testing.assert_close(c_k, c_d, rtol=0, atol=2e-4)
    d, _ = population(n + k, n, W, H)
    p = params_from_numpy({f: v.astype(np.float32) for f, v in d.items()},
                          dev)
    g_dense = rd.moments_to_grads(rd.unpack_moments(g9, n),
                                  tl.packed_fields(p, cfg.splat_bounds))
    g_mxu = rd.unpack_moments(g_k, n)
    for f in ("pos", "sx", "sy", "rot", "color", "opacity"):
        want = getattr(g_dense, f)
        torch.testing.assert_close(
            getattr(g_mxu, f), want, rtol=0,
            atol=2e-3 * max(1.0, float(want.abs().max())))


def survivor_buffer(cfg, dev):
    """A (patches, 2) int32 buffer for a kernel's survivor counts, -1
    filled."""
    n = cfg.n_tiles_x * cfg.n_tiles_y * rr.patches_per_tile(
        cfg, rr.patch_rows())
    return torch.full((n, 2), -1, dtype=torch.int32, device=dev)


def cull_counts(tp, count, cfg):
    """Survivors per patch of the plain cull mask of the rows tp."""
    mask = rr.listed_cover_mask(tp, count, cfg, rr.patch_rows())
    return mask.sum(dim=-1).reshape(-1).to(torch.int32)


@pytest.mark.parametrize("case", ["130/32", "64/64", "300/64", "opacity-1",
                                  "nan"])
def test_dense_forward_equals_the_forward_reference(dev, case):
    """Kernels 6/7 on warp patches (on the table rows the ids name) equal
    the forward reference, the chunk walk they had before, bit for bit:
    colour and T, equal NaN masks in the NaN case; their survivors per
    patch are the plain cull mask's; on finite inputs they match the plain
    version."""
    cfg, table, ids, count, _ = patch_case(dev, case)
    tp = gathered(table, ids)
    walked = survivor_buffer(cfg, dev)
    c_k, t_k = rdn._fwd_dense_cuda(tp, count, cfg, walked=walked)
    c_r, t_r = rdn._fwd_chunk_cuda(tp, count, cfg)
    torch.cuda.synchronize()
    assert_same_bits(c_k, c_r)
    assert_same_bits(t_k, t_r)
    assert torch.equal(walked[:, 0], cull_counts(tp, count, cfg))
    if case == "nan":
        assert torch.isnan(t_r).any() and torch.isfinite(t_r).any()
        return
    assert bool((walked[:, 1] <= walked[:, 0]).all())
    c_p, t_p = rdn._fwd_dense_plain(tp, count, cfg)
    torch.testing.assert_close(c_k, c_p, rtol=0, atol=1e-6)
    torch.testing.assert_close(t_k, t_p, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,tile_h,k,sat", [
    (200, 32, 256, False), (300, 32, 512, True), (300, 64, 512, True)])
def test_dense_forward_equals_the_reference_on_dense_binnings(
        dev, monkeypatch, n, tile_h, k, sat):
    """Kernels 6/7 on a dense binning equal the forward reference over the
    same tile_params bit for bit (the chunked member's saturating walk
    forced where ``sat``)."""
    if sat:
        monkeypatch.setattr(rd, "SAT_WALK_THRESHOLD", 1)
    cfg, b, _ = dense_inputs(dev, n + tile_h + 1, n, tile_h, k)
    c_k, t_k = rdn._fwd_dense_cuda(b.tile_params, b.count, cfg)
    c_r, t_r = rdn._fwd_chunk_cuda(b.tile_params, b.count, cfg)
    torch.cuda.synchronize()
    assert torch.equal(c_k, c_r) and torch.equal(t_k, t_r)


def mxu_case(dev, case):
    """Kernel 13's arguments for a case of the MXU card tests: "n/tile_h/k"
    random dense binnings (chunk min(256, K)), and 130 random splats at K =
    128 with splat 40's position NaN in the tile_params."""
    if case == "nan":
        cfg, b, ref = dense_inputs(dev, 77, 130, 32, 128)
        tp = b.tile_params.clone()
        tp[b.ids == 40, tl.FIELD_PX] = float("nan")
        return (tp, b.ids, b.count, ref, 130, cfg, 128)
    n, tile_h, k = map(int, case.split("/"))
    cfg, b, ref = dense_inputs(dev, n + k + 2, n, tile_h, k)
    return (b.tile_params, b.ids, b.count, ref, n, cfg, min(256, k))


@pytest.mark.parametrize("case", ["200/32/256", "300/64/512", "300/32/1024",
                                  "nan"])
def test_mxu_kernel_equals_its_reference(dev, case):
    """Kernel 13 on warp patches equals its reference, the chunk walk it
    had before, bit for bit: colour, per-(tile, slot) rows and gradients,
    equal NaN masks in the NaN case; its survivors per patch are the plain
    cull mask's."""
    args = mxu_case(dev, case)
    tp, _, count, _, _, cfg, _ = args
    walked = survivor_buffer(cfg, dev)
    before = dict(rm.launches)
    got = rm._l2_mxu_cuda(*args, walked=walked)
    want = rm._l2_mxu_chunk_cuda(*args)
    torch.cuda.synchronize()
    assert rm.launches == {"l2_mxu": before["l2_mxu"] + 1,
                           "l2_mxu_chunk": before["l2_mxu_chunk"] + 1}
    for g, w in zip(got, want):
        assert_same_bits(g, w)
    assert torch.equal(walked[:, 0], cull_counts(tp, count, cfg))
    if case == "nan":
        assert torch.isnan(want[2]).any() and torch.isfinite(want[2]).any()
    else:
        assert all(torch.isfinite(w).all() for w in want)


def test_mxu_partials_never_read_unwritten(dev):
    """Kernel 13 leaves its partial scratch unzeroed: a buffer pre-filled
    with NaN gives the same colour, rows and gradients bit for bit."""
    args = mxu_case(dev, "300/64/512")
    tp, _, _, _, _, cfg, _ = args
    filled = torch.full(rr.patch_partial_shape(cfg, tp.shape[1],
                                               rm.N_SUMS),
                        float("nan"), device=dev)
    a = rm._l2_mxu_cuda(*args, partial=filled)
    b = rm._l2_mxu_cuda(*args)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.isfinite(x).all()
        assert torch.equal(x, y)


def test_forward_and_mxu_entry_points_never_launch_the_references(dev):
    """forward_tiled and l2_render_and_grads_mxu launch kernels 6/7 and 13,
    once each, and never the chunk references."""
    cfg, b, ref = dense_inputs(dev, 5, 200, 32, 256)
    before_d, before_m = dict(rdn.launches), dict(rm.launches)
    rdn.forward_tiled(b, cfg)
    rm.l2_render_and_grads_mxu(b, ref, 200, cfg)
    torch.cuda.synchronize()
    assert rdn.launches == {**before_d,
                            "fwd_dense": before_d["fwd_dense"] + 1}
    assert rm.launches == {**before_m, "l2_mxu": before_m["l2_mxu"] + 1}


def test_device_time_is_the_kernels_time(dev):
    """utils/profiling.py::device_time: its graph-replay reading agrees
    with the profiler's kernel durations. On kernel 14 at its scripts' grid
    (one launch of about half a millisecond a call) the profiler sees that
    kernel alone, once a call, and agrees with the graph replay within 5%;
    on short launches (kernels 6/7 on a small binning, where the host's
    time between launches can exceed the kernel's) they still agree, and
    the event reading, which holds the host's gaps (and a card's clocks
    still rising at its first calls), is at least the device time."""
    t = device_time(lambda: probes.fma_peak(16, dev), 5)
    assert t["ops"] == 1 and "fma_peak" in next(iter(t["kernels"]))
    assert 0.95 <= t["profiler"] / t["device"] <= 1.05
    assert t["events"] >= 0.95 * t["device"]
    cfg, b, _ = dense_inputs(dev, 5, 200, 32, 256)
    t = device_time(lambda: rdn._fwd_dense_cuda(b.tile_params, b.count,
                                                cfg), 20)
    assert t["ops"] == 1
    assert 0.8 <= t["profiler"] / t["device"] <= 1.05
    assert t["events"] >= 0.95 * t["device"]


# The runtime calls that put the render path's work on the device, as the
# card's trace names them (benchmark/lib/spans.py matches them to device
# operations).
ENQUEUE = {"cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync"}


def test_traced_flat_render_spans_are_host_ranges_only(dev):
    """utils/profiling.py::span on the card: a traced render_flat holds its
    ranges as host events and no device event named gs2d.* (a user
    annotation would be one), and the enqueueing calls made inside
    gs2d.render are as many as the render's device operations (which
    benchmark/lib/spans.py pairs in order). No check by time: in some
    sessions the profiler's device timestamps sit up to a fraction of a
    millisecond before their calls' host timestamps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p, _ = flat_params(dev, 31, 300)
    cfg = rf.tune_flat_config(p, SplatConfig(
        width=W, height=H, n_splats=300, tile_h=32, binning="flat"))
    want = rf.render_flat(p, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = rf.render_flat(p, cfg)
        torch.cuda.synchronize()
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    events = [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
               e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    assert not [n for n, on_dev, _, _ in events
                if on_dev and n.startswith("gs2d.")]
    renders = [(s, e) for n, on_dev, s, e in events
               if not on_dev and n == "gs2d.render"]
    assert len(renders) == 1
    lo, hi = renders[0]
    names = {n for n, on_dev, _, _ in events if not on_dev}
    assert {"gs2d.bin_flat", "gs2d.fwd_flat"} <= names
    calls = [s for n, on_dev, s, _ in events
             if not on_dev and n in ENQUEUE and lo <= s < hi]
    ops = [s for _, on_dev, s, _ in events if on_dev]
    assert calls and len(calls) == len(ops)


@pytest.mark.parametrize("chains", [1, 2, 4, 8, 16, 32])
def test_fma_peak_matches_plain_and_is_fused(dev, chains):
    """Kernel 14: every thread's sum equals the plain version's (each step
    rounded once) within FMA_ULPS units, and the compiled loop holds fused
    multiply-adds only."""
    before = probes.launches["fma_peak"]
    got = probes.fma_peak(chains, dev, grid=64)
    want = probes.fma_peak_plain(chains, probes.FMA_INNER, 64, 256, dev)
    torch.cuda.synchronize()
    assert got.shape == (64, 256)
    tol = probes.FMA_ULPS * 2.0 ** -23 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert probes.launches["fma_peak"] == before + 1
    sass = probes.fma_sass_counts()[chains]
    assert sass["FFMA"] >= chains and sass["FMUL"] == 0
    assert sass["FADD"] == chains - 1  # the chains' sum


def test_fma_peak_refuses_bad_shapes(dev):
    with pytest.raises(ValueError):
        probes.fma_peak(3, dev)
    with pytest.raises(ValueError):
        probes.fma_peak(4, dev, inner=12)


def _moment_launcher(kind):
    """(counter, launch (dev, n_k, n_blocks), plain) of a moment probe, or
    of its reference ("vpu tree": 15a's lane tree; "mxu staged", "mxu2
    sync": the designs 15b and 15c had before wgmma)."""
    base, _, ref = kind.partition(" ")
    name, fn, plain = probes.MOMENT_PROBES[base]
    if not ref:
        return name, (lambda dev, n_k, n_blocks:
                      fn(dev, n_k=n_k, n_blocks=n_blocks)), plain
    ref_name, launch = probes.MOMENT_REFERENCES[base]
    return ref_name, (lambda dev, n_k, n_blocks:
                      launch(n_k, n_blocks, dev)), plain


@pytest.mark.parametrize("kind,rtol", [("vpu", 1e-4), ("mxu", 1e-5),
                                       ("mxu2", 1e-5), ("mxu staged", 1e-5),
                                       ("mxu2 sync", 1e-5),
                                       ("vpu tree", 1e-4)])
@pytest.mark.parametrize("n_k,n_blocks", [(64, 1), (512, 3)])
def test_moment_probes_match_plain(dev, kind, rtol, n_k, n_blocks):
    """Kernels 15a-c and their references against their plain
    versions: the moments' sum-order class for the CUDA-core reduction,
    what 3xTF32 keeps for the tensor-core forms, each output against the
    size of its terms (probes.moments_output_sizes: 15c's columns cycle
    through nine moments of very different sizes); every block writes the
    same row, and a second launch repeats the first bit for bit."""
    name, launch, plain = _moment_launcher(kind)
    before = probes.launches[name]
    got = launch(dev, n_k, n_blocks)
    again = launch(dev, n_k, n_blocks)
    want = plain(n_k, n_blocks, dev)
    torch.cuda.synchronize()
    assert got.shape == (n_blocks, 128) and torch.isfinite(got).all()
    sizes = probes.moments_output_sizes(kind.split()[0], want, n_k)
    assert ((got - want).abs() <= rtol * sizes).all()
    assert torch.equal(got, again) and torch.equal(got, got[:1].expand_as(got))
    assert probes.launches[name] == before + 2


# Each redesign against its reference and its per-step values against the
# plain steps, of their terms' size: 15a's butterfly adds the lane tree's
# operands (bit for bit) and its steps differ from the plain ones by the
# moments' sum order; 15b and 15c keep what 3xTF32 keeps.
REDESIGN_RTOL = {"vpu": 0.0, "mxu": 1e-5, "mxu2": 1e-5}
STEPS_RTOL = {"vpu": 1e-4, "mxu": 1e-5, "mxu2": 1e-5}


@pytest.mark.parametrize("kind", ["mxu", "mxu2", "vpu"])
@pytest.mark.parametrize("n_k,n_blocks", [(64, 1), (136, 2), (512, 132)])
def test_moment_probe_redesigns_match_their_references(dev, kind, n_k,
                                                       n_blocks):
    """15a against its lane tree bit for bit, 15b and 15c against the
    designs they had before wgmma within what 3xTF32 keeps of the outputs'
    terms' size, in one call (136: 15c's last batch of 64 planes holds 8,
    15b's and 15a's last round of 32 steps 8)."""
    name, fn, plain = probes.MOMENT_PROBES[kind]
    _, launch = probes.MOMENT_REFERENCES[kind]
    got = fn(dev, n_k=n_k, n_blocks=n_blocks)
    old = launch(n_k, n_blocks, dev)
    want = plain(n_k, n_blocks, dev)
    torch.cuda.synchronize()
    sizes = probes.moments_output_sizes(kind, want, n_k)
    if REDESIGN_RTOL[kind] == 0:
        assert torch.equal(got, old)
    assert ((got - old).abs() <= REDESIGN_RTOL[kind] * sizes).all()
    assert ((got - want).abs() <= STEPS_RTOL[kind] * sizes).all()


@pytest.mark.parametrize("n_k", [35, 67])
def test_cuda_cores_butterfly_takes_a_short_last_round(dev, n_k):
    """A last round whose steps are no whole number of batches (3 steps):
    15a reduces them one at a time, still the lane tree's bits."""
    got = probes.moments_cuda_cores(dev, n_k=n_k, n_blocks=2)
    old = probes._moments_cuda_cores_tree_cuda(n_k, 2, dev)
    torch.cuda.synchronize()
    assert torch.equal(got, old)


@pytest.mark.parametrize("kind", ["mxu", "mxu2", "vpu"])
@pytest.mark.parametrize("n_k", [64, 136, 512])
def test_moment_probe_steps_match_the_plain_steps(dev, kind, n_k):
    """Each step's values, which 15a, 15b and 15c form a step at a time
    and write when given a tensor: (n_k, 9), (n_k, 5) and (n_k, 9), within
    STEPS_RTOL of their terms' size; the output is the one without
    steps."""
    name, fn, _ = probes.MOMENT_PROBES[kind]
    width, plain_steps = probes.MOMENT_STEPS[kind]
    steps = torch.full((n_k, width), float("nan"), device=dev)
    got = fn(dev, n_k=n_k, n_blocks=2, steps=steps)
    bare = fn(dev, n_k=n_k, n_blocks=2)
    want = plain_steps(n_k, dev)
    sizes = plain_steps(n_k, dev, sizes=True).clamp(min=1.0)
    torch.cuda.synchronize()
    assert torch.isfinite(steps).all()
    assert ((steps - want).abs() <= STEPS_RTOL[kind] * sizes).all()
    assert torch.equal(got, bare)


def test_cuda_cores_sass_shuffles_a_step(dev):
    """15a's compiled code issues at most 12 shuffles a step (the
    butterfly: 12, 10 or 9.25 at G = 1, 2, 4), fewer than its reference,
    the lane tree: 45 in the source, 30 where ptxas folds the shuffles of
    the three values that are the same on every lane (the probe's z plane
    is the same in every column; ops/probes.py::moments_sass_counts). Both
    bodies hold whole steps of FMULs, none fused."""
    sass = probes.moments_sass_counts()
    new, old = sass["moments_cuda_cores"], sass["moments_cuda_cores_tree"]
    for c in (new, old):
        assert c["step_bodies"] >= 1
        assert c["step_bodies"] == int(c["step_bodies"])
    assert 30 <= old["shfl_per_step"] <= 45
    assert new["shfl_per_step"] <= 12 < old["shfl_per_step"]


def test_moment_probe_steps_refuse_other_tensors(dev):
    with pytest.raises(ValueError):
        probes.moments_cuda_cores(dev, n_k=64,
                                  steps=torch.empty(64, 5, device=dev))
    with pytest.raises(ValueError):
        probes.moments_cuda_cores(dev, n_k=64, steps=torch.empty(64, 9))
    with pytest.raises(ValueError):
        probes.moments_cuda_cores(
            dev, n_k=64, steps=torch.empty(64, 9, device=dev,
                                           dtype=torch.float64))
    with pytest.raises(ValueError):
        probes.moments_tensor_cores(dev, n_k=64,
                                    steps=torch.empty(64, 9, device=dev))
    with pytest.raises(ValueError):
        probes.moments_scratch_contraction(dev, n_k=64,
                                           steps=torch.empty(64, 9))
    with pytest.raises(ValueError):
        probes.moments_scratch_contraction(
            dev, n_k=64, steps=torch.empty(64, 9, device=dev,
                                           dtype=torch.float64))


def test_scratch_contraction_refuses_what_it_cannot_hold(dev):
    with pytest.raises(ValueError):
        probes.moments_scratch_contraction(dev, n_k=60)   # not batches of 8
    with pytest.raises(ValueError):
        probes.moments_scratch_contraction(dev, n_k=4096)  # shared memory


def test_scratch_contraction_reference_refuses_what_it_cannot_hold(dev):
    _, launch = probes.MOMENT_REFERENCES["mxu2"]
    with pytest.raises(ValueError):
        launch(60, 1, dev)
    with pytest.raises(ValueError):
        launch(4096, 1, dev)


def _scan_case(dev, binning, margin):
    from gs2d_tpu_torch.io.image import synthetic_target
    from gs2d_tpu_torch.train import loop

    cfg = SplatConfig(width=W, height=H, n_splats=64, tile_h=32,
                      binning=binning, rebin_margin=margin,
                      learning_rate=0.5)
    state = loop.init_train_state(cfg, dev)
    cfg = (rf.tune_flat_config(state.params, cfg) if binning == "flat"
           else tl.tune_tile_capacity(state.params, cfg))
    return cfg, state, rd.pad_ref_chw(synthetic_target(H, W), cfg, dev)


def _eager(cfg, state, ref, n):
    from gs2d_tpu_torch.train import loop

    step, mse = loop.make_train_step_fused(cfg), []
    for _ in range(n):
        state, aux = step(state, ref)
        mse.append(aux.mse)
    return state, torch.stack(mse)


@pytest.mark.parametrize("binning", ["resident", "flat"])
@pytest.mark.parametrize("margin", [0.0, 2.0, 0.25])
def test_captured_fit_equals_eager(dev, binning, margin):
    """12 steps replayed from one captured step (lazy rebinning under a
    conditional node where margin > 0) equal 12 eager steps bit for bit;
    the launch counts grow by one per kernel and replay, not by the
    warm-up or the capture."""
    from gs2d_tpu_torch.train import loop

    cfg, state, ref = _scan_case(dev, binning, margin)
    s_e, mse_e = _eager(cfg, state, ref, 12)
    counts = rf.launches if binning == "flat" else rr.launches
    before = dict(counts)
    fit_k = loop.make_fit_scan_fused(cfg)
    s_g, aux = fit_k(state, ref, 12)
    torch.cuda.synchronize()
    assert torch.equal(aux.mse, mse_e)
    for a, b in zip(loop.state_leaves(s_g), loop.state_leaves(s_e)):
        assert torch.equal(a, b)
    grown = {k: counts[k] - before[k] for k in counts}
    want = ({"fwd_flat": 12, "fwd_flat_mask": 12, "bwd_flat": 12}
            if binning == "flat"
            else {"l2_resident": 12, "fwd_resident": 0, "bwd_resident": 0})
    assert grown == want
    if margin == 0.25:
        assert 0 < int(aux.rebinned.sum()) < 12
    if margin == 0.0:
        assert int(aux.rebinned.sum()) == 0


def test_capture_on_a_side_stream(dev):
    """A block captured and replayed while the caller is on a non-default
    stream, then a shorter block through the same graph, equal the eager
    steps bit for bit."""
    from gs2d_tpu_torch.train import loop

    cfg, state, ref = _scan_case(dev, "resident", 2.0)
    _, mse_e = _eager(cfg, state, ref, 12)
    fit_k = loop.make_fit_scan_fused(cfg)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        s1, a1 = fit_k(state, ref, 8)
        s2, a2 = fit_k(s1, ref, 4)
        got = torch.cat([a1.mse, a2.mse])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert fit_k.graph.n_max == 8
    assert torch.equal(got, mse_e)


def _densify_inputs(seed, n, signal):
    """A seeded population with dead slots, degenerate, transparent and
    big splats, positive Adam moments, and a signal ("random", "ties" or
    "zero"), as numpy."""
    from gs2d_tpu_torch.params import DEAD_POS

    d, _ = population(seed, n, W, H, opacity=(0.1, 1.0))
    rng = np.random.default_rng(seed + 1)
    p = {f: v.astype(np.float32) for f, v in d.items()}
    p["sx"][: n // 4] = rng.uniform(24.5, 60.0, n // 4)
    p["sx"][n // 4: n // 4 + 5] = p["sy"][n // 4: n // 4 + 5] = 1.0
    p["opacity"][n // 4 + 5: n // 4 + 10] = 0.1
    p["pos"][-6:] = DEAD_POS
    p["opacity"][-6:] = 0.0
    opt = {k: {f: rng.uniform(0.1, 1.0, v.shape).astype(np.float32)
               for f, v in p.items()} for k in ("m", "v")}
    opt.update(beta1t=np.float32(0.5), beta2t=np.float32(0.9),
               step=np.int32(7))
    g = {"random": rng.exponential(1.0, n),
         "ties": rng.integers(0, 4, n).astype(np.float64),
         "zero": np.zeros(n)}[signal].astype(np.float32)
    return p, opt, g


@pytest.mark.parametrize("signal", ["random", "ties", "zero"])
@pytest.mark.parametrize("optimize_opacity", [True, False])
def test_densify_on_the_card_equals_the_cpu(dev, signal, optimize_opacity):
    """densify_and_prune and opacity_reset on CUDA tensors give the CPU's
    state bit for bit (stable sorts, gathers and permutation scatters),
    and loop.grad_mag the CPU's signal."""
    from gs2d_tpu_torch.train import adam, densify, loop

    p, opt, g = _densify_inputs(3, 96, signal)
    cfg = SplatConfig(width=W, height=H, n_splats=96,
                      optimize_opacity=optimize_opacity)
    out = {}
    for d in ("cpu", dev):
        st = loop.TrainState(params=params_from_numpy(p, d),
                             opt=adam.adam_state_from_numpy(opt, d))
        st = densify.densify_and_prune(st, torch.as_tensor(g).to(d), cfg,
                                       seed=300)
        st = densify.opacity_reset(st, cfg)
        out[str(d)] = [t.cpu() for t in loop.state_leaves(st)]
    for a, b in zip(out["cpu"], out[str(dev)]):
        assert torch.equal(a, b)
    rng = np.random.default_rng(4)
    gp = torch.as_tensor((rng.uniform(-1, 1, (4096, 2)) * 10.0 ** rng.uniform(
        -15, 15, (4096, 1))).astype(np.float32))
    assert torch.equal(loop.grad_mag(gp), loop.grad_mag(gp.to(dev)).cpu())


@pytest.mark.parametrize("binning", ["resident", "flat"])
@pytest.mark.parametrize("margin", [0.0, 2.0])
def test_captured_signal_sum_equals_eager(dev, binning, margin):
    """The captured step's accumulator after 5 replays, then 7 more that
    continue its sum, equals the sum of 12 eager signals bit for bit, and
    the states and MSEs equal the eager steps'; one capture."""
    from gs2d_tpu_torch.train import loop

    cfg, state, ref = _scan_case(dev, binning, margin)
    step = loop.make_train_step_fused(cfg, True)
    s_e, acc, mse = state, torch.zeros((64,), device=dev), []
    for _ in range(12):
        s_e, aux = step(s_e, ref)
        acc = acc + aux.pos_grad_mag
        mse.append(aux.mse)
    fit_k = loop.make_fit_scan_fused(cfg, True)
    s1, a1 = fit_k(state, ref, 5)
    s2, a2 = fit_k(s1, ref, 7, grad_mag_sum=a1.pos_grad_mag)
    torch.cuda.synchronize()
    assert fit_k.captures == 2  # n_max 5, then 7
    assert torch.equal(a2.pos_grad_mag, acc)
    assert torch.equal(torch.cat([a1.mse, a2.mse]), torch.stack(mse))
    for a, b in zip(loop.state_leaves(s2), loop.state_leaves(s_e)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("margin", [0.0, 2.0])
def test_adaptive_fit_on_the_card(dev, margin):
    """fit_adaptive scanned (blocks of 3 in windows of 8) equals the eager
    fit bit for bit on the card, densifying into dead slots (splits and
    clones), with one capture for its one cfg."""
    from gs2d_tpu_torch.io.image import synthetic_target
    from gs2d_tpu_torch.params import DEAD_POS
    from gs2d_tpu_torch.train import densify, loop

    cfg = SplatConfig(width=W, height=H, n_splats=40, tile_h=32,
                      rebin_margin=margin, init_scale_min=18.0,
                      init_scale_max=30.0)
    runs = []
    for chunk in (0, 3):
        state = loop.init_train_state(cfg, dev)
        state.params.pos[:10] = DEAD_POS
        state.params.opacity[:10] = 0.0
        lines = []
        s, hist = densify.fit_adaptive(
            synthetic_target(H, W), cfg, 24, 8, dev, state=state,
            scan_chunk=chunk, log_every=1, log_fn=lines.append)
        runs.append((s, hist, lines))
    (s_e, h_e, _), (s_s, h_s, lines) = runs
    assert [r["mse"] for r in h_s if "iter" in r] == \
        [r["mse"] for r in h_e if "iter" in r]
    live = [r["n_live"] for r in h_s if r.get("event") == "densify"]
    assert live == [r["n_live"] for r in h_e if r.get("event") == "densify"]
    assert live == [40, 40]  # the ten dead slots refilled at once
    assert len([x for x in lines if x.startswith("captured")]) == 1
    for a, b in zip(loop.state_leaves(s_s), loop.state_leaves(s_e)):
        assert torch.equal(a, b)


def _batch_case(dev, binning, margin):
    """Two images (synthetic targets of seeds 0 and 2) on _scan_case's
    config, the second population shifted, as a batched state."""
    from gs2d_tpu_torch.io.image import synthetic_target
    from gs2d_tpu_torch.parallel.sharded import init_batched_state

    cfg, _, _ = _scan_case(dev, binning, margin)
    state = init_batched_state(cfg, 2, dev)
    state.params.pos[1] += 1.5
    refs = torch.stack([rd.pad_ref_chw(synthetic_target(H, W, seed=s), cfg,
                                       dev) for s in (0, 2)])
    return cfg, state, refs


@pytest.mark.parametrize("binning,margin", [("resident", 0.0),
                                            ("resident", 2.0),
                                            ("flat", 2.0)])
def test_batched_scan_equals_batched_eager(dev, binning, margin):
    """Two images through one captured step (each loaded into its static
    buffers in turn), a block of 4 then one of 2 continuing the signal's
    sum, equal 6 batched eager steps bit for bit, with one capture; the
    images in the order (1, 0) give the same bits swapped, so nothing of
    one image's block (its lazy cache, its signal sum) reaches the
    next."""
    from gs2d_tpu_torch.train import loop

    cfg, state, refs = _batch_case(dev, binning, margin)
    s_e, mse_e = state, []
    step = loop.make_batched_train_step_fused(cfg)
    for _ in range(6):
        s_e, aux = step(s_e, refs)
        mse_e.append(aux.mse)
    fit_k = loop.make_fit_scan_batched(cfg, True)

    def scanned(st, refs):
        s1, a1 = fit_k(st, refs, 4)
        s2, a2 = fit_k(s1, refs, 2, grad_mag_sum=a1.pos_grad_mag)
        return s2, torch.cat([a1.mse, a2.mse]), a2.pos_grad_mag

    s_s, mse_s, g_s = scanned(state, refs)
    swap = [1, 0]
    s_w, mse_w, g_w = scanned(loop.state_from_leaves(
        [t[swap] for t in loop.state_leaves(state)]), refs[swap])
    torch.cuda.synchronize()
    assert fit_k.captures == 1
    assert torch.equal(mse_s, torch.stack(mse_e))
    for a, b, c in zip(loop.state_leaves(s_s), loop.state_leaves(s_e),
                       loop.state_leaves(s_w)):
        assert torch.equal(a, b) and torch.equal(c, a[swap])
    assert torch.equal(mse_w, mse_s[:, swap]) and torch.equal(g_w, g_s[swap])


def test_split_step_equals_fused_on_the_card(dev, monkeypatch):
    """With SPLIT_STEP_ROWS at 0 the flat cfg is above the split
    threshold; three of its steps equal three fused steps bit for bit (the
    signal too)."""
    from gs2d_tpu_torch.train import loop

    cfg, state, ref = _scan_case(dev, "flat", 0.0)
    monkeypatch.setattr(loop, "SPLIT_STEP_ROWS", 0)
    assert loop._needs_split(cfg)
    split = loop.make_train_step_fused(cfg, True)
    fused = loop._fused_step_body(cfg, True)
    s_a = s_b = state
    for _ in range(3):
        s_a, a = split(s_a, ref)
        s_b, b = fused(s_b, ref)
        assert torch.equal(a.mse, b.mse)
        assert torch.equal(a.pos_grad_mag, b.pos_grad_mag)
    for x, y in zip(loop.state_leaves(s_a), loop.state_leaves(s_b)):
        assert torch.equal(x, y)


def test_batched_adaptive_fit_on_the_card(dev):
    """fit_adaptive_batched (blocks of 3 in windows of 8, densifying into
    dead slots) equals fit_adaptive on each image bit for bit, with one
    capture for its one cfg."""
    from gs2d_tpu_torch.io.image import synthetic_target
    from gs2d_tpu_torch.params import DEAD_POS
    from gs2d_tpu_torch.parallel.sharded import init_batched_state
    from gs2d_tpu_torch.train import densify, loop

    cfg = SplatConfig(width=W, height=H, n_splats=40, tile_h=32,
                      init_scale_min=18.0, init_scale_max=30.0)
    refs = [synthetic_target(H, W, seed=s) for s in (0, 2)]
    state = init_batched_state(cfg, 2, dev)
    state.params.pos[:, :10] = DEAD_POS
    state.params.opacity[:, :10] = 0.0
    lines = []
    s_b, h_b, _ = densify.fit_adaptive_batched(
        refs, cfg, 24, 8, dev, state=state, scan_chunk=3, log_every=1,
        log_fn=lines.append)
    assert len([x for x in lines if x.startswith("captured")]) == 1
    for i in range(2):
        s_i, h_i = densify.fit_adaptive(
            refs[i], cfg, 24, 8, dev, state=loop.state_index(state, i),
            scan_chunk=3, log_every=1, log_fn=None)
        assert [r["mse"] for r in h_i if "iter" in r] == \
            [r["mse"][i] for r in h_b if "iter" in r]
        for a, b in zip(loop.state_leaves(loop.state_index(s_b, i)),
                        loop.state_leaves(s_i)):
            assert torch.equal(a, b)


# --- bands of tile rows (tile-axis sharding) ---------------------------------

def band_case(dev, layout, n, tile_h, n_bands, seed, min_throughput):
    """A population, its config with the tile grid rounded to whole bands
    (the flat capacity sized for one band), and its padded target
    (3, Hp, Wp)."""
    cfg = SplatConfig(width=W, height=H, n_splats=n, tile_h=tile_h,
                      binning=layout, flat_chunk=32, max_splats_per_tile=256,
                      tile_rows_multiple=n_bands,
                      min_throughput=min_throughput)
    p, ref = flat_params(dev, seed, n)
    if layout == "flat":
        cfg = rf.tune_flat_config(p, cfg, n_bands=n_bands)
    return cfg, p, rd.pad_ref_chw(ref, cfg, dev)[0]


def bin_band(p, cfg, layout, band):
    kw = {} if band is None else dict(band_row0=band[0], band_rows=band[1])
    if layout == "flat":
        b = tlf.bin_splats_flat(p, cfg, cfg.flat_capacity, kc=cfg.flat_chunk,
                                max_chunks=cfg.flat_max_chunks, **kw)
    else:
        b = tl.bin_splats(p, cfg, 256, ids_only=layout == "resident", **kw)
    assert int(b.n_dropped) == 0
    return b


def on(dev, x):
    """A binning, params or tensor on ``dev``."""
    if torch.is_tensor(x) or not isinstance(x, tuple):
        return x.to(dev)
    vals = [None if v is None else on(dev, v) for v in x]
    return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)


def band_calls(layout, b, p, cfg, band):
    """The layout's forward, L2 step and backward wrappers on binning ``b``
    of params ``p`` (the kernels for CUDA tensors, their plain versions for
    CPU ones), under ``band`` = (row0, rows) or the whole grid."""
    kw = {} if band is None else dict(band_row0=band[0], band_rows=band[1])
    n, kc, mc = p.n, cfg.flat_chunk, cfg.flat_max_chunks
    table = rr.resident_table(p, cfg) if layout == "resident" else None

    def fwd():
        if layout == "flat":
            return rf.forward_flat(b, cfg, kc, mc, **kw)
        if layout == "resident":
            return rr.forward_resident(b, table, n, cfg, crop=False, **kw)
        return rdn.forward_tiled(b, cfg, crop=False, **kw)

    def l2(ref_chw):
        if layout == "flat":
            return rf.l2_render_and_grads_flat(b, ref_chw, n, cfg, kc, mc, p,
                                               **kw)
        if layout == "resident":
            return rr.l2_render_and_grads_resident(b, table, ref_chw, n, cfg,
                                                   **kw)
        return rdn.l2_render_and_grads(b, ref_chw, n, cfg, p, **kw)

    def bwd(fin, gc, carry):
        if layout == "flat":
            return rf.backward_flat(b, fin, gc, n, cfg, kc, mc, p,
                                    carry_in=carry, **kw)
        if layout == "resident":
            return rr.backward_resident(b, table, fin, gc, n, cfg,
                                        carry_in=carry, **kw)
        return rdn.backward_tiled(b, fin, gc, n, cfg, p, carry_in=carry,
                                  **kw)

    return fwd, l2, bwd


def close_grads(got, want):
    for f in FIELDS:
        w = getattr(want, f)
        atol = 1e-4 * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(getattr(got, f).cpu(), w.cpu(), rtol=0,
                                   atol=atol, msg=f)


@pytest.mark.parametrize("layout,tile_h,n_bands,min_throughput", [
    ("resident", 8, 3, 1.0 / 256.0), ("resident", 32, 4, 0.0),
    ("dense", 32, 2, 1.0 / 256.0), ("dense", 32, 4, 0.0),
    ("flat", 32, 2, 1.0 / 256.0), ("flat", 64, 2, 0.0)])
def test_banded_kernels_match_plain_and_unbanded_rows(
        dev, layout, tile_h, n_bands, min_throughput):
    """Each band's forward equals the unbanded kernel's rows bit for bit;
    the banded forward, L2 step and carry-fed backward equal their plain
    versions under the same band arguments; the bands' L2 gradients summed
    in band order agree with the unbanded step's."""
    cfg, p, ref = band_case(dev, layout, 160, tile_h, n_bands, 5 + tile_h,
                            min_throughput)
    rows = cfg.n_tiles_y // n_bands
    bh = rows * tile_h
    # The whole grid's flat binning needs the whole grid's capacity.
    cfg_full = rf.tune_flat_config(p, cfg.replace(
        flat_capacity=None, flat_max_chunks=None)) if layout == "flat" \
        else cfg
    full = bin_band(p, cfg_full, layout, None)
    fwd, l2, _ = band_calls(layout, full, p, cfg_full, None)
    c_full, t_full = fwd()
    _, g_full = l2(ref[None].contiguous())
    carry = (0.5 * c_full, 0.5 * t_full)
    gc = random_cotangent(dev, cfg, 3).permute(1, 2, 0)
    total = None
    for i in range(n_bands):
        band = (i * rows, rows)
        sl = slice(i * bh, (i + 1) * bh)
        b = bin_band(p, cfg, layout, band)
        fwd, l2, bwd = band_calls(layout, b, p, cfg, band)
        c_k, t_k = fwd()
        assert torch.equal(c_k, c_full[sl]) and torch.equal(t_k, t_full[sl])
        ref_b = ref[None, :, sl].contiguous()
        col_k, g_k = l2(ref_b)
        cpu = torch.device("cpu")
        fwd_p, l2_p, bwd_p = band_calls(layout, on(cpu, b), on(cpu, p), cfg,
                                        band)
        c_p, t_p = fwd_p()
        torch.testing.assert_close(c_k.cpu(), c_p, rtol=0, atol=1e-6)
        torch.testing.assert_close(t_k.cpu(), t_p, rtol=0, atol=1e-6)
        col_p, g_p = l2_p(ref_b.cpu())
        torch.testing.assert_close(col_k.cpu(), col_p, rtol=0, atol=1e-6)
        close_grads(g_k, g_p)
        bwd_in = (c_full[sl], gc[sl].contiguous(),
                  (carry[0][sl], carry[1][sl].contiguous()))
        close_grads(bwd(*bwd_in), bwd_p(*on(cpu, bwd_in[:2]),
                                        on(cpu, bwd_in[2])))
        total = g_k if total is None else GaussianParams(
            **{f: getattr(total, f) + getattr(g_k, f) for f in FIELDS})
    close_grads(total, g_full)


@pytest.mark.parametrize("margin", [0.0, 2.0])
def test_captured_virtual_mesh_block_equals_eager(dev, margin):
    """A (1,2,2) virtual mesh (fold combine) in blocks of 3: one captured
    step holds every coordinate's band step, the combine's gathers and the
    tile axis's all-reduces as tensor operations (and under a margin a
    conditional node for each coordinate's band binning). Two blocks equal
    6 eager sharded steps bit for bit (state, mse, all_finite, n_dropped),
    one capture; the second block's replays run under sync debug mode
    "error", so nothing in a block synchronises with the host; each replay
    adds one eager step's kernel launches."""
    from gs2d_tpu_torch.io.image import synthetic_target
    from gs2d_tpu_torch.parallel import sharded as tsh
    from gs2d_tpu_torch.parallel.mesh import virtual_mesh
    from gs2d_tpu_torch.train import loop

    cfg = SplatConfig(width=W, height=H, n_splats=64, max_splats_per_tile=64,
                      rebin_margin=margin)
    mesh = virtual_mesh(1, 2, 2, dev)
    state = loop.init_batched_state(cfg, 1, dev)
    cfg = tsh.prepare_config(cfg, mesh, loop.state_index(state, 0).params)
    fit_k, sh = tsh.make_fit_scan_sharded(cfg, mesh)
    step, _ = tsh.make_sharded_train_step(cfg, mesh)
    refs = sh["ref"](tsh.pad_ref_batch(synthetic_target(H, W)[None], cfg,
                                       dev))
    before = dict(rr.launches)
    s_e, a_e = sh["state"](state), []
    for _ in range(6):
        s_e, a = step(s_e, refs)
        a_e.append(a)
    eager = {k: rr.launches[k] - before[k] for k in before}
    assert eager["fwd_resident"] == 6 * 4  # one a coordinate and step
    s_g, a1 = fit_k(sh["state"](state), refs, 3)
    before = dict(rr.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s_g, a2 = fit_k(s_g, refs, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    grown = {k: rr.launches[k] - before[k] for k in before}
    assert fit_k.captures == 1
    assert grown == {k: v // 2 for k, v in eager.items()}
    for c in mesh.coords:
        for x, y in zip(loop.state_leaves(s_g[c]), loop.state_leaves(s_e[c])):
            assert torch.equal(x, y)
        for f in ("mse", "all_finite", "n_dropped"):
            got = torch.cat([getattr(a1[c], f), getattr(a2[c], f)])
            want = torch.stack([torch.as_tensor(getattr(a[c], f))
                                for a in a_e])
            assert torch.equal(got, want), f


# ---------------------------------------------------------------------------
# The flat binning's expansion kernels (csrc/tiles_flat.cu) against their
# plain twin tiles_flat._expand_plain, run on the card's tensors.
# ---------------------------------------------------------------------------

def hd_population(dev, seed):
    """chip_smoke.py's 1080p/1M population, as the hd-1m render cell draws
    it, and its statics as the CLI's auto path tunes them."""
    from chip_smoke import hd_population as draw

    return draw(dev, seed)


def wide_population(seed, n, width=1024, height=512, scale=(1.5, 40.0)):
    """population()'s splats with wider scales, any rotation and opacities
    in [0, 1]."""
    d, _ = population(seed, n, width, height)
    rng = np.random.default_rng(seed + 1)
    d["sx"] = rng.uniform(*scale, n)
    d["sy"] = rng.uniform(*scale, n)
    d["rot"] = rng.uniform(-20.0, 20.0, n)
    d["opacity"] = rng.uniform(0.0, 1.0, n)
    return d


def expand_case(dev, case):
    """(params, cfg, m_cap, band and margin arguments) of an expansion
    case; cfg's flat statics are tuned for the case's footprints."""
    if case.startswith("hd1m"):
        p, cfg = hd_population(dev, 2300 + int(case[-1]))
        return p, cfg, cfg.flat_capacity, {}
    tile_h = 64 if case == "tile-h-64" else 32
    cfg = SplatConfig(width=1024, height=512, n_splats=20000, tile_h=tile_h,
                      binning="flat")
    d = wide_population(EXPAND_CASES.index(case), 20000)
    kw, n_bands, m_cap = {}, 1, None
    if case == "nonfinite":
        bad = {"pos": [[np.nan, 10.0], [10.0, np.nan], [np.inf, 5.0],
                       [-np.inf, 5.0], [5.0, np.inf], [-50.0, 100.0],
                       [100.0, -50.0], [1524.0, 100.0], [100.0, 1012.0],
                       [1e30, 1e30], [-1e30, 3.0], [-0.0, -0.0]],
               "sx": [0.0, np.inf, np.nan, 1e-20, 1e20, 0.0, 3.0],
               "sy": [0.0, 0.0, 5.0, 1e-20, 1e20, np.inf, np.nan],
               "rot": [np.nan, np.inf, 1e20, -1e30, 0.0, np.pi / 2, 7e4]}
        for f, vals in bad.items():
            for j, v in enumerate(vals):
                d[f][7 * j + len(f)] = v
        d["sx"][100:110] = d["sy"][100:110]  # circles
    elif case == "overflow":
        d["sx"][:300] = np.random.default_rng(5).uniform(200, 900, 300)
        d["sy"][:300] = d["sx"][:300] * 0.7
    elif case == "margin":
        kw = {"margin": 2.0}
        cfg = cfg.replace(rebin_margin=2.0)
    elif case == "band":
        n_bands = 4
        kw = {"band_row0": 8, "band_rows": 4}
    elif case.startswith("opacity-cull"):
        cfg = cfg.replace(opacity_cull_alpha=1.0 / 256.0)
        d["opacity"][:50] = 0.0
        d["opacity"][50:60] = np.nan
        if case == "opacity-cull-margin":
            kw = {"margin": 2.0}
            cfg = cfg.replace(rebin_margin=2.0)
    elif case == "no-exact-cull":
        cfg = cfg.replace(exact_cull=False)
    p = params_from_numpy({f: v.astype(np.float32) for f, v in d.items()},
                          dev)
    cfg = rf.tune_flat_config(p, cfg, n_bands=n_bands)
    m_cap = cfg.flat_capacity
    if case == "overflow":
        m_cap = 4 * cfg.flat_chunk
    return p, cfg, m_cap, kw


EXPAND_CASES = ["hd1m-0", "hd1m-1", "hd1m-2", "nonfinite", "overflow",
                "margin", "band", "opacity-cull", "opacity-cull-margin",
                "no-exact-cull", "tile-h-32", "tile-h-64"]


def same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("case", EXPAND_CASES)
def test_expansion_kernels_equal_the_plain_twin(dev, monkeypatch, case):
    """tile_e, splat_e and dropped_exp from the kernels equal the plain
    expansion's on the card, integer for integer, and so does the whole
    FlatBinning built on them (ids, rows bit for bit, start, count,
    n_dropped); one launch of the emission a binning, none on the plain
    path."""
    p, cfg, m_cap, kw = expand_case(dev, case)
    got = tlf._expand_cuda(p, cfg, m_cap, **kw)
    want = tlf._expand_plain(p, cfg, m_cap, **kw)
    for g, w, name in zip(got, want, ("tile_e", "splat_e", "dropped_exp")):
        assert g.dtype == torch.int32 and same_bits(g, w), name
    live = int((got[1] >= 0).sum())
    assert live > 0
    if case == "overflow":
        assert int(got[2]) > 0 and live <= m_cap
    if case in ("nonfinite", "opacity-cull"):
        assert int((got[1] < 0).sum()) > 0
    kc, mc = cfg.flat_chunk, cfg.flat_max_chunks
    before = tlf.launches["expand_flat"]
    b_k = tlf.bin_splats_flat(p, cfg, m_cap, kc=kc, max_chunks=mc, **kw)
    assert tlf.launches["expand_flat"] == before + 1
    monkeypatch.setattr(tlf, "on_card", lambda t: False)
    b_p = tlf.bin_splats_flat(p, cfg, m_cap, kc=kc, max_chunks=mc, **kw)
    assert tlf.launches["expand_flat"] == before + 1
    for f in tlf.FlatBinning._fields:
        assert same_bits(getattr(b_k, f), getattr(b_p, f)), f


def test_expansion_trig_is_torchs_on_every_float32(dev):
    """cosf and sinf as the expansion's kernels compute them equal
    torch.cos and torch.sin on the card for every float32 bit pattern
    (NaN for NaN)."""
    chunk = 1 << 26
    for lo in range(-2**31, 2**31, chunk):
        v = torch.arange(lo, lo + chunk, dtype=torch.int64, device=dev) \
            .to(torch.int32).view(torch.float32)
        c, s = tlf.expand_trig_cuda(v)
        for got, want, name in ((c, torch.cos(v), "cos"),
                                (s, torch.sin(v), "sin")):
            same = (got.view(torch.int32) == want.view(torch.int32)) \
                | (torch.isnan(got) & torch.isnan(want))
            bad = torch.nonzero(~same)[:4, 0]
            assert bad.numel() == 0, (name, v[bad].tolist(),
                                      got[bad].tolist(), want[bad].tolist())


def test_render_flat_frame_equals_the_plain_expansions(dev, monkeypatch):
    """render_flat's 1080p/1M frame from the kernels' binning is the frame
    of the plain expansion's, bit for bit; one emission a render."""
    p, cfg = hd_population(dev, 2310)
    before = tlf.launches["expand_flat"]
    color_k, drop_k = rf.render_flat(p, cfg)
    assert tlf.launches["expand_flat"] == before + 1
    monkeypatch.setattr(tlf, "on_card", lambda t: False)
    color_p, drop_p = rf.render_flat(p, cfg)
    assert tlf.launches["expand_flat"] == before + 1
    assert same_bits(color_k, color_p)
    assert int(drop_k) == int(drop_p) == 0


def flat_fit_case(dev, margin, width=256, height=128, n=2048):
    from gs2d_tpu_torch.io.image import synthetic_target
    from gs2d_tpu_torch.train import loop

    cfg = SplatConfig(width=width, height=height, n_splats=n, tile_h=32,
                      binning="flat", rebin_margin=margin,
                      learning_rate=0.5)
    state = loop.init_train_state(cfg, dev)
    cfg = rf.tune_flat_config(state.params, cfg)
    return cfg, state, rd.pad_ref_chw(synthetic_target(height, width), cfg,
                                      dev)


@pytest.mark.parametrize("margin", [0.0, 2.0, 0.25])
def test_captured_flat_fit_equals_the_plain_expansions(dev, monkeypatch,
                                                       margin):
    """A captured flat fit (its binning in the CUDA graph, under the "if"
    node where margin > 0) over 12 steps equals the same captured fit with
    the plain expansion bit for bit: states, MSEs, rebins."""
    from gs2d_tpu_torch.train import loop

    cfg, state, ref = flat_fit_case(dev, margin)
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(tlf, "on_card", lambda t: False)
        before = tlf.launches["expand_flat"]
        s, aux = loop.make_fit_scan_fused(cfg)(state, ref, 12)
        torch.cuda.synchronize()
        runs.append((s, aux, tlf.launches["expand_flat"] - before))
    (s_k, a_k, n_k), (s_p, a_p, n_p) = runs
    assert n_k > 0 and n_p == 0
    for f in ("mse", "rebinned", "n_dropped"):
        assert same_bits(getattr(a_k, f), getattr(a_p, f)), f
    for a, b in zip(loop.state_leaves(s_k), loop.state_leaves(s_p)):
        assert same_bits(a, b)
    if margin == 0.25:
        assert 0 < int(a_k.rebinned.sum()) < 12


def test_captured_two_band_mesh_equals_the_plain_expansions(dev,
                                                            monkeypatch):
    """A (1,2,1) virtual mesh of the flat fit in a block of 6 captured steps
    (each band's binning under its conditional node, margin 2) equals the
    same block with the plain expansion bit for bit, band for band."""
    from gs2d_tpu_torch.io.image import synthetic_target
    from gs2d_tpu_torch.parallel import sharded as tsh
    from gs2d_tpu_torch.parallel.mesh import virtual_mesh
    from gs2d_tpu_torch.train import loop

    cfg = SplatConfig(width=256, height=128, n_splats=2048, tile_h=32,
                      binning="flat", rebin_margin=2.0, learning_rate=0.5)
    mesh = virtual_mesh(1, 2, 1, dev)
    state = loop.init_batched_state(cfg, 1, dev)
    cfg = tsh.prepare_config(cfg, mesh, loop.state_index(state, 0).params)
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(tlf, "on_card", lambda t: False)
        before = tlf.launches["expand_flat"]
        fit_k, sh = tsh.make_fit_scan_sharded(cfg, mesh)
        refs = sh["ref"](tsh.pad_ref_batch(synthetic_target(128, 256)[None],
                                           cfg, dev))
        s, a = fit_k(sh["state"](state), refs, 6)
        torch.cuda.synchronize()
        runs.append((s, a, tlf.launches["expand_flat"] - before))
    (s_k, a_k, n_k), (s_p, a_p, n_p) = runs
    assert n_k > 0 and n_p == 0
    for c in mesh.coords:
        for x, y in zip(loop.state_leaves(s_k[c]), loop.state_leaves(s_p[c])):
            assert same_bits(x, y)
        for f in ("mse", "n_dropped"):
            assert same_bits(torch.as_tensor(getattr(a_k[c], f)),
                             torch.as_tensor(getattr(a_p[c], f))), f


# ---------------------------------------------------------------------------
# Kernel 10's tail after the saturation exit: the non-finite mask pass and
# the walk that reads it, against the full cull (walked given) and the chunk
# reference, on 1080p/1M populations.
# ---------------------------------------------------------------------------

TAIL_SEED = 2600


def hd_flat(dev, tile_h, seed=TAIL_SEED):
    """A 1080p/1M population (hd_population) with its flat statics tuned
    at tile height ``tile_h``, and its flat binning."""
    p, cfg = hd_population(dev, seed)
    if cfg.tile_h != tile_h:
        cfg = rf.tune_flat_config(p, cfg.replace(tile_h=tile_h))
    b = tlf.bin_splats_flat(p, cfg, cfg.flat_capacity, kc=cfg.flat_chunk,
                            max_chunks=cfg.flat_max_chunks)
    assert int(b.n_dropped) == 0
    return p, cfg, b


def patch_count(cfg, gy=None):
    return cfg.n_tiles_x * (gy or cfg.n_tiles_y) * rr.patches_per_tile(
        cfg, rr.patch_rows())


def kernel_10_both_ways(rows, b, cfg, **band):
    """Kernel 10 with the mask (walked None; its exits) and with the full
    cull (walked given): ((colour, T, exits), (colour, T, walked))."""
    kc, mc = cfg.flat_chunk, cfg.flat_max_chunks
    gy = band.get("band_rows")
    exits = torch.full((patch_count(cfg, gy),), -1, dtype=torch.int32,
                       device=rows.device)
    walked = torch.full((patch_count(cfg, gy), 2), -1, dtype=torch.int32,
                        device=rows.device)
    before = dict(rf.launches)
    c_m, t_m = rf._fwd_flat_cuda(rows, b.start, b.count, cfg, kc, mc,
                                 exits=exits, **band)
    c_f, t_f = rf._fwd_flat_cuda(rows, b.start, b.count, cfg, kc, mc,
                                 walked=walked, **band)
    torch.cuda.synchronize()
    assert rf.launches["fwd_flat"] == before["fwd_flat"] + 2
    assert rf.launches["fwd_flat_mask"] == before["fwd_flat_mask"] + 1
    return (c_m, t_m, exits), (c_f, t_f, walked)


def run_lengths(b, cfg):
    """(n_tiles,) listed slots of each run: count capped at max_chunks * kc."""
    return b.count.clamp(max=cfg.flat_max_chunks * cfg.flat_chunk)


@pytest.mark.parametrize("case", ["hd1m", "ragged"])
def test_nonfinite_mask_kernel_equals_its_twin(dev, case):
    """The mask pass's words equal _nonfinite_mask_plain's bit for bit: on
    the rows of a 1080p/1M binning with non-finite values planted in every
    field, and on 1,000 random rows (M not a multiple of 32, the last word
    ragged)."""
    gen = torch.Generator(dev).manual_seed(TAIL_SEED + len(case))
    if case == "hd1m":
        rows = hd_flat(dev, 64)[2].rows.clone()
    else:
        rows = torch.randn((1000, tl.N_FIELDS), generator=gen, device=dev)
    m = rows.shape[0]
    at = torch.randint(0, m, (64,), generator=gen, device=dev)
    for i in range(64):
        rows[at[i], i % tl.N_FIELDS] = (float("nan"), float("inf"),
                                        -float("inf"))[i % 3]
    rows[m - 1, tl.FIELD_CB] = float("nan")
    before = rf.launches["fwd_flat_mask"]
    got = rf._nonfinite_mask_cuda(rows)
    want = rf._nonfinite_mask_plain(rows)
    assert rf.launches["fwd_flat_mask"] == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert int((want != 0).sum()) > 0


@pytest.mark.parametrize("tile_h", [32, 64])
def test_kernel_10_tail_equals_full_cull_and_chain(dev, tile_h):
    """On a seeded 1080p/1M population kernel 10 with the mask (every
    production call) equals, bit for bit in colour and T, its full cull
    (walked given, the walk before the mask) and the chunk reference
    gs2d_fwd_chunk over the same rows; each patch's exit slot lies within
    its run, and nearly every patch exits before its run's end."""
    p, cfg, b = hd_flat(dev, tile_h)
    (c_m, t_m, exits), (c_f, t_f, walked) = kernel_10_both_ways(b.rows, b,
                                                                cfg)
    tp = flat_listed_rows(b, dev)
    c_r, t_r = rdn._fwd_chunk_cuda(tp, run_lengths(b, cfg), cfg)
    torch.cuda.synchronize()
    for got, want in ((c_m, c_f), (t_m, t_f), (c_m, c_r), (t_m, t_r)):
        assert same_bits(got, want)
    n = run_lengths(b, cfg).repeat_interleave(
        rr.patches_per_tile(cfg, rr.patch_rows()))
    assert bool(((exits >= 0) & (exits <= n)).all())
    assert float((exits < n).float().mean()) > 0.9
    assert bool((walked[:, 1] <= walked[:, 0]).all())


def plant_slots(case, exits, n, start, cfg):
    """(tile, [slots]) of a planted case, from the unplanted run's exit
    slots (n_tiles, patches) and run lengths n (n_tiles,)."""
    first, last = exits.min(dim=1).values, exits.max(dim=1).values
    if case == "padding-patch":
        # The bottom tile row's patches below the image start saturated.
        t = (cfg.n_tiles_y - 1) * cfg.n_tiles_x
        assert int(first[t]) == 0
        return t, [int(n[t]) // 2]
    if case == "before-exit":
        t = int(torch.argmax(torch.where(first > 0, n, 0)))
        return t, [int(first[t]) - 1]
    room = torch.where(last + 100 < n, n, 0)
    t = int(torch.argmax(room))
    assert int(room[t]) > 0
    k = (int(last[t]) + 64) // 32 * 32  # a chunk wholly after every exit
    if case == "after-exit-mid-chunk":
        return t, [k + 11, k + 17]
    if case == "alone-in-word":
        return t, [k + 5]
    if case == "word-boundary":
        s = int(start[t])
        k += 31 - (s + k) % 32  # flat rows 32 w + 31 and 32 (w + 1)
        return t, [k, k + 1]
    assert case == "last-listed-row"
    return t, [int(n[t]) - 1]


PLANT_CASES = ["before-exit", "after-exit-mid-chunk", "last-listed-row",
               "alone-in-word", "word-boundary", "padding-patch"]


@pytest.mark.parametrize("field", ["colour", "opacity"])
@pytest.mark.parametrize("tile_h", [32, 64])
@pytest.mark.parametrize("case", PLANT_CASES)
def test_kernel_10_tail_walks_planted_non_finite_rows(dev, case, tile_h,
                                                      field):
    """A 1080p/1M population with non-finite rows planted before every
    patch's exit, after it (two in one chunk, one alone in its word, two
    across a word boundary, the run's last listed row) and in a tile whose
    bottom patches lie below the image (saturated from the start): kernel
    10 with the mask equals its full cull bit for bit (NaN masks equal). A
    NaN red channel is walked by every patch of its tile (0 * NaN where the
    step is not live), so the tile's red plane is NaN throughout; a NaN
    opacity adds nothing past an exit, so the chunk reference, which stops
    at its passes' exits, agrees as well."""
    p, cfg, b = hd_flat(dev, tile_h)
    n = run_lengths(b, cfg)
    (_, _, exits), _ = kernel_10_both_ways(b.rows, b, cfg)
    per_tile = rr.patches_per_tile(cfg, rr.patch_rows())
    t, slots = plant_slots(case, exits.reshape(-1, per_tile), n, b.start,
                           cfg)
    rows = b.rows.clone()
    f = tl.FIELD_CR if field == "colour" else tl.FIELD_OP
    for k in slots:
        assert 0 <= k < int(n[t])
        rows[int(b.start[t]) + k, f] = float("nan")
    (c_m, t_m, _), (c_f, t_f, _) = kernel_10_both_ways(rows, b, cfg)
    assert same_bits(c_m, c_f) and same_bits(t_m, t_f)
    tiles = rd.to_tiles(c_m, cfg)
    if field == "colour":
        assert bool(torch.isnan(tiles[0, t]).all())
        assert int(torch.isnan(c_m[0]).sum()) == cfg.tile_h * cfg.tile_w
        assert bool(torch.isfinite(c_m[1:]).all())
    else:
        c_r, t_r = rdn._fwd_chunk_cuda(
            flat_listed_rows(b._replace(rows=rows), dev), n, cfg)
        assert same_bits(c_m, c_r) and same_bits(t_m, t_r)


@pytest.mark.parametrize("band", [(8, 4), (13, 4)])
def test_kernel_10_tail_in_a_band(dev, band):
    """A band of tile rows (row_off > 0; the second holds the patches
    below the image): kernel 10 with the mask equals its full cull and the
    unbanded frame's rows bit for bit, with a NaN red channel planted
    after the exits of one of the band's tiles."""
    p, cfg, b = hd_flat(dev, 64)
    r0, nr = band
    assert r0 + nr == cfg.n_tiles_y or band == (8, 4)
    kw = dict(band_row0=r0, band_rows=nr)
    bb = tlf.bin_splats_flat(p, cfg, cfg.flat_capacity, kc=cfg.flat_chunk,
                             max_chunks=cfg.flat_max_chunks, **kw)
    assert int(bb.n_dropped) == 0
    (c_m, t_m, exits), (c_f, t_f, _) = kernel_10_both_ways(bb.rows, bb, cfg,
                                                           **kw)
    c_u, t_u = rf._fwd_flat_cuda(b.rows, b.start, b.count, cfg,
                                 cfg.flat_chunk, cfg.flat_max_chunks)
    rows_px = slice(r0 * cfg.tile_h, (r0 + nr) * cfg.tile_h)
    assert same_bits(c_m, c_f) and same_bits(t_m, t_f)
    assert same_bits(c_m, c_u[:, rows_px]) and same_bits(t_m, t_u[rows_px])
    n = run_lengths(bb, cfg)
    per_tile = rr.patches_per_tile(cfg, rr.patch_rows())
    t, slots = plant_slots("alone-in-word", exits.reshape(-1, per_tile), n,
                           bb.start, cfg)
    rows = bb.rows.clone()
    rows[int(bb.start[t]) + slots[0], tl.FIELD_CR] = float("nan")
    (c_m, t_m, _), (c_f, t_f, _) = kernel_10_both_ways(rows, bb, cfg, **kw)
    assert same_bits(c_m, c_f) and same_bits(t_m, t_f)
    assert int(torch.isnan(c_m[0]).sum()) == cfg.tile_h * cfg.tile_w
