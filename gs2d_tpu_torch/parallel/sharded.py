"""Sharded training over a (data, tile, splat) mesh (the counterpart of
``gs2d_tpu/parallel/sharded.py``, its ``renderer="pallas"`` branches: the
port trains through the layout's kernels and has no scan rasterizer).

- **data axis**: independent images; each owns a full splat population.
- **tile axis**: each rank renders a horizontal band of tile rows: it bins
  its band (``tiles.bin_splats`` / ``tiles_flat.bin_splats_flat`` with band
  arguments, tile ids band-local) and runs the layout's kernels on it with
  the band's row offset. Per-splat gradients are partial sums over the
  band's pixels and are summed over this axis (the gradient all-reduce),
  in ``overlap_chunks`` sub-bands whose all-reduces are issued as each
  sub-band's backward ends and waited for before Adam.
- **splat axis**: each rank owns a contiguous, index-ordered slice of the
  population and its Adam state. Per-pixel composite partials (C, T)
  combine exactly in index order with the ordered monoid
  combine((Ca, Ta), (Cb, Tb)) = (Ca + Ta * Cb, Ta * Tb): ``"fold"``
  all-gathers the shards' (C, T) and folds them (``fold_stack``);
  ``"scan"`` runs log2(S) Hillis-Steele rounds of neighbour exchanges. The
  prefix (C_in, T_in) entering each shard feeds its carry-fed backward.

Early-out note: the reference's T < 1/256 skip (main.cpp:518-521) is a
predicate on the global running transmittance, which breaks
associativity; with more than one splat shard the step renders with
``min_throughput = 0`` (the exact monoid), and with one it keeps the
reference semantics, the fused L2 kernel running each sub-band.

A mesh's ``comm`` does the collectives: ``DistComm`` over the process
groups of a ``torch.distributed`` DeviceMesh (NCCL or gloo), or
``VirtualComm`` for a virtual mesh, where one process holds every
coordinate and combines them in place in index order. The step is one
program over a dict {coordinate: value} of the coordinates this process
holds (one for a process mesh). State lives per coordinate as a batched
TrainState of its images and its splat slice (``shard_state``);
``fit_sharded`` takes and returns the whole batched state, which every rank
holds (``multihost.put_global`` / ``fetch_replicated``). On the card a
scanned block (``make_fit_scan_sharded``) replays one captured step on
every mesh, its collectives (NCCL on a process mesh) in the graph, and
reduces the aux over the mesh once at the block's end.
``init_batched_state`` and ``pad_ref_batch`` are gs2d_tpu's batched
helpers, shared with the batched fitters of ``train/loop.py``.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_dense as rdn
from gs2d_tpu_torch.ops import render_flat as rf
from gs2d_tpu_torch.ops import render_resident as rr
from gs2d_tpu_torch.ops import tiles as tl
from gs2d_tpu_torch.ops import tiles_flat as tlf
from gs2d_tpu_torch.parallel.mesh import (AXES, DATA_AXIS, SPLAT_AXIS,
                                          TILE_AXIS)
from gs2d_tpu_torch.parallel.multihost import (fetch_replicated,
                                               gather_leaves, put_global,
                                               shard_index)
from gs2d_tpu_torch.params import FIELDS, GaussianParams
from gs2d_tpu_torch.train import graphs
from gs2d_tpu_torch.train.adam import AdamState, adam_update
from gs2d_tpu_torch.train.loop import (BlockLog, StepAux, TrainState,
                                       grad_mag, init_batched_state,
                                       stack_states, state_from_leaves,
                                       state_index, state_leaves)
from gs2d_tpu_torch.train.metrics import psnr_from_mse
from gs2d_tpu_torch.train.ssim import conv_flags, mixed_loss

__all__ = [
    "init_batched_state", "pad_ref_batch", "params_pspec", "state_pspec",
    "ref_pspec", "fold_stack", "VirtualComm", "DistComm",
    "make_sharded_train_step", "make_fit_scan_sharded", "fit_sharded",
    "prepare_config", "shard_state", "shard_refs", "gather_state"]


def pad_ref_batch(refs, cfg: SplatConfig, device) -> torch.Tensor:
    """(B, H, W, 3) targets zero-padded to the tile grid: (B, Hp, Wp, 3)."""
    refs = torch.as_tensor(np.asarray(refs, np.float32), device=device)
    out = torch.zeros((refs.shape[0], cfg.padded_height, cfg.padded_width, 3),
                      dtype=torch.float32, device=device)
    out[:, : cfg.height, : cfg.width] = refs
    return out


# ---------------------------------------------------------------------------
# Collectives over dicts {coordinate: tensor}.
# ---------------------------------------------------------------------------

_AXIS_INDEX = {a: i for i, a in enumerate(AXES)}


def _with(coord, axis: str, i: int) -> tuple:
    c = list(coord)
    c[_AXIS_INDEX[axis]] = i
    return tuple(c)


class VirtualComm:
    """The collectives of a virtual mesh: every member's value is in this
    process; sums add the members in index order, a shift reads the
    member ``k`` places before."""

    def __init__(self, mesh):
        self.mesh = mesh

    def _members(self, coord, axis: str) -> list:
        return [_with(coord, axis, i) for i in range(self.mesh.shape[axis])]

    def all_gather(self, axis: str, xs: dict) -> dict:
        """{coord: [the axis group's values in index order]}."""
        return {c: [xs[m] for m in self._members(c, axis)] for c in xs}

    def all_reduce(self, axis: str, xs: dict, op: str = "sum") -> dict:
        out = {}
        for c in xs:
            ms = self._members(c, axis)
            acc = xs[ms[0]]
            for m in ms[1:]:
                acc = acc + xs[m] if op == "sum" else torch.maximum(acc, xs[m])
            # Contiguous, as a process mesh's buffers are: a later sum over
            # the tensor then adds in the same order.
            out[c] = acc.contiguous()
        return out

    def all_reduce_start(self, axis: str, xs: dict):
        """An all-reduce (sum) issued now; the returned callable waits for
        it and returns its result."""
        out = self.all_reduce(axis, xs)
        return lambda: out

    def shift(self, axis: str, k: int, xs: dict) -> dict:
        """{coord: the value of the member (index - k) mod size}."""
        s = self.mesh.shape[axis]
        return {c: xs[_with(c, axis, (c[_AXIS_INDEX[axis]] - k) % s)]
                for c in xs}


class DistComm:
    """The collectives of a process mesh: the same calls over the axis
    process groups of the torch DeviceMesh, one coordinate a process. Over
    an axis of size 1 each returns its input, as the virtual mesh does,
    and calls no collective."""

    def __init__(self, mesh):
        self.mesh = mesh

    def _group(self, axis: str):
        return self.mesh.device_mesh.get_group(axis)

    def all_gather(self, axis: str, xs: dict) -> dict:
        (c, x), = xs.items()
        x = x.contiguous()
        if self.mesh.shape[axis] == 1:
            return {c: [x]}
        out = [torch.empty_like(x) for _ in range(self.mesh.shape[axis])]
        dist.all_gather(out, x, group=self._group(axis))
        return {c: out}

    def all_reduce(self, axis: str, xs: dict, op: str = "sum") -> dict:
        (c, x), = xs.items()
        if self.mesh.shape[axis] == 1:
            return {c: x.contiguous()}
        # Contiguous: the ranks' buffers are combined in memory order.
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=self._group(axis))
        return {c: y}

    def all_reduce_start(self, axis: str, xs: dict):
        (c, x), = xs.items()
        if self.mesh.shape[axis] == 1:
            y = x.contiguous()
            return lambda: {c: y}
        y = x.clone(memory_format=torch.contiguous_format)
        work = dist.all_reduce(y, group=self._group(axis), async_op=True)

        def wait():
            work.wait()
            return {c: y}

        return wait

    def shift(self, axis: str, k: int, xs: dict) -> dict:
        (c, x), = xs.items()
        s = self.mesh.shape[axis]
        if k % s == 0:
            return {c: x}
        i = c[_AXIS_INDEX[axis]]
        x = x.contiguous()
        buf = torch.empty_like(x)
        dst = self.mesh.rank_of(_with(c, axis, (i + k) % s))
        src = self.mesh.rank_of(_with(c, axis, (i - k) % s))
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, dst),
                dist.P2POp(dist.irecv, buf, src)]):
            req.wait()
        return {c: buf}


def _reduce_axes(comm, axes, xs: dict, op: str = "sum") -> dict:
    for axis in axes:
        xs = comm.all_reduce(axis, xs, op)
    return xs


# ---------------------------------------------------------------------------
# The ordered (C, T) combine over the splat axis.
# ---------------------------------------------------------------------------

def fold_stack(Call: torch.Tensor, Tall: torch.Tensor, idx: int):
    """The ordered-monoid fold of the (S, ...) stacks of the splat shards'
    colour (S, h, w, 3) and transmittance (S, h, w), in index order, for
    shard ``idx``: (final colour, final T, C_in and T_in, the prefix of the
    shards before ``idx``) -- gs2d_tpu's _ordered_monoid_fold after its
    all_gather, as a plain function."""
    s = Call.shape[0]
    Texc = torch.cat([torch.ones_like(Tall[:1]),
                      torch.cumprod(Tall[:-1], dim=0)], dim=0)
    fin = torch.sum(Call * Texc[..., None], dim=0)
    T_fin = Texc[-1] * Tall[-1]
    mask = (torch.arange(s, device=Call.device) < idx).to(torch.float32)
    C_in = torch.sum(Call * Texc[..., None] * mask[:, None, None, None],
                     dim=0)
    return fin, T_fin, C_in, Texc[idx]


def _ordered_monoid_fold(comm, C_loc: dict, T_loc: dict,
                         axis: str = SPLAT_AXIS):
    """All-gather the shards' (C, T) over ``axis``, then ``fold_stack``:
    {coord: (fin, T_fin, C_in, T_in)}."""
    Cs = comm.all_gather(axis, C_loc)
    Ts = comm.all_gather(axis, T_loc)
    return {c: fold_stack(torch.stack(Cs[c]), torch.stack(Ts[c]),
                          c[_AXIS_INDEX[axis]]) for c in C_loc}


def _ordered_monoid_scan(comm, C_loc: dict, T_loc: dict,
                         axis: str = SPLAT_AXIS):
    """The same combine by Hillis-Steele rounds of neighbour shifts over
    ``axis`` (log2(S) exchanges of one band each), then a masked all-reduce
    of the last shard's inclusive prefix: {coord: (fin, T_fin, C_in,
    T_in)}, as gs2d_tpu's _ordered_monoid_scan."""
    s = comm.mesh.shape[axis]
    ai = _AXIS_INDEX[axis]
    acc = {c: (C_loc[c], T_loc[c]) for c in C_loc}
    shift = 1
    while shift < s:
        rc = comm.shift(axis, shift, {c: a[0] for c, a in acc.items()})
        rt = comm.shift(axis, shift, {c: a[1] for c, a in acc.items()})
        new = {}
        for c, (Cb, Tb) in acc.items():
            if c[ai] >= shift:  # combine(older = received, newer = own)
                new[c] = (rc[c] + rt[c][..., None] * Cb, rt[c] * Tb)
            else:
                new[c] = (Cb, Tb)
        acc = new
        shift *= 2
    last = {c: c[ai] == s - 1 for c in acc}
    fin = comm.all_reduce(axis, {c: a[0] if last[c] else torch.zeros_like(a[0])
                                 for c, a in acc.items()})
    T_fin = comm.all_reduce(axis, {c: a[1] if last[c]
                                   else torch.zeros_like(a[1])
                                   for c, a in acc.items()})
    C_prev = comm.shift(axis, 1, {c: a[0] for c, a in acc.items()})
    T_prev = comm.shift(axis, 1, {c: a[1] for c, a in acc.items()})
    out = {}
    for c in acc:
        first = c[ai] == 0
        out[c] = (fin[c], T_fin[c],
                  torch.zeros_like(C_prev[c]) if first else C_prev[c],
                  torch.ones_like(T_prev[c]) if first else T_prev[c])
    return out


# ---------------------------------------------------------------------------
# The band step.
# ---------------------------------------------------------------------------

def _pack(g: GaussianParams) -> torch.Tensor:
    """One flat tensor of a gradient (one all-reduce for the nine rows)."""
    return torch.cat([getattr(g, f).reshape(-1) for f in FIELDS])


def _unpack(flat: torch.Tensor, like: GaussianParams) -> GaussianParams:
    out, i = {}, 0
    for f in FIELDS:
        x = getattr(like, f)
        out[f] = flat[i: i + x.numel()].reshape(x.shape)
        i += x.numel()
    return GaussianParams(**out)


class _Plan(NamedTuple):
    """The statics of a sharded step (``_validate_band_mesh`` and the cfg)."""

    cfg: SplatConfig          # the fit's (Adam, metrics)
    cfg_shard: SplatConfig    # the kernels' (min_throughput 0 with shards)
    layout: str
    n_splat: int
    monoid: object
    band_h: int
    band_tile_rows: int
    overlap_chunks: int
    ssim_lambda: float
    n_real_px: int
    with_grad_mag: bool       # compute the densify signal |dL/d pos|


def _band_r0(plan: _Plan, coord) -> int:
    return coord[_AXIS_INDEX[TILE_AXIS]] * plan.band_tile_rows


def _bin_band(params: GaussianParams, plan: _Plan, r0: int,
              margin: float = 0.0, ids_only: bool = False):
    """The band's binning in the plan's layout, from tile row ``r0``."""
    cfg = plan.cfg_shard
    if plan.layout == "flat":
        return tlf.bin_splats_flat(
            params, cfg, cfg.flat_capacity, kc=cfg.flat_chunk,
            max_chunks=cfg.flat_max_chunks, band_row0=r0,
            band_rows=plan.band_tile_rows, ids_only=ids_only, margin=margin)
    return tl.bin_splats(params, cfg, rd._max_per_tile(cfg), band_row0=r0,
                         band_rows=plan.band_tile_rows,
                         ids_only=ids_only or plan.layout == "resident",
                         margin=margin)


def _sub_binning(binning, plan: _Plan, sub: int):
    """Sub-band ``sub`` of a band's binning (gs2d_tpu's sub_binning): the
    tiles of its rows; for the flat layout the ids outside its flat rows
    masked to -1."""
    cfg = plan.cfg_shard
    gx = cfg.n_tiles_x
    rows_per = plan.band_tile_rows // plan.overlap_chunks
    t0, t1 = sub * rows_per * gx, (sub + 1) * rows_per * gx
    if plan.layout == "flat":
        n_band_tiles = plan.band_tile_rows * gx
        row_lo = binning.start[t0]
        row_hi = binning.start[t1] if t1 < n_band_tiles \
            else torch.full_like(row_lo, cfg.flat_capacity)
        j = torch.arange(cfg.flat_capacity, dtype=torch.int32,
                         device=binning.ids.device)
        in_sub = (j >= row_lo) & (j < row_hi)
        return tlf.FlatBinning(
            ids=torch.where(in_sub, binning.ids, -1), rows=binning.rows,
            start=binning.start[t0:t1].contiguous(),
            count=binning.count[t0:t1].contiguous(),
            n_dropped=binning.n_dropped)
    return tl.TileBinning(
        ids=binning.ids[t0:t1].contiguous(),
        count=binning.count[t0:t1].contiguous(),
        n_dropped=binning.n_dropped,
        tile_params=(None if binning.tile_params is None
                     else binning.tile_params[t0:t1].contiguous()))


def _pallas_band_step(comm, items: dict, plan: _Plan, cot_fn=None,
                      prebuilt: Optional[dict] = None):
    """The band step of every coordinate in ``items`` {coord: (params,
    ref_band)} (gs2d_tpu's _pallas_band_step): bin the band once (or take
    ``prebuilt`` {coord: binning}, the lazy cache's), then with one splat
    shard and no ``cot_fn`` the fused L2 kernel per sub-band, else the
    band's forward, the ordered combine, and the carry-fed backward per
    sub-band under the cotangent fin - ref or ``cot_fn`` ({coord: fin} ->
    {coord: cotangent}). Each sub-band's gradients are all-reduced over the
    tile axis as soon as they are computed and added in sub-band order.
    Returns {coord: (band colour (band_h, Wp, 3), grads, n_dropped)}."""
    cfg = plan.cfg_shard
    flat, resident = plan.layout == "flat", plan.layout == "resident"
    th = cfg.tile_h
    rows_per = plan.band_tile_rows // plan.overlap_chunks
    kc, mc = cfg.flat_chunk, cfg.flat_max_chunks
    binnings, tables = {}, {}
    for c, (params, _) in items.items():
        binnings[c] = (prebuilt[c] if prebuilt is not None
                       else _bin_band(params, plan, _band_r0(plan, c)))
        if resident:
            tables[c] = rr.resident_table(params, cfg)

    def px(sub):
        return slice(sub * rows_per * th, (sub + 1) * rows_per * th)

    def sub_band(c, sub):
        return dict(band_row0=_band_r0(plan, c) + sub * rows_per,
                    band_rows=rows_per)

    pending = []
    if plan.n_splat == 1 and cot_fn is None:
        bands = {c: [] for c in items}
        for sub in range(plan.overlap_chunks):
            g_sub = {}
            for c, (params, ref_band) in items.items():
                sb = _sub_binning(binnings[c], plan, sub)
                ref_chw = ref_band[px(sub)].permute(2, 0, 1)[None] \
                    .contiguous()
                n_local = params.n
                if flat:
                    C_sub, g = rf.l2_render_and_grads_flat(
                        sb, ref_chw, n_local, cfg, kc, mc, params,
                        **sub_band(c, sub))
                elif resident:
                    C_sub, g = rr.l2_render_and_grads_resident(
                        sb, tables[c], ref_chw, n_local, cfg,
                        **sub_band(c, sub))
                else:
                    C_sub, g = rdn.l2_render_and_grads(
                        sb, ref_chw, n_local, cfg, params,
                        **sub_band(c, sub))
                bands[c].append(C_sub)
                g_sub[c] = _pack(g)
            pending.append(comm.all_reduce_start(TILE_AXIS, g_sub))
        fins = {c: torch.cat(b, dim=0) for c, b in bands.items()}
    else:
        C_loc, T_loc = {}, {}
        band = dict(band_rows=plan.band_tile_rows)
        for c, (params, _) in items.items():
            r0 = _band_r0(plan, c)
            if flat:
                C_loc[c], T_loc[c] = rf.forward_flat(
                    binnings[c], cfg, kc, mc, band_row0=r0, **band)
            elif resident:
                C_loc[c], T_loc[c] = rr.forward_resident(
                    binnings[c], tables[c], params.n, cfg, crop=False,
                    band_row0=r0, **band)
            else:
                C_loc[c], T_loc[c] = rdn.forward_tiled(
                    binnings[c], cfg, crop=False, band_row0=r0, **band)
        comb = plan.monoid(comm, C_loc, T_loc, SPLAT_AXIS)
        fins = {c: v[0] for c, v in comb.items()}
        gCs = ({c: fins[c] - items[c][1] for c in items} if cot_fn is None
               else cot_fn(fins))
        for sub in range(plan.overlap_chunks):
            g_sub = {}
            for c, (params, _) in items.items():
                p = px(sub)
                sb = _sub_binning(binnings[c], plan, sub)
                carry = (comb[c][2][p], comb[c][3][p])
                fin, gC = fins[c][p], gCs[c][p]
                if flat:
                    g = rf.backward_flat(sb, fin, gC, params.n, cfg, kc, mc,
                                         params, carry_in=carry,
                                         **sub_band(c, sub))
                elif resident:
                    g = rr.backward_resident(sb, tables[c], fin, gC,
                                             params.n, cfg, carry_in=carry,
                                             **sub_band(c, sub))
                else:
                    g = rdn.backward_tiled(sb, fin, gC, params.n, cfg,
                                           params, carry_in=carry,
                                           **sub_band(c, sub))
                g_sub[c] = _pack(g)
            pending.append(comm.all_reduce_start(TILE_AXIS, g_sub))
    # Wait before Adam; add the sub-bands in order, as gs2d_tpu does.
    total = None
    for wait in pending:
        g = wait()
        total = g if total is None else {c: total[c] + g[c] for c in g}
    return {c: (fins[c], _unpack(total[c], items[c][0]),
                binnings[c].n_dropped) for c in items}


def _validate_band_mesh(cfg: SplatConfig, mesh, combine: str,
                        renderer: str, overlap_chunks: int):
    """Shared mesh/band validation of the step builders (gs2d_tpu's):
    returns (band_h, band_tile_rows, overlap_chunks)."""
    if combine not in ("fold", "scan"):
        raise ValueError(f"unknown combine {combine!r}")
    if renderer == "scan":
        raise ValueError(
            "renderer 'scan' (gs2d_tpu's lax.scan rasterizer) is not ported: "
            "the port trains through the layout's kernels (renderer="
            "'pallas')")
    if renderer != "pallas":
        raise ValueError(f"unknown renderer {renderer!r}")
    if rf.use_flat(cfg) and (cfg.flat_capacity is None
                             or cfg.flat_max_chunks is None):
        raise ValueError(
            "flat binning statics unset; call tune_flat_config(params, "
            "cfg, n_bands=<tile axis size>) before building the step")
    n_tile = mesh.shape[TILE_AXIS]
    n_splat = mesh.shape[SPLAT_AXIS]
    if cfg.padded_height % n_tile:
        raise ValueError(
            f"padded height {cfg.padded_height} not divisible by tile axis "
            f"{n_tile}; adjust tile_h or mesh")
    if cfg.n_splats % n_splat:
        raise ValueError("n_splats must divide over the splat axis")
    band_h = cfg.padded_height // n_tile
    if band_h % cfg.tile_h:
        raise ValueError("tile-axis bands must align to tile_h for the "
                         "pallas renderer")
    band_tile_rows = band_h // cfg.tile_h
    if overlap_chunks <= 0:
        overlap_chunks = 1
        if n_tile > 1:
            for c in (4, 3, 2):
                if band_tile_rows % c == 0:
                    overlap_chunks = c
                    break
    if band_tile_rows % overlap_chunks:
        raise ValueError(
            f"band of {band_tile_rows} tile rows not divisible by "
            f"overlap_chunks={overlap_chunks}")
    return band_h, band_tile_rows, overlap_chunks


def _plan(cfg: SplatConfig, mesh, combine: str, renderer: str,
          overlap_chunks: int, ssim_lambda: float,
          with_grad_mag: bool = True) -> _Plan:
    band_h, band_tile_rows, overlap_chunks = _validate_band_mesh(
        cfg, mesh, combine, renderer, overlap_chunks)
    n_splat = mesh.shape[SPLAT_AXIS]
    # Sharded splat axis -> exact associative monoid (threshold off).
    cfg_shard = cfg.replace(min_throughput=0.0) if n_splat > 1 else cfg
    return _Plan(
        cfg=cfg, cfg_shard=cfg_shard, layout=rd.resolve_binning(cfg_shard),
        n_splat=n_splat,
        monoid=(_ordered_monoid_fold if combine == "fold"
                else _ordered_monoid_scan),
        band_h=band_h, band_tile_rows=band_tile_rows,
        overlap_chunks=overlap_chunks, ssim_lambda=ssim_lambda,
        n_real_px=cfg.height * cfg.width * 3, with_grad_mag=with_grad_mag)


def _ssim_cot_fn(comm, plan: _Plan, ref_bands: dict):
    """The band cotangent of the mixed L2 + SSIM objective: SSIM windows
    cross band boundaries, so the full image is gathered over the tile
    axis, the loss head differentiated on it (replicated on every band)
    and this band of the cotangent sliced back."""
    cfg = plan.cfg
    ref_full = {c: torch.cat(g, dim=0) for c, g in
                comm.all_gather(TILE_AXIS, ref_bands).items()}

    def cot_fn(fins: dict) -> dict:
        full = comm.all_gather(TILE_AXIS, fins)
        out = {}
        for c, bands in full.items():
            leaf = torch.cat(bands, dim=0).detach().requires_grad_()
            with conv_flags():
                loss = mixed_loss(leaf[: cfg.height, : cfg.width],
                                  ref_full[c][: cfg.height, : cfg.width],
                                  plan.ssim_lambda)
                (g,) = torch.autograd.grad(loss, [leaf])
            y0 = c[_AXIS_INDEX[TILE_AXIS]] * plan.band_h
            out[c] = g[y0: y0 + plan.band_h]
        return out

    return cot_fn


class _CacheFns(NamedTuple):
    """The lazy band cache of the resident and flat layouts: a list of the
    margined band binning's tensors, then the six parameter tensors it was
    built from (train/loop.py's cache format)."""

    make: object     # (params, r0) -> cache list
    binning: object  # (cache, params) -> kernel-ready binning
    n_bin: int       # binning tensors before the snapshot


def _band_cache_fns(plan: _Plan) -> Optional[_CacheFns]:
    """gs2d_tpu's _band_cache_fns: the band's binning with cfg.rebin_margin
    px of slack and the snapshot it was built from; ``binning`` pregathers
    the flat rows from the live params (the resident table is rebuilt by
    the band step). None for the layouts without a cache."""
    cfg = plan.cfg_shard
    if plan.layout == "flat":
        def make(params, r0):
            b = _bin_band(params, plan, r0, cfg.rebin_margin, ids_only=True)
            return [b.ids, b.start, b.count, b.n_dropped] \
                + [getattr(params, f) for f in FIELDS]

        def binning(cache, params):
            return tlf.FlatBinning(
                ids=cache[0], rows=tlf.pregather_rows(cache[0], params, cfg),
                start=cache[1], count=cache[2], n_dropped=cache[3])

        return _CacheFns(make, binning, 4)
    if plan.layout == "resident":
        def make(params, r0):
            b = _bin_band(params, plan, r0, cfg.rebin_margin, ids_only=True)
            return [b.ids, b.count, b.n_dropped] \
                + [getattr(params, f) for f in FIELDS]

        def binning(cache, params):
            return tl.TileBinning(ids=cache[0], count=cache[1],
                                  n_dropped=cache[2])

        return _CacheFns(make, binning, 3)
    return None


def _image_step(comm, plan: _Plan, items: dict, lazy: Optional[_CacheFns],
                rebin):
    """One step of one image on every coordinate of ``items`` {coord:
    (params, opt, ref_band, cache)}: the lazy tripwire and rebin (``rebin(
    coord, pred)`` refreshes the coordinate's cache list from its params
    where pred holds; local to the coordinate, no collective), the band
    step, Adam, the tile-summed MSE over real pixels and the densify
    signal. Returns {coord: (params, opt, mse, n_dropped, gmag,
    rebinned)}."""
    cfg = plan.cfg
    prebuilt, rebinned = None, {}
    if lazy is not None:
        prebuilt = {}
        for c, (params, _, _, cache) in items.items():
            snap = GaussianParams(**dict(zip(FIELDS, cache[lazy.n_bin:])))
            covered = tl.pairs_covered_by(
                params, snap, plan.cfg_shard, cfg.rebin_margin) \
                & (cache[lazy.n_bin - 1] == 0)
            rebin(c, ~covered)
            prebuilt[c] = lazy.binning(cache, params)
            rebinned[c] = (~covered).to(torch.int32)
    bands = {c: (v[0], v[2]) for c, v in items.items()}
    cot_fn = (_ssim_cot_fn(comm, plan, {c: v[2] for c, v in items.items()})
              if plan.ssim_lambda else None)
    out = _pallas_band_step(comm, bands, plan, cot_fn, prebuilt)
    sq = {}
    res = {}
    for c, (fin, grads, n_drop) in out.items():
        params, opt, ref_band, _ = items[c]
        gC = fin - ref_band  # zero on padding by construction
        sq[c] = torch.sum(gC * gC)
        p_new, o_new = adam_update(params, grads, opt, cfg)
        res[c] = (p_new, o_new, n_drop,
                  grad_mag(grads.pos) if plan.with_grad_mag else 0,
                  rebinned.get(c, 0))
    band_sq = comm.all_reduce(TILE_AXIS, sq)
    return {c: (p, o, band_sq[c] * (255.0 * 255.0) / float(plan.n_real_px),
                nd, gm, rb) for c, (p, o, nd, gm, rb) in res.items()}


class _Local(NamedTuple):
    """A coordinate's step values before any reduction over the mesh:
    ``mse`` and ``psnr`` (B_local,), ``bad`` the count of its non-finite
    parameters (float32, as gs2d_tpu counts), ``drop`` its images' dropped
    pairs (int32), ``reb`` 1 where one of its images rebinned (int32; 0
    without a lazy cache) and ``gmag`` the (B_local, N_local) densify
    signal (0 without it). A block stacks each field (n, ...)."""

    mse: torch.Tensor
    psnr: torch.Tensor
    bad: torch.Tensor
    drop: torch.Tensor
    reb: torch.Tensor
    gmag: torch.Tensor


def _stack(xs: list) -> torch.Tensor:
    """torch.stack, as a view for one tensor."""
    return xs[0][None] if len(xs) == 1 else torch.stack(xs)


def _local_step(comm, plan: _Plan, states: dict, refs: dict,
                lazy: Optional[_CacheFns] = None, caches=None, rebin=None):
    """One step of every image of every coordinate: {coord: batched
    TrainState} and {coord: (B_local, band_h, Wp, 3) target bands} ->
    ({coord: TrainState}, {coord: _Local}). The collectives of the band
    step run here; the aux's reductions over the mesh do not
    (``_reduce_aux``). With ``lazy``, ``caches[c][b]`` is the cache list of
    coordinate c's image b and ``rebin(b, c, pred)`` refreshes it."""
    coords = list(states)
    b_local = refs[coords[0]].shape[0]
    per_image = []
    for b in range(b_local):
        items = {}
        for c in coords:
            st = state_index(states[c], b)
            items[c] = (st.params, st.opt, refs[c][b],
                        None if caches is None else caches[c][b])
        per_image.append(_image_step(
            comm, plan, items, lazy,
            None if rebin is None else functools.partial(rebin, b)))
    new_states, local = {}, {}
    for c in coords:
        outs = [r[c] for r in per_image]
        new = [TrainState(params=p, opt=o) for p, o, *_ in outs]
        # One image: its fresh leaves as (1, ...) views, no copy.
        new_states[c] = state_from_leaves(
            [t[None] for t in state_leaves(new[0])]) if len(new) == 1 \
            else stack_states(new)
        mse = _stack([o[2] for o in outs])
        local[c] = _Local(
            mse=mse, psnr=psnr_from_mse(mse),
            bad=sum((~torch.isfinite(getattr(new_states[c].params, f))).sum()
                    for f in FIELDS).to(torch.float32),
            drop=sum(o[3] for o in outs).to(torch.int32).reshape(()),
            reb=_stack([o[5] for o in outs]).max() if lazy is not None
            else 0,
            gmag=_stack([o[4] for o in outs]) if plan.with_grad_mag else 0)
    return new_states, local


def _reduce_aux(comm, local: dict, lazy) -> dict:
    """{coord: StepAux} of {coord: _Local} of one step (0-d counts) or of a
    block ((n,) vectors), with gs2d_tpu's reductions over the mesh: the
    non-finite count summed over the splat and tile axes (``all_finite``
    broadcast to the images), the dropped pairs summed over every axis,
    ``rebinned`` the max over every axis. Integer sums, a comparison and a
    max: a block's reductions give each step's values."""
    bad = _reduce_axes(comm, (SPLAT_AXIS, TILE_AXIS),
                       {c: v.bad for c, v in local.items()})
    drop = _reduce_axes(comm, (SPLAT_AXIS, TILE_AXIS, DATA_AXIS),
                        {c: v.drop for c, v in local.items()})
    reb = {c: v.reb for c, v in local.items()}
    if lazy is not None:
        reb = _reduce_axes(comm, (SPLAT_AXIS, TILE_AXIS, DATA_AXIS), reb,
                           op="max")
    return {c: StepAux(
        mse=v.mse, psnr=v.psnr,
        all_finite=(bad[c] == 0.0)[..., None].expand(v.mse.shape),
        n_dropped=drop[c], pos_grad_mag=v.gmag, rebinned=reb[c])
        for c, v in local.items()}


def _mesh_step(comm, plan: _Plan, states: dict, refs: dict):
    """One step of every image of every coordinate, eager binning, with
    the aux of gs2d_tpu's sharded step: mse and psnr (B_local,), all_finite
    over the splat and tile axes broadcast to (B_local,), n_dropped summed
    over the mesh, pos_grad_mag (B_local, N_local), rebinned 0."""
    new_states, local = _local_step(comm, plan, states, refs)
    return new_states, _reduce_aux(comm, local, None)


# ---------------------------------------------------------------------------
# State and targets per coordinate.
# ---------------------------------------------------------------------------

def params_pspec() -> GaussianParams:
    """How a batched (B, N, ...) GaussianParams is split (gs2d_tpu's
    PartitionSpecs): a mesh axis or None for each dimension, images over
    the data axis, splats over the splat axis."""
    return GaussianParams(
        pos=(DATA_AXIS, SPLAT_AXIS, None), sx=(DATA_AXIS, SPLAT_AXIS),
        sy=(DATA_AXIS, SPLAT_AXIS), rot=(DATA_AXIS, SPLAT_AXIS),
        color=(DATA_AXIS, SPLAT_AXIS, None), opacity=(DATA_AXIS, SPLAT_AXIS))


def state_pspec() -> TrainState:
    """The batched TrainState's splits: params_pspec for the parameters
    and Adam's moments, the data axis for the (B,) bias powers and step
    counts."""
    pp = params_pspec()
    return TrainState(params=pp, opt=AdamState(
        m=pp, v=pp, beta1t=(DATA_AXIS,), beta2t=(DATA_AXIS,),
        step=(DATA_AXIS,)))


def ref_pspec() -> tuple:
    """The padded (B, Hp, Wp, 3) targets' split: images over the data axis,
    rows over the tile axis (each coordinate's band)."""
    return (DATA_AXIS, TILE_AXIS, None, None)


def shard_state(state: TrainState, mesh) -> dict:
    """{coord: the coordinate's batched TrainState} of the whole batched
    state every process holds (its images and its splat slice)."""
    return {c: state_from_leaves(v) for c, v in put_global(
        state_leaves(state), state_leaves(state_pspec()), mesh).items()}


def gather_state(states: dict, mesh) -> TrainState:
    """The whole batched state from every coordinate's (on every
    process)."""
    return state_from_leaves(fetch_replicated(
        {c: state_leaves(s) for c, s in states.items()},
        state_leaves(state_pspec()), mesh))


def shard_refs(refs: torch.Tensor, mesh) -> dict:
    """{coord: (B_local, band_h, Wp, 3)}: the coordinate's images and tile
    band of the padded (B, Hp, Wp, 3) targets."""
    return {c: v[0] for c, v in put_global([refs], [ref_pspec()],
                                           mesh).items()}


def _shardings(mesh) -> dict:
    return {"state": functools.partial(shard_state, mesh=mesh),
            "ref": functools.partial(shard_refs, mesh=mesh)}


# ---------------------------------------------------------------------------
# Step builders.
# ---------------------------------------------------------------------------

def make_sharded_train_step(cfg: SplatConfig, mesh, combine: str = "fold",
                            renderer: str = "pallas",
                            overlap_chunks: int = 0,
                            ssim_lambda: float = 0.0,
                            with_grad_mag: bool = True):
    """The sharded train step (gs2d_tpu's make_sharded_train_step, its
    pallas renderer): each coordinate bins and renders its band of its
    splat slice; with one splat shard the fused L2 kernel runs each
    sub-band, with more the forward, the ordered combine ("fold" or
    "scan") and the carry-fed backward; the backward is cut into
    ``overlap_chunks`` sub-bands (0 = auto: the largest divisor of the band
    up to 4 when the tile axis is sharded, else 1), each all-reduced over
    the tile axis as it ends. ``ssim_lambda`` > 0 optimizes the (1-lam) *
    L2 + lam * (1-SSIM) mix on the full image gathered over the tile axis;
    the reported MSE stays the L2 metric. Binning is eager every step. The
    aux's ``pos_grad_mag`` is the (B_local, N_local) densify signal, as in
    gs2d_tpu, unless ``with_grad_mag`` is False (then 0).
    Returns (step, shardings): ``step(states, refs) -> (states, auxes)``
    over {coord: batched TrainState} and {coord: target band}, and
    ``shardings["state"]`` / ``["ref"]`` that cut the whole batched state
    and the padded (B, Hp, Wp, 3) targets into them."""
    plan = _plan(cfg, mesh, combine, renderer, overlap_chunks, ssim_lambda,
                 with_grad_mag)

    def step(states: dict, refs: dict):
        return _mesh_step(mesh.comm, plan, states, refs)

    return step, _shardings(mesh)


_N_LEAVES = len(state_leaves(state_pspec()))


def _block_step(comm, plan: _Plan, lazy: Optional[_CacheFns], coords: tuple,
                b_local: int, leaves, ref, caches, rebin):
    """The step of every coordinate this process holds, on the leaves of
    their batched states in ``coords`` order and their stacked target bands
    ``ref`` (n_coords, B_local, band_h, Wp, 3), in graphs.StepGraph's form:
    cache ``i * b_local + b`` is coordinate i's image b. The aux is each
    ``_Local`` field stacked over the coordinates (constants stay
    constants)."""
    k = _N_LEAVES
    states = {c: state_from_leaves(leaves[i * k: (i + 1) * k])
              for i, c in enumerate(coords)}
    refs = {c: ref[i] for i, c in enumerate(coords)}
    cache_of = band_rebin = None
    if lazy is not None:
        cache_of = {c: caches[i * b_local: (i + 1) * b_local]
                    for i, c in enumerate(coords)}

        def band_rebin(b, c, pred):
            rebin(coords.index(c) * b_local + b, pred)

    new, local = _local_step(comm, plan, states, refs, lazy, cache_of,
                             band_rebin)
    # A leaf the step leaves as it was (the opacity's moments without
    # optimize_opacity) comes back as a view of its input, maybe with other
    # strides on its axis of one image: return the input itself, which
    # graphs.StepGraph's copy into its statics skips.
    out = [t if t.data_ptr() != x.data_ptr() or t.shape != x.shape else x
           for t, x in zip((t for c in coords
                            for t in state_leaves(new[c])), leaves)]
    field = lambda f: [getattr(local[c], f) for c in coords]
    return out, _Local(
        *(_stack(field(f)) if torch.is_tensor(field(f)[0]) else field(f)[0]
          for f in _Local._fields))


def _band_cache(lazy: _CacheFns, r0: int, first: int, b: int, leaves):
    """The lazy cache of image ``b`` of the coordinate whose state's leaves
    start at ``leaves[first]`` and whose band starts at tile row ``r0``."""
    state = state_from_leaves(leaves[first: first + _N_LEAVES])
    return lazy.make(state_index(state, b).params, r0)


def _require_nccl_capture(mesh) -> None:
    """A captured step that holds NCCL collectives (a process mesh of
    several cards) needs NCCL 2.9.6 or later, the first NCCL that captures
    collectives in a CUDA graph (PyTorch's CUDA-graph notes)."""
    if mesh.device_mesh is None or mesh.device.type != "cuda" \
            or mesh.size == 1:
        return
    version = tuple(torch.cuda.nccl.version()[:3])
    if version < (2, 9, 6):
        raise RuntimeError(
            f"NCCL {'.'.join(map(str, version))} cannot capture collectives "
            "in a CUDA graph (2.9.6 or later needed) for the scanned mesh "
            "step")


class _Blocks:
    """Blocks of sharded steps on any mesh (gs2d_tpu's shard_map(lax.scan(
    step))): ``fit_k(states, refs, n_iters, grad_mag_sum=None)``.

    Each process runs one step body over every coordinate it holds
    (``_block_step``) through a ``graphs.BlockRunner``. On the card it is
    one captured step, replayed ``n_iters`` times with no host work in
    between: on a process mesh the rank's band step with its NCCL
    collectives in the graph (the ordered combine, the tile axis's gradient
    and band-MSE all-reduces, the SSIM bands' gathers), on a virtual mesh
    every coordinate's step, whose collectives are tensor operations. On
    the CPU the same body runs in a Python loop. Each (coordinate, image)
    carries its band's lazy cache through the block, binned afresh at its
    start; its tripwire and rebin are local (a conditional node each on the
    card). The reductions of the aux over the mesh run once, at the block's
    end, on its (n_iters,) vectors (``_reduce_aux``). Every rank must call
    with the same ``n_iters``."""

    mode = ("one captured step a process, replayed on the card (the same "
            "step in a Python loop on the CPU)")

    def __init__(self, mesh, plan: _Plan, lazy: Optional[_CacheFns]):
        self.mesh, self.plan, self.lazy = mesh, plan, lazy
        self.runner, self.b_local = None, 0

    @property
    def graph(self):
        return None if self.runner is None else self.runner.graph

    @property
    def captures(self) -> int:
        return 0 if self.runner is None else self.runner.captures

    def _runner(self, b_local: int):
        coords, plan, lazy = tuple(self.mesh.coords), self.plan, self.lazy
        makes = [] if lazy is None else [
            functools.partial(_band_cache, lazy, _band_r0(plan, c),
                              i * _N_LEAVES, b)
            for i, c in enumerate(coords) for b in range(b_local)]
        return graphs.BlockRunner(
            functools.partial(_block_step, self.mesh.comm, plan, lazy,
                              coords, b_local),
            makes, ("mse", "psnr", "bad", "drop")
            + (("reb",) if lazy is not None else ()),
            "gmag" if plan.with_grad_mag else None)

    def __call__(self, states: dict, refs: dict, n_iters: int,
                 grad_mag_sum: Optional[dict] = None):
        coords = self.mesh.coords
        b_local = refs[coords[0]].shape[0]
        if self.runner is None or self.b_local != b_local:
            self.runner, self.b_local = self._runner(b_local), b_local
        total = None if grad_mag_sum is None \
            else _stack([grad_mag_sum[c] for c in coords])
        new, aux, total = self.runner(
            [t for c in coords for t in state_leaves(states[c])],
            _stack([refs[c] for c in coords]), n_iters, total)
        if self.lazy is None:
            aux["reb"] = torch.zeros((n_iters, len(coords)),
                                     dtype=torch.int32,
                                     device=aux["mse"].device)
        k = _N_LEAVES
        local = {c: _Local(**{f: aux[f][:, i] for f in aux},
                           gmag=0 if total is None else total[i])
                 for i, c in enumerate(coords)}
        return ({c: state_from_leaves(new[i * k: (i + 1) * k])
                 for i, c in enumerate(coords)},
                _reduce_aux(self.mesh.comm, local, self.lazy))


def make_fit_scan_sharded(cfg: SplatConfig, mesh, *, combine: str = "fold",
                          renderer: str = "pallas", overlap_chunks: int = 0,
                          ssim_lambda: float = 0.0,
                          with_grad_mag: bool = False):
    """Blocks of sharded steps (gs2d_tpu's make_fit_scan_sharded): ``fit_k(
    states, refs, n_iters, grad_mag_sum=None) -> (states, auxes)``, each
    coordinate's aux stacked (n_iters, ...), on every mesh through one
    class (``_Blocks``: one captured step a process on the card, its
    collectives in the graph). ``cfg.rebin_margin`` > 0 rebins lazily under
    the mesh for the resident and flat layouts: each coordinate carries its
    band's margined binning through the block, runs the exact tripwire
    ``tiles.pairs_covered_by`` on its own splat shard every step and rebins
    only its own band; ``rebinned`` is the max over the mesh. With
    ``with_grad_mag`` the aux's ``pos_grad_mag`` is the (B_local, N_local)
    sum of the block's densify signals, from zero or continuing
    ``grad_mag_sum`` ({coord: (B_local, N_local)}). Raises on a process
    mesh of several cards whose NCCL cannot capture collectives.
    Returns (fit_k, shardings) as make_sharded_train_step."""
    plan = _plan(cfg, mesh, combine, renderer, overlap_chunks, ssim_lambda,
                 with_grad_mag)
    _require_nccl_capture(mesh)
    lazy = _band_cache_fns(plan) if cfg.rebin_margin > 0 else None
    return _Blocks(mesh, plan, lazy), _shardings(mesh)


# ---------------------------------------------------------------------------
# The host loop.
# ---------------------------------------------------------------------------

def prepare_config(cfg: SplatConfig, mesh, params0: GaussianParams
                   ) -> SplatConfig:
    """The statics fit_sharded fits with (gs2d_tpu's fit_sharded, before
    its step): the tile grid rounded to whole tile rows a band, then from
    image 0's population ``params0`` the auto rebin margin, the flat
    capacity a band (``tune_flat_config(n_bands=tile axis)``) or the
    per-tile capacity (``tune_tile_capacity``), where unset. Each shard
    bins a slice of the splats, so the whole population's measurement is an
    upper bound."""
    n_tile = mesh.shape[TILE_AXIS]
    if cfg.n_tiles_y % n_tile:
        # Extra rows are pure padding; results are identical.
        cfg = cfg.replace(tile_rows_multiple=n_tile)
    if cfg.rebin_margin < 0:
        cfg = tl.tune_rebin_margin(params0, cfg)
    if rf.use_flat(cfg):
        if cfg.flat_capacity is None or cfg.flat_max_chunks is None:
            cfg = rf.tune_flat_config(params0, cfg, n_bands=n_tile)
    elif cfg.max_splats_per_tile is None:
        cfg = tl.tune_tile_capacity(params0, cfg)
    return cfg


def fit_sharded(
    refs,
    cfg: SplatConfig,
    mesh,
    iterations: int,
    state: Optional[TrainState] = None,
    log_every: int = 0,
    log_fn=print,
    combine: str = "fold",
    renderer: str = "pallas",
    overlap_chunks: int = 0,
    densify_every: int = 0,
    densify_cfg=None,
    ssim_lambda: float = 0.0,
    scan_chunk: int = 0,
    checkpoint_every: int = 0,
    checkpoint_fn=None,
    iter_offset: int = 0,
):
    """Fit a batch of targets over the mesh (gs2d_tpu's fit_sharded).

    ``refs`` are B equal-sized (H, W, 3) targets that every process holds,
    B divisible by the data axis; ``state`` the whole batched state
    (``init_batched_state`` when None), which every process holds too.
    ``prepare_config`` sizes the statics first. ``densify_every`` runs
    gs2d_tpu's per-image density control at its cadence on the whole
    population: the state and the summed |dL/d pos| are gathered over the
    splat axis, ``densify_and_prune_batched`` runs with the same seed on
    every rank, and each keeps its slice. ``scan_chunk`` > 1 runs blocks of
    that many steps (``make_fit_scan_sharded``; lazy rebinning under
    ``cfg.rebin_margin``), clipped to densify boundaries; logging is then
    per block. ``checkpoint_fn(state, done)`` gets the whole batched state
    every ``checkpoint_every`` completed iterations (block-granular when
    scanned), on every process. Non-finite parameters raise
    ``FloatingPointError`` (the reference's abort, main.cpp:752-785) where
    the fit logs, and at every block when scanned. ``iter_offset`` shifts
    the logged iteration numbers. Returns (the whole batched state,
    history): one record a logged step with the images' MSEs and PSNRs,
    the pairs dropped over the mesh, ``rebinned`` when scanned, and the
    seconds since the start."""
    device = mesh.device
    if state is None:
        state = init_batched_state(cfg, len(refs), device)
    cfg = prepare_config(cfg, mesh, state_index(state, 0).params)
    refs = pad_ref_batch(refs, cfg, device)
    batch = refs.shape[0]
    if batch % mesh.shape[DATA_AXIS]:
        raise ValueError(f"batch of {batch} images does not divide over "
                         f"data axis {mesh.shape[DATA_AXIS]}")
    densify_fn = None
    if densify_every:
        from gs2d_tpu_torch.train.densify import (DensifyConfig,
                                                  densify_and_prune_batched)

        densify_fn = functools.partial(densify_and_prune_batched, cfg=cfg,
                                       dcfg=densify_cfg or DensifyConfig())
    scanned = bool(scan_chunk and scan_chunk > 1)
    if scanned:
        fit_k, sh = make_fit_scan_sharded(
            cfg, mesh, combine=combine, renderer=renderer,
            overlap_chunks=overlap_chunks, ssim_lambda=ssim_lambda,
            with_grad_mag=bool(densify_every))
        if log_fn:
            log_fn(f"scanned blocks on {mesh}: {fit_k.mode}")
    else:
        step, sh = make_sharded_train_step(
            cfg, mesh, combine=combine, renderer=renderer,
            overlap_chunks=overlap_chunks, ssim_lambda=ssim_lambda,
            with_grad_mag=bool(densify_every))
    states = sh["state"](state)
    ref_bands = sh["ref"](refs)
    comm = mesh.comm
    history = []
    blog = BlockLog(history, iterations, log_every, log_fn,
                    time.perf_counter(), iter_offset)
    accum = None
    done = 0

    # The state's splits over the splat axis alone: densify gathers each
    # coordinate's images' whole populations, and keeps its slice after.
    over_splats = [tuple(a if a == SPLAT_AXIS else None for a in spec)
                   for spec in state_leaves(state_pspec())]

    def densify(states, accum, at):
        """gs2d_tpu's densify on the whole population of each image."""
        full = gather_leaves({c: state_leaves(s) for c, s in states.items()},
                             over_splats, mesh)
        acc = gather_leaves({c: [a] for c, a in accum.items()},
                            [(None, SPLAT_AXIS)], mesh)
        out = {}
        for c, leaves in full.items():
            new = densify_fn(state_from_leaves(leaves), acc[c][0], seed=at)
            out[c] = state_from_leaves(
                [x[shard_index(mesh, c, spec, x.shape)]
                 for x, spec in zip(state_leaves(new), over_splats)])
        return out

    while done < iterations:
        n = 1
        if scanned:
            n = min(scan_chunk, iterations - done)
            if densify_every:
                n = min(n, densify_every - done % densify_every)
            # The signal's sum continues from block to block, in the
            # order of single steps.
            states, auxes = fit_k(states, ref_bands, n, accum)
        else:
            states, auxes = step(states, ref_bands)
        if densify_fn is not None:
            g = {c: x.pos_grad_mag for c, x in auxes.items()}
            accum = g if accum is None or scanned \
                else {c: accum[c] + g[c] for c in g}
            end = done + n
            if end % densify_every == 0 and end < iterations:
                states = densify(states, accum, end)
                accum = None
        logged = blog.logged(done, n)
        # Read back at log points (each block when scanned), as gs2d_tpu;
        # the images' MSEs and PSNRs of the logged steps gathered over the
        # data axis.
        if scanned or logged:
            a = auxes[mesh.coords[0]]
            rows = [it - done for it in logged]
            block = {"all_finite": torch.as_tensor(a.all_finite).reshape(
                         n, -1).all(dim=-1).cpu(),
                     "n_dropped": torch.as_tensor(a.n_dropped).reshape(
                         n, -1).sum(dim=-1).cpu(),
                     "rebinned": (torch.as_tensor(a.rebinned).cpu()
                                  if scanned else None)}
            for f in ("mse", "psnr"):
                block[f] = torch.tensor(_data_gather(comm, {
                    c: getattr(x, f).reshape(n, -1)[rows]
                    for c, x in auxes.items()}))
            blog.check_finite(block["all_finite"], done)
            blog.warn_drop(block["n_dropped"], done)
            if scanned:
                blog.warn_rebin(block["rebinned"], cfg.rebin_margin)
            blog.record(block, done, logged)
        done += n
        if checkpoint_every and checkpoint_fn \
                and done % checkpoint_every == 0:
            checkpoint_fn(gather_state(states, mesh), done)
    return gather_state(states, mesh), history


def _data_gather(comm, xs: dict) -> list:
    """The (rows, B) values of every image from the coordinates'
    (rows, B_local) ones ({coord: tensor}), as nested lists."""
    vals = comm.all_gather(DATA_AXIS, xs)
    return torch.cat(vals[next(iter(xs))], dim=-1).tolist()
