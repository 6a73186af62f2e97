"""The entry points of the program under test (``gs2d_tpu_torch``), gathered
in one place: the benchmark reaches the program only through these."""

from __future__ import annotations

import glob
import os
import re
import types


def load() -> types.SimpleNamespace:
    """The program's modules. Raises ImportError where the checkout holds
    no program."""
    from gs2d_tpu_torch.config import SplatConfig
    from gs2d_tpu_torch.ops import render as rd
    from gs2d_tpu_torch.ops import render_dense as rdn
    from gs2d_tpu_torch.ops import render_flat as rf
    from gs2d_tpu_torch.ops import render_resident as rr
    from gs2d_tpu_torch.ops import tiles as tl
    from gs2d_tpu_torch.params import GaussianParams
    from gs2d_tpu_torch.train import loop
    from gs2d_tpu_torch.train.adam import init_adam_state

    prog = types.SimpleNamespace(
        SplatConfig=SplatConfig, GaussianParams=GaussianParams, loop=loop,
        init_adam_state=init_adam_state, tiles=tl, render=rd,
        render_flat=rf, render_dense=rdn, render_resident=rr)
    prog.render_frame = lambda params, cfg: render_frame(prog, params, cfg)
    return prog


def render_frame(prog, params, cfg):
    """The forward render of a population on the layout ``cfg`` resolves
    to, as the CLI renders ``render_final.png``: (color (H, W, 3),
    n_dropped)."""
    layout = prog.render.resolve_binning(cfg)
    if layout == "flat":
        return prog.render_flat.render_flat(params, cfg)
    cap = prog.render._max_per_tile(cfg)
    if layout == "dense":
        return prog.render_dense.render_dense(params, cfg, cap)
    return prog.render_resident.render_resident(params, cfg, cap)


_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)")


def kernel_names(root: str = ".") -> frozenset:
    """The names of the program's own CUDA kernels (every ``__global__``
    function of ``gs2d_tpu_torch/csrc``)."""
    names = set()
    for path in glob.glob(os.path.join(root, "gs2d_tpu_torch", "csrc",
                                       "*.cu")):
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    return frozenset(names)


def tune(prog, config: dict, traffic: dict, params):
    """The binning statics as the CLI tunes them for one image: the tile
    height from the population, then the flat capacity (flat layout) or
    the per-tile capacity (the others), at the traffic's rebin margin."""
    cfg = prog.SplatConfig(
        width=config["width"], height=config["height"],
        n_splats=config["n_splats"], binning=config.get("binning", "auto"),
        optimize_opacity=config.get("optimize_opacity", False),
        rebin_margin=float(traffic.get("rebin_margin", 0.0)))
    cfg = prog.tiles.tune_tile_height(cfg, params)
    if prog.render.resolve_binning(cfg) == "flat":
        return prog.render_flat.tune_flat_config(params, cfg)
    return prog.tiles.tune_tile_capacity(params, cfg)
