"""The program's spans (``utils/profiling.py::span``) on the render path, on
the CPU: every range of the flat render is recorded as a host event of the
profiler's trace, nested as the layers are, never as a user annotation, not
at all while no profiler records, and without changing what is rendered."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gs2d_tpu_torch.config import SplatConfig
from gs2d_tpu_torch.ops import render as rd
from gs2d_tpu_torch.ops import render_dense as rdn
from gs2d_tpu_torch.ops import render_flat as rf
from gs2d_tpu_torch.ops import render_resident as rr
from gs2d_tpu_torch.params import init_params
from gs2d_tpu_torch.utils import profiling

STAGES = ("expand", "sort", "layout", "pregather")
FLAT_SPANS = {"gs2d.render", "gs2d.bin_flat", "gs2d.fwd_flat"} | {
    f"gs2d.bin_flat.{s}" for s in STAGES}


@pytest.fixture(scope="module")
def flat():
    """A tiny flat population and its tuned statics."""
    cfg = SplatConfig(width=96, height=64, n_splats=300, binning="flat")
    p = init_params(cfg, "cpu")
    return p, rf.tune_flat_config(p, cfg)


def traced(fn):
    """(fn's result, [(name, event)] of the trace's ``gs2d.`` events, in
    order of their start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name(), e) for e in prof.profiler.kineto_results.events()
              if e.name().startswith("gs2d.")]
    return out, sorted(events, key=lambda ne: ne[1].start_ns())


def interval(e):
    return e.start_ns(), e.start_ns() + e.duration_ns()


def test_flat_render_records_every_span_once(flat):
    p, cfg = flat
    _, events = traced(lambda: rf.render_flat(p, cfg))
    names = [n for n, _ in events]
    assert sorted(names) == sorted(FLAT_SPANS)


def test_spans_nest_as_the_layers(flat):
    """Children lie inside their parents; the binning's stages run in the
    order of the code, and kernel 10 after the binning."""
    p, cfg = flat
    _, events = traced(lambda: rf.render_flat(p, cfg))
    at = {n: interval(e) for n, e in events}
    inside = lambda a, b: at[b][0] <= at[a][0] and at[a][1] <= at[b][1]
    assert inside("gs2d.bin_flat", "gs2d.render")
    assert inside("gs2d.fwd_flat", "gs2d.render")
    for s in STAGES:
        assert inside(f"gs2d.bin_flat.{s}", "gs2d.bin_flat")
    for a, b in zip(STAGES, STAGES[1:]):
        assert at[f"gs2d.bin_flat.{a}"][1] <= at[f"gs2d.bin_flat.{b}"][0]
    assert at["gs2d.bin_flat"][1] <= at["gs2d.fwd_flat"][0]


def test_spans_are_host_events_not_annotations(flat):
    """A user annotation (record_function's) is also projected onto the
    device timeline; a span is a CPU FUNCTION event only."""
    from torch.autograd import DeviceType

    p, cfg = flat
    _, events = traced(lambda: rf.render_flat(p, cfg))
    assert events
    for _, e in events:
        assert e.device_type() == DeviceType.CPU
        assert not e.is_user_annotation()


def test_no_span_while_no_profiler_records(flat):
    p, cfg = flat
    assert profiling.span("gs2d.x") is profiling.span("gs2d.y")
    rf.render_flat(p, cfg)
    _, events = traced(lambda: torch.ones(8) + 1)
    assert events == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("gs2d.x") is not profiling.span("gs2d.x")
    assert profiling.span("gs2d.x") is profiling.span("gs2d.y")


def test_render_is_bit_identical_under_the_profiler(flat):
    p, cfg = flat
    img, n_dropped = rf.render_flat(p, cfg)
    (img_t, n_dropped_t), _ = traced(lambda: rf.render_flat(p, cfg))
    assert torch.equal(img, img_t)
    assert torch.equal(n_dropped, n_dropped_t)
    assert img.abs().sum() > 0


@pytest.mark.parametrize("layout", ["dense", "resident"])
def test_other_layouts_record_the_render_span(layout):
    cfg = SplatConfig(width=64, height=48, n_splats=40, binning=layout)
    p = init_params(cfg, "cpu")
    fn = rdn.render_dense if layout == "dense" else rr.render_resident
    k = rd._max_per_tile(cfg)
    plain = fn(p, cfg, k)
    got, events = traced(lambda: fn(p, cfg, k))
    assert [n for n, _ in events] == ["gs2d.render"]
    assert torch.equal(plain[0], got[0])
