"""The readers of the program's spans (``lib/spans.py``): device operations
matched in order to the enqueueing calls inside the render ranges, each
given to the innermost range open at its call, and the three metrics read
from that; nothing where the counts differ or the program has no spans."""

import json
import os
import types

from conftest import ROOT

import run
from lib import spans, trace

NEW = ("bin_flat_ms_per_frame", "render_host_ms_per_frame",
       "bin_flat_idle_share")

# One frame: the binning's expansion and sort, then kernel 10, with a
# launch outside the render (the closing marker's) and an aten operation.
DEVICE = [("mul_kernel", 100, 150), ("sort_kernel", 160, 200),
          ("fwd_flat_kernel", 300, 400)]
HOST = [
    ("gs2d.render", 50, 320),
    ("gs2d.bin_flat", 55, 250),
    ("gs2d.bin_flat.expand", 60, 120),
    ("cudaLaunchKernel", 70, 75),
    ("aten::mul", 65, 80),
    ("gs2d.bin_flat.sort", 120, 200),
    ("cudaLaunchKernel", 130, 135),
    ("gs2d.fwd_flat", 260, 300),
    ("cudaLaunchKernel", 270, 275),
    ("cudaLaunchKernel", 330, 335),
]


def span(device=DEVICE, host=HOST, units=1):
    s = trace.Span(list(device), list(host), 90, 450)
    s.units = units
    return s


def ctx(s):
    return types.SimpleNamespace(span=s)


def test_each_operation_goes_to_the_innermost_open_range():
    got = spans.attribution(span())
    assert [(name, op[0]) for name, op in got] == [
        ("gs2d.bin_flat.expand", "mul_kernel"),
        ("gs2d.bin_flat.sort", "sort_kernel"),
        ("gs2d.fwd_flat", "fwd_flat_kernel")]


def test_the_three_readers():
    s = span(units=2)
    assert run.reader("bin_flat_ms_per_frame")(ctx(s)) == (50 + 40) / 1e6 / 2
    assert run.reader("render_host_ms_per_frame")(ctx(s)) == 270 / 1e6 / 2
    # Idle: 90-100, 150-160, 200-300, 400-450; the binning's range
    # (55-250) overlaps 10 + 10 + 50 ns of it, of a 360 ns span.
    share = run.reader("bin_flat_idle_share")(ctx(s))
    assert abs(share - 100.0 * 70 / 360) < 1e-9


def test_nothing_where_the_counts_differ():
    missing = [h for h in HOST if h != ("cudaLaunchKernel", 130, 135)]
    extra = DEVICE + [("memset", 410, 420)]
    for s in (span(host=missing), span(device=extra)):
        assert spans.attribution(s) is None
        for name in NEW:
            assert run.reader(name)(ctx(s)) is None


def test_nothing_without_the_programs_spans():
    """A program without spans (an older checkout's) reads as nothing, with
    no error; so does a call that missed its markers."""
    bare = span(host=[h for h in HOST if not h[0].startswith("gs2d.")])
    for s in (bare, None):
        for name in NEW:
            assert run.reader(name)(ctx(s)) is None


def test_manifest_lists_the_readers_for_the_render_cell():
    man = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    by_name = {m["name"]: m for m in man["per_layer"]}
    for name in NEW:
        m = by_name[name]
        assert m["workloads"] == ["hd1m.render"]
        assert m["source"] == "device_trace"
        assert m["moves"] == "frames_per_s"
    assert [m["name"] for m in man["per_layer"][-3:]] == list(NEW)
