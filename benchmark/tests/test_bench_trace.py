"""The trace reading: busy union, idle gaps by host operation, breakdown."""

from lib import trace


def test_span_busy_idle_and_breakdown():
    dev = [("k1", 100, 200), ("k2", 150, 300), ("k1", 400, 450)]
    host = [("aten::add", 0, 500), ("cudaStreamSynchronize", 320, 390)]
    span = trace.Span(dev, host, 50, 500)
    assert span.busy_intervals() == [[100, 300], [400, 450]]
    assert abs(span.busy_s - 250e-9) < 1e-15
    assert abs(span.window_s - 450e-9) < 1e-15
    idle = span.idle_by_host()
    assert abs(idle["cudaStreamSynchronize"] - 100e-9) < 1e-15
    assert abs(idle["aten::add"] - 100e-9) < 1e-15
    b = span.breakdown()
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) == 2
    ops = span.op_seconds()
    assert abs(ops["k1"] - 150e-9) < 1e-15 and abs(ops["k2"] - 150e-9) < 1e-15


def test_span_labels_python_where_no_host_op():
    span = trace.Span([("k", 10, 20)], [], 0, 40)
    assert set(span.idle_by_host()) == {"python"}
