"""The trace reduction on hand-made events: span attribution, busy as a
union, idle gaps labelled by the span open on the host, the readers."""

from pathlib import Path

import pytest

from bench_core import spec
from bench_core.spans import FRAME, PRESENT
from bench_core.trace import DeviceOp, Span, Trace, merged, open_spans

BENCH_DIR = Path(__file__).resolve().parent.parent


def test_open_spans_innermost_last():
    spans = [Span(FRAME, 0.0, 10.0), Span("Screen Space Path Tracing", 1.0, 8.0),
             Span("Hi-Z Ray March", 2.0, 3.0), Span(PRESENT, 10.0, 11.0)]
    got = open_spans(spans, [0.5, 2.5, 4.0, 10.5, 12.0])
    assert got == [(FRAME,), (FRAME, "Screen Space Path Tracing", "Hi-Z Ray March"),
                   (FRAME, "Screen Space Path Tracing"), (PRESENT,), ()]


def test_busy_is_a_union_and_gaps_are_labelled():
    spans = [Span(FRAME, 0.0, 6.0), Span("Screen Space Path Tracing", 0.0, 5.0),
             Span(PRESENT, 6.0, 10.0)]
    ops = [DeviceOp("a", 0.0, 2.0, ()), DeviceOp("b", 1.0, 2.0, ()), DeviceOp("c", 7.0, 1.0, ())]
    assert merged(ops) == [(0.0, 3.0), (7.0, 8.0)]
    tr = Trace(frames=1, window_s=10.0, busy_s=4.0, ops=ops, spans=spans, launches={},
               roofline_of=None)
    assert tr.idle_gaps() == [("Screen Space Path Tracing", 4.0), (PRESENT, 2.0)]
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["a", 2.0] and len(bd["idle_gaps"]) == 2


@pytest.mark.parametrize("name, untraced_frame_s, expect", [
    ("device_idle_share", 5.0, 0.6),
    ("device_idle_share", None, None),
    ("device_ops_per_frame", 5.0, 1.5),
    ("trace_device_ms", 5.0, 1000.0),
    ("march_device_ms", 5.0, 500.0),
])
def test_readers(name, untraced_frame_s, expect):
    ops = [DeviceOp("x", 0.0, 1.0, (FRAME, "Screen Space Path Tracing")),
           DeviceOp("y", 1.0, 1.0, (FRAME, "Screen Space Path Tracing", "Hi-Z Ray March")),
           DeviceOp("z", 2.0, 2.0, (FRAME,))]
    tr = Trace(frames=2, window_s=10.0, busy_s=4.0, ops=ops, spans=[], launches={},
               roofline_of=None, untraced_frame_s=untraced_frame_s)
    got = spec.metric_reader(BENCH_DIR, name).read(tr)
    assert got == (None if expect is None else pytest.approx(expect))
