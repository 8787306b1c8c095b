"""The BRDF evaluation's span and reader: every cell installs the span
around ``evaluate_brdf``, which records each call of a frame (bounce 0
and every bounce of the 4 adaptive samples), and the reader sums the
device time inside it."""

from pathlib import Path

import pytest

from bench_core import spec
from bench_core.spans import FRAME
from bench_core.trace import DeviceOp, Trace

BENCH_DIR = Path(__file__).resolve().parent.parent
SPAN = "Evaluate BRDF"


@pytest.mark.parametrize("cell_name, calls", [
    # 4 samples x (bounce 0 + 2 bounces).
    ("classroom_spatial_temporal_1080p.still", 12),
    # 4 samples x (bounce 0 + 4 bounces), with the refraction lobe.
    ("boxscene_glass_spatial_temporal_1080p.still", 20),
])
def test_span_records_a_frames_brdf_calls(tmp_path, cell_name, calls):
    """The cell's spans, installed around one 32x32 frame of the port on
    the CPU, open one "Evaluate BRDF" range a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench_core.inputs import make_inputs
    from bench_core.sides import PROGRAM, Side
    from bench_core.spans import Spans

    cell = spec.load_cell(cell_name)
    assert SPAN in {s["label"] for s in spec.spans_for(cell)}
    inputs = make_inputs(cell.config, cell.traffic, 32, 32, cache_dir=tmp_path)
    side = Side(PROGRAM)
    r = side.make_renderer(cell.config, inputs, "cpu")
    gb, cam = side.gbuffers(inputs.poses[0], "cpu"), side.cam(inputs.poses[0], "cpu")
    spans = Spans([s for s in spec.spans_for(cell) if s["label"] == SPAN],
                  lambda k: spec.roofline(BENCH_DIR, k))
    spans.install()
    try:
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
            r.render_frame(gb, cam)
    finally:
        spans.remove()
    assert sum(e.name == SPAN for e in prof.events()) == calls


def test_brdf_reader_sums_the_span():
    """Two frames: the ops inside the "Evaluate BRDF" spans (a draw and
    B1, 0.25 + 0.5 s) count; the march's op and pass 0's own do not."""
    pass0 = (FRAME, "Screen Space Path Tracing")
    ops = [DeviceOp("x", 0.0, 1.0, pass0), DeviceOp("k1", 1.0, 1.0, pass0 + ("Hi-Z Ray March",)),
           DeviceOp("sampler_kernel", 2.0, 0.25, pass0 + (SPAN,)),
           DeviceOp("brdf_kernel", 3.0, 0.5, pass0 + (SPAN,))]
    reader = spec.metric_reader(BENCH_DIR, "brdf_device_ms")

    def trace(ops_):
        return Trace(frames=2, window_s=10.0, busy_s=3.0, ops=ops_, spans=[], launches={},
                     roofline_of=None, untraced_frame_s=5.0)

    assert reader.read(trace(ops)) == pytest.approx(375.0)
    assert reader.read(trace(ops[:2])) is None  # no span: no reading
