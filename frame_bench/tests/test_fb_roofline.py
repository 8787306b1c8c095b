"""K1's frozen roofline count against numbers worked out by hand."""

from pathlib import Path

import pytest

from bench_core import spec

BENCH_DIR = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("shape, by, seconds", [
    # 1080p bounce 0: 2,073,600 lanes, k 16, 24 steps, 16,200 table words.
    # Bytes 2,073,600 x (34 + 196) + 64,800 = 476,992,800 -> 1.42386e-4 s;
    # operations 2,073,600 x 1,440 = 2.985984e9 -> 4.45669e-5 s: bytes bound.
    ({"lanes": 2073600, "table_words": 16200, "k": 16, "s_max": 24}, "bytes", 476992800 / 3.35e12),
    # 1,000 lanes, k 4, 200 steps, no table: bytes 1,000 x (34 + 52) = 86,000
    # -> 2.5672e-8 s; operations 1,000 x 12,000 = 1.2e7 -> 1.79104e-7 s.
    ({"lanes": 1000, "table_words": 0, "k": 4, "s_max": 200}, "operations", 1.2e7 / 67e12),
])
def test_schedule_pack_bound(shape, by, seconds):
    rf = spec.roofline(BENCH_DIR, "schedule_pack")
    assert rf.bound_s(shape) == pytest.approx(seconds, rel=1e-12)
    nbytes = shape["lanes"] * (34 + shape["k"] * 12 + 4) + shape["table_words"] * 4
    ops = shape["lanes"] * shape["s_max"] * 60
    assert (nbytes / 3.35e12 >= ops / 67e12) == (by == "bytes")


def test_launch_reads_the_call_shapes():
    import torch

    rf = spec.roofline(BENCH_DIR, "schedule_pack")
    args = (torch.zeros(7, 3), None, None, None, None, None, torch.zeros(5, 4, dtype=torch.int32))
    assert rf.launch(args, {"k": 16, "s_max": 24, "gh": 1}) == {
        "lanes": 7, "table_words": 20, "k": 16, "s_max": 24}


def test_roofline_metric_pairs_launches_and_ops():
    from bench_core.trace import DeviceOp, Trace

    rf = spec.roofline(BENCH_DIR, "schedule_pack")
    reader = spec.metric_reader(BENCH_DIR, "schedule_pack_roofline")
    shape = {"lanes": 2073600, "table_words": 16200, "k": 16, "s_max": 24}
    k1 = "void (anonymous namespace)::schedule_pack_kernel<false>(LaneArgs)"
    ops = [DeviceOp(k1, 0.0, 4e-4, ("Frame", "K1 Schedule Pack")),
           DeviceOp("elementwise_kernel", 1.0, 1e-5, ("Frame", "K1 Schedule Pack")),
           DeviceOp(k1, 2.0, 4e-4, ("Frame", "K1 Schedule Pack"))]
    tr = Trace(frames=1, window_s=3.0, busy_s=8.1e-4, ops=ops, spans=[],
               launches={"K1 Schedule Pack": [shape, shape]},
               roofline_of=lambda k: spec.roofline(BENCH_DIR, k))
    assert reader.read(tr) == pytest.approx(100.0 * rf.bound_s(shape) / 4e-4)
    tr.launches["K1 Schedule Pack"] = [shape]  # a launch unaccounted for: no reading
    assert reader.read(tr) is None
