"""One run of one cell: set-up, warm-up, the timed window, the traced
slice and the comparison.

The window drives ``Renderer.render_frame`` one frame after another as
an application calls it, a closed loop with one caller: each frame ends
with ``torch.cuda.synchronize()``, because it is presented. ``frame_ms``
is the window's wall time over the frames completed in it; ``frame_ms_p95``
the 95th percentile of every frame's own time (call to presented end).
The clock stops only while the benchmark keeps a copy of a frame or of
the program's state for the comparison, between two frames.
"""

from __future__ import annotations

import random
import statistics
import time

from . import check, spec
from .inputs import CACHE_DIR, make_inputs
from .sides import PROGRAM, REFERENCE, Side
from .spans import FRAME, PRESENT, Spans
from .traffic import Traffic

COMPARED_TIMED = 2  # timed frames the reference replays after the warm-up
TRACE_FRAMES = 24  # frames in the traced slice, after the window


def percentile(values: list, q: int) -> float:
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def step_frame(seed: int, first: int) -> int:
    """The window frame the reference steps into from the program's
    state: drawn from the seed among the 64 frames from ``first`` (every
    cell's window holds more)."""
    return first + random.Random(seed).randrange(64)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, size: tuple | None = None, cache_dir=CACHE_DIR,
             hdr_64bit: bool | None = None, fault=None) -> dict:
    """Run the cell and return the result's fields (without ``device``).

    ``size`` (height, width) and ``cache_dir`` serve the CPU tests;
    ``hdr_64bit=False`` runs the program's 11-bit HDR path (the control);
    ``fault(renderer)`` breaks the timed path underneath (the tests)."""
    import torch

    config, traffic_spec = cell.config, cell.traffic
    traffic = Traffic(traffic_spec)
    h, w = size if size else (config["height"], config["width"])
    inputs = make_inputs(config, traffic_spec, h, w, cache_dir=cache_dir)
    program = Side(PROGRAM)
    gbs = [program.gbuffers(p, device) for p in inputs.poses]
    cams = [program.cam(p, device) for p in inputs.poses]
    r = program.make_renderer(config, inputs, device, hdr_64bit=hdr_64bit)
    if fault is not None:
        fault(r)
    frame_index = seed % program.config.FRAME_INDEX_MOD
    r.frame_index = frame_index
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)

    keys, start = [], []
    edits = 0
    n_warm = config["warmup_frames"]
    # The first n_warm + COMPARED_TIMED frames are compared from the
    # run's start; the stepped frame is drawn from the seed after them.
    j_step = step_frame(seed, n_warm + COMPARED_TIMED)
    step = traced = None

    def render(i):
        nonlocal edits
        key = traffic.scene_key(r, edits) if i else None
        edits += key is not None
        keys.append(key)
        p = traffic.pose(i)
        return r.render_frame(gbs[p], cams[p], scene_key=key)

    with torch.no_grad():
        for i in range(n_warm):  # the warm-up: tiles, history, every shape
            start.append(render(i).clone())
            sync()
        setup_s = time.perf_counter() - t_start

        times, paused, i = [], 0.0, n_warm
        t_win = time.perf_counter()
        while time.perf_counter() - t_win - paused < seconds or i <= j_step:
            if i == j_step:
                t_p = time.perf_counter()
                state = check.snapshot(r)
                paused += time.perf_counter() - t_p
            t0 = time.perf_counter()
            img = render(i)
            sync()
            times.append(time.perf_counter() - t0)
            t_p = time.perf_counter()
            if i < n_warm + COMPARED_TIMED:
                start.append(img.clone())
            elif i == j_step:
                step = {"index": i, "state": state, "image": img.clone()}
            sync()
            paused += time.perf_counter() - t_p
            i += 1
        window_s = time.perf_counter() - t_win - paused
        if trace:
            # After the window: neither the profiler nor a span touches a
            # timed frame (on the H100, frames after a CUPTI slice ran ~40%
            # slower than untraced ones).
            traced, spans = _traced_slice(cell, render, i, sync)
    frames = len(times)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if torch.device(device).type == "cuda" else 0)
    trace_out = _reduce(traced, spans, cell, window_s / frames) if trace else None
    del r, gbs, cams, img
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    record = {"frame_index": frame_index, "keys": keys, "start": start, "step": step}
    numbers = check.compare(Side(REFERENCE), config, inputs, traffic, device, record)
    correct, failed, checks = check.judge(numbers, cell.limits)
    out = {"correct": correct, "attempted": frames, "failed": failed,
           "memory_peak_bytes": int(memory_peak), "checks": checks}
    if trace:
        out.update(trace_out)
    else:
        out["metrics"] = _end_to_end(cell, frames, window_s, times, setup_s)
    return out


def _traced_slice(cell, render, i, sync):
    """Frames i, i + 1, ... after the window under the profiler: the
    first takes the profiler's start-up, the next TRACE_FRAMES are the
    slice, each a ``FRAME`` span and a ``PRESENT`` span, with the spans
    that the cell's metrics read installed. Returns (profile, spans)."""
    from torch.profiler import record_function

    spans = Spans(spec.spans_for(cell), lambda k: spec.roofline(cell.bench_dir, k))
    prof = _start_profiler()
    try:
        render(i)
        sync()
        spans.install()
        for j in range(i + 1, i + 1 + TRACE_FRAMES):
            with record_function(FRAME):
                render(j)
            with record_function(PRESENT):
                sync()
    finally:
        prof.stop()
        spans.remove()
    return prof, spans


def _start_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _end_to_end(cell, frames, window_s, times, setup_s) -> dict:
    values = {
        "frame_ms": window_s / frames * 1e3,
        "frame_ms_p95": percentile(times, 95) * 1e3,
        "setup_s": setup_s,
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}


def _reduce(prof, spans, cell, untraced_s) -> dict:
    """The per-layer metrics the cell lists, from the traced slice; a
    reader that finds nothing returns None and its metric is left out.
    ``untraced_s``: the wall of one untraced frame of the same run (its
    ``frame_ms``)."""
    from .trace import reduce_profile

    labels = {s["label"] for s in spans.files} | {FRAME, PRESENT}
    tr = reduce_profile(prof, labels, spans.launches,
                        lambda k: spec.roofline(cell.bench_dir, k), untraced_s)
    metrics = {}
    for m in cell.per_layer:
        v = spec.metric_reader(cell.bench_dir, m["name"]).read(tr)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return {"metrics": metrics, "busy_s": tr.busy_s, "window_s": tr.window_s,
            "breakdown": tr.breakdown()}
