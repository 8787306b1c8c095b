"""The traced slice: a torch.profiler (CUPTI) trace of some tens of
frames, reduced to device operations, spans and idle gaps.

Each device operation (kernel, copy, set) is tied to the host call that
launched it by the CUPTI correlation id, and belongs to every benchmark
span whose host interval holds that launch; its innermost span labels
it. The slice runs from the first frame's start to the last frame's
present. Busy is the union of the device intervals in the slice, so
overlapping operations count once.
"""

from __future__ import annotations

import dataclasses

from .spans import FRAME, PRESENT


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float  # seconds, the trace's clock
    dur: float  # seconds
    spans: tuple  # labels of the spans open at its launch, outermost first


@dataclasses.dataclass
class Span:
    label: str
    start: float
    end: float


@dataclasses.dataclass
class Trace:
    frames: int
    window_s: float
    busy_s: float
    ops: list  # DeviceOp in the slice
    spans: list  # Span
    launches: dict  # span label -> recorded shapes (spans.Spans.launches)
    roofline_of: object  # kernel name -> roofline module
    untraced_frame_s: float | None = None  # wall of an untraced frame of the run

    def ops_in(self, label: str) -> list:
        return [op for op in self.ops if label in op.spans]

    def device_s(self, label: str) -> float:
        return sum(op.dur for op in self.ops_in(label))

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0.0) + op.dur
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[label, s] for label, s in self.idle_gaps()[:top]]}

    def idle_gaps(self) -> list:
        """(label, seconds) of every gap between device activity inside
        the slice, longest first; the label is the innermost span open on
        the host when the device went idle ("host" where none was)."""
        lo = min(s.start for s in self.spans if s.label == FRAME)
        hi = max(s.end for s in self.spans if s.label == PRESENT)
        gaps, t = [], lo
        for a, b in merged(self.ops):
            if a > t:
                gaps.append((t, a - t))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi - t))
        stacks = open_spans(self.spans, [g[0] for g in gaps])
        out = [(st[-1] if st else "host", d) for (_, d), st in zip(gaps, stacks)]
        return sorted(out, key=lambda x: -x[1])


def merged(ops) -> list:
    """The union of the ops' intervals, as sorted disjoint (start, end)."""
    out = []
    for a, b in sorted((op.start, op.start + op.dur) for op in ops):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def open_spans(spans: list, times: list) -> list:
    """For each time, the labels of the spans that hold it, outermost
    first (spans nest: they are host ranges of one thread)."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    marks = sorted([(s.start, 1, i) for i, s in enumerate(spans)]
                   + [(s.end, 0, i) for i, s in enumerate(spans)])
    out = [()] * len(times)
    stack, j = [], 0
    for i in order:
        t = times[i]
        while j < len(marks) and marks[j][0] <= t:
            _, opening, k = marks[j]
            j += 1
            if opening:
                stack.append(k)
            elif k in stack:
                stack.remove(k)
        out[i] = tuple(spans[k].label for k in stack)
    return out


def reduce_profile(prof, labels: set, launches: dict, roofline_of,
                   untraced_frame_s: float | None = None) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` to a ``Trace``.
    ``labels``: the span labels (with ``FRAME`` and ``PRESENT``)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    spans, launch_t, device = [], {}, []
    for ev in events:
        name = ev.name()
        if ev.device_type() == cuda:
            # The profiler mirrors each host range on the device's timeline
            # as an annotation; only kernels, copies and sets are device work.
            if name not in labels and not name.startswith("ProfilerStep"):
                device.append(ev)
            continue
        start = ev.start_ns()
        if name in labels:
            spans.append(Span(name, start * 1e-9, (start + ev.duration_ns()) * 1e-9))
        elif name.startswith(("cuda", "cu")):
            # The runtime call that launched a device op shares its
            # CUPTI correlation id.
            launch_t[ev.correlation_id()] = start * 1e-9
    frames = [s for s in spans if s.label == FRAME]
    presents = [s for s in spans if s.label == PRESENT]
    if not frames or not presents:
        raise RuntimeError("the traced slice holds no frame")
    lo, hi = min(s.start for s in frames), max(s.end for s in presents)
    ops, times = [], []
    for ev in device:
        start = ev.start_ns() * 1e-9
        if start < lo or start > hi:
            continue
        ops.append(DeviceOp(ev.name(), start, ev.duration_ns() * 1e-9, ()))
        # An op whose launch is not in the trace is placed at its start.
        times.append(launch_t.get(ev.correlation_id(), start))
    for op, st in zip(ops, open_spans(spans, times)):
        op.spans = st
    busy = sum(min(b, hi) - max(a, lo) for a, b in merged(ops) if b > lo and a < hi)
    return Trace(frames=len(frames), window_s=hi - lo, busy_s=busy, ops=ops, spans=spans,
                 launches=launches, roofline_of=roofline_of,
                 untraced_frame_s=untraced_frame_s)

