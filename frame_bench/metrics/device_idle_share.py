"""1 - device busy a frame / wall of an untraced frame (layer: the device).

Busy a frame comes from the traced slice (the union of its device
intervals over its frames); the wall from the same run's frames after
the slice, which neither the profiler nor a span slows. The slice's own
wall holds the profiler's host cost, so ``busy_s / window_s`` of the
result line reads a larger idle share than this."""


def read(trace):
    if not trace.ops or not trace.frames or not trace.untraced_frame_s:
        return None
    return 1.0 - trace.busy_s / trace.frames / trace.untraced_frame_s
