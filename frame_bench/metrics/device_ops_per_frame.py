"""Device operations (kernels, copies, sets) a frame over the traced
slice (layer: the frame's torch ops)."""


def read(trace):
    if not trace.ops or not trace.frames:
        return None
    return len(trace.ops) / trace.frames
