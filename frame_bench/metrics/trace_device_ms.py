"""Device ms a frame of pass 0: operations launched inside the
"Screen Space Path Tracing" span (``trace_frame_hiz``)."""

SPAN = "Screen Space Path Tracing"


def read(trace):
    ops = trace.ops_in(SPAN)
    if not ops:
        return None
    return sum(op.dur for op in ops) / trace.frames * 1e3
