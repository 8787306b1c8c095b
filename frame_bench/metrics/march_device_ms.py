"""Device ms a frame of the hiz march: operations launched inside the
"Hi-Z Ray March" spans (``ray_march_hiz``, every bounce and sample)."""

SPAN = "Hi-Z Ray March"


def read(trace):
    ops = trace.ops_in(SPAN)
    if not ops:
        return None
    return sum(op.dur for op in ops) / trace.frames * 1e3
