"""Device ms a frame of the BRDF evaluation: operations launched inside
the "Evaluate BRDF" spans (``evaluate_brdf``, bounce 0 and every bounce
of every sample: its two draws, the probe lookup and the lanes'
evaluation, kernel B1 where the port has it)."""

SPAN = "Evaluate BRDF"


def read(trace):
    ops = trace.ops_in(SPAN)
    if not ops:
        return None
    return sum(op.dur for op in ops) / trace.frames * 1e3
