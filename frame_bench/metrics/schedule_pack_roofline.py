"""Kernel K1's share of its roofline over the traced slice, in %: the
sum of each launch's least time (``roofline/schedule_pack.py``, on the
launch's own lanes and table) over the sum of the launches' device time.
The launches are the K1 device ops inside the "K1 Schedule Pack" spans,
paired in order with the shapes recorded at each call."""

SPAN = "K1 Schedule Pack"


def read(trace):
    rf = trace.roofline_of("schedule_pack")
    ops = [op for op in trace.ops_in(SPAN) if rf.KERNEL in op.name]
    shapes = trace.launches.get(SPAN, [])
    if not ops or len(ops) != len(shapes):
        return None
    return 100.0 * sum(rf.bound_s(s) for s in shapes) / sum(op.dur for op in ops)
