"""Slab points in bounds at the finest aligned level, per hundred valid
slab points: the program's counters ``direct/inbounds`` over
``direct/points`` (one observation each a frame that was aligned),
without the part the profiler covered.  None where the program has no
such counters."""


def read(run):
    inb = run.section("direct/inbounds")
    pts = run.section("direct/points")
    if inb is None or pts is None or not pts[0]:
        return None
    return 100.0 * inb[0] / pts[0]
