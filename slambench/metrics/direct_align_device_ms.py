"""Milliseconds a frame that ``direct/align`` spans on the card's
timeline: the program's ``direct/align:device`` entry, a pair of CUDA
events a span, which it records only while a profiler records.  Its
total over the frames of the part the profiler covered.  None where the
program has no such span."""


def read(run):
    s = run.traced_sections.get("direct/align:device")
    if not s or not s["count"] or run.traced_frames <= 0:
        return None
    return s["total"] / run.traced_frames * 1e3
