"""Milliseconds a local BA (window, problem, the Schur LM through B5 and
B6, write-back) spans on the card's timeline: the program's
``slam/local_ba:device`` entry, a pair of CUDA events a span, which it
records only while a profiler records.  Its total over its calls in the
part the profiler covered."""


def read(run):
    s = run.traced_sections.get("slam/local_ba:device")
    if not s or not s["count"]:
        return None
    return s["total"] / s["count"] * 1e3
