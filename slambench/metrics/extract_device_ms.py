"""Milliseconds a frame that ``slam/extract`` (blur, B1, top-K,
orientation, B2) spans on the card's timeline: the program's
``slam/extract:device`` entry, a pair of CUDA events a span, which it
records only while a profiler records.  Its total over the frames of the
part the profiler covered."""


def read(run):
    s = run.traced_sections.get("slam/extract:device")
    if not s or not s["count"] or run.traced_frames <= 0:
        return None
    return s["total"] / run.traced_frames * 1e3
