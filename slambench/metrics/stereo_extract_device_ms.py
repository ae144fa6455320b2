"""Milliseconds a frame that ``slam/stereo/extract`` (the right image's
upload and extraction: blur, B1, top-K, orientation, B2 on every pyramid
level) spans on the timeline of the stream it runs on: the program's
``slam/stereo/extract:device`` entry, a pair of CUDA events a span, which
it records only while a profiler records.  Its total over the frames of
the part the profiler covered.  None where the program has no such
span."""


def read(run):
    s = run.traced_sections.get("slam/stereo/extract:device")
    if not s or not s["count"] or run.traced_frames <= 0:
        return None
    return s["total"] / run.traced_frames * 1e3
