"""Milliseconds a frame spends in the program's timer section
``slam/extract``: extraction of the left image (B1, B2), blocked on the
card.  Its total over every system of the window over the window's
frames, both without the part the profiler covered."""


def read(run):
    return run.per_frame_ms("slam/extract")
