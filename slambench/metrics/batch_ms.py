"""Milliseconds a frame spends in the program's timer section
``slam/track_batch``: the slab gather, a K-frame body (its graph's
capture or replay) and the one fetch.  Its total over every system of
the window over the window's frames, both without the part the profiler
covered."""


def read(run):
    return run.per_frame_ms("slam/track_batch")
