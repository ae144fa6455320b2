"""Milliseconds a frame spends in the program's timer span
``slam/track_fused/fetch``: the landmark statistics, the pose jump and
the one packed fetch, so mostly the host waiting for the card's work of
``track``.  Its total over every system of the window over the window's
frames, both without the part the profiler covered."""


def read(run):
    return run.per_frame_ms("slam/track_fused/fetch")
