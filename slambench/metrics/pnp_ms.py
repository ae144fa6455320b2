"""Milliseconds a frame spends in the program's timer span
``slam/track_fused/pnp``: P3P RANSAC and its GN refine, host time.  Its
total over every system of the window over the window's frames, both
without the part the profiler covered."""


def read(run):
    return run.per_frame_ms("slam/track_fused/pnp")
