"""Milliseconds a frame spends in the program's timer section
``slam/track_fused``: slab, projection, the gated matcher (B4), PnP
RANSAC and GN refine, one fetch.  Its total over every system of the
window over the window's frames, both without the part the profiler
covered."""


def read(run):
    return run.per_frame_ms("slam/track_fused")
