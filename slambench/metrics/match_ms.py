"""Milliseconds a frame spends in the program's timer span
``slam/track_fused/match``: projection of the slab under the predicted
pose, the gated matcher (B4) and the unprojection of the matched
keypoints, host time.  Its total over every system of the window over
the window's frames, both without the part the profiler covered."""


def read(run):
    return run.per_frame_ms("slam/track_fused/match")
