"""Milliseconds a frame spends in the program's timer span
``slam/track_fused/slab``: the last keyframe's id and the covisibility
slab (its union of point ids, two sorts, and the gathers), host time.
Its total over every system of the window over the window's frames,
both without the part the profiler covered."""


def read(run):
    return run.per_frame_ms("slam/track_fused/slab")
