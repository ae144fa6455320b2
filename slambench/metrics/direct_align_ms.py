"""Milliseconds a frame that the program's timer span ``direct/align``
takes on the host: the coarse-to-fine Gauss-Newton alignment of the
keyframe slab (each level's gradients, depth resize and steps, queued
eagerly) and the one fetch.  Its total over every system of the window
over the window's frames, both without the part the profiler covered.
None where the program has no such span."""


def read(run):
    return run.per_frame_ms("direct/align")
