"""Milliseconds a frame that the program's timer span ``direct/keyframe``
takes on the host: a new keyframe's top-K of the gradient image, the
lifting of its slab and the per-level reference samples.  Its total over
every system of the window over the window's frames, both without the
part the profiler covered.  None where the program has no such span."""


def read(run):
    return run.per_frame_ms("direct/keyframe")
