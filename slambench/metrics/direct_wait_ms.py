"""Milliseconds a frame that the program's timer span
``direct/align/fetch`` takes: the one read of the alignment's valid
fraction, error and slab count, so mostly the host waiting for the
card's work of the frame.  Its total over every system of the window
over the window's frames, both without the part the profiler covered.
None where the program has no such span."""


def read(run):
    return run.per_frame_ms("direct/align/fetch")
