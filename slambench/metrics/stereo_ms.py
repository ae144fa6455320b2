"""Milliseconds a frame spends in the program's timer section
``slam/stereo``: the right image to the card, its extraction (B1, B2),
the rectified left-right match and the depth quotient, as the host sees
them.  Its total over every system of the window over the window's
frames, both without the part the profiler covered.  None where the
program runs no stereo."""


def read(run):
    return run.per_frame_ms("slam/stereo")
