"""Milliseconds a frame spends in the program's timer section
``slam/stereo/match``: the rectified left-right match (octave-gated where
the configuration extracts a pyramid) and the depth quotient, as the host
sees them.  Its total over every system of the window over the window's
frames, both without the part the profiler covered.  None where the
program has no such section."""


def read(run):
    return run.per_frame_ms("slam/stereo/match")
