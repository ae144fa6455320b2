"""Calls of the path that tracks a frame against its reference keyframe
with no pose prior (the motion model's gates failed), per hundred frames
of the window: the observations of the program's counter
``slam/track_ref/accepted`` (one a call), without the part the profiler
covered.  None where the program has no such counter."""


def read(run):
    got = run.section("slam/track_ref/accepted")
    if got is None:
        return None
    return 100.0 * got[1] / got[2]
