"""Aligned frames that made a new keyframe, per hundred: the program's
counter ``direct/keyframes`` (one observation a frame that was aligned,
1 where it made a keyframe) over its observations, without the part the
profiler covered.  An episode's first frame, its first keyframe, is not
aligned and not counted.  None where the program has no such counter."""


def read(run):
    got = run.section("direct/keyframes")
    if got is None:
        return None
    return 100.0 * got[0] / got[1]
