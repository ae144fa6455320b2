"""Left keypoints given a stereo depth (matched on the right image under
the rectified gate), per hundred valid left keypoints: the program's
counters ``slam/stereo/depths`` over ``slam/stereo/keypoints`` (one
observation a frame each, summed on the card), without the part the
profiler covered.  None where the program has no such counters."""


def read(run):
    depths = run.section("slam/stereo/depths")
    kps = run.section("slam/stereo/keypoints")
    if depths is None or kps is None or not kps[0]:
        return None
    return 100.0 * depths[0] / kps[0]
