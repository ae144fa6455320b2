"""Left keypoints on the coarse pyramid levels (1 and up) given a stereo
depth, per hundred valid left keypoints there: the program's counters
``slam/stereo/coarse_depths`` over ``slam/stereo/coarse_keypoints`` (one
observation a frame each, summed on the card), without the part the
profiler covered.  None where the program has no such counters or no
coarse keypoint."""


def read(run):
    depths = run.section("slam/stereo/coarse_depths")
    kps = run.section("slam/stereo/coarse_keypoints")
    if depths is None or kps is None or not kps[0]:
        return None
    return 100.0 * depths[0] / kps[0]
