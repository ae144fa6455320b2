"""PnP inliers per hundred gated matches over the tracked frames: the
program's counters ``slam/track_fused/{inliers,matches}`` (each frame
``track`` tracked against the local map) and ``slam/track_batch/
{inliers,matches}`` (each frame a batch accepted), summed, without the
part the profiler covered."""

KINDS = ("slam/track_fused", "slam/track_batch")


def read(run):
    got = {}
    for what in ("inliers", "matches"):
        parts = [run.section(f"{kind}/{what}") for kind in KINDS]
        got[what] = sum(p[0] for p in parts if p is not None)
    if not got["matches"]:
        return None
    return 100.0 * got["inliers"] / got["matches"]
