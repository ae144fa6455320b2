"""Tracked frames whose covisibility slab reused the point ids of the
call before, per hundred: the program's counter
``slam/track_fused/slab_hit`` (one observation a tracked frame, 1 where
the ids were reused and 0 where they were computed) over its
observations, without the part the profiler covered.  None where the
program has no such counter."""


def read(run):
    got = run.section("slam/track_fused/slab_hit")
    if got is None:
        return None
    return 100.0 * got[0] / got[1]
