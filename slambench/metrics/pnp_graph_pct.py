"""Tracked frames whose PnP RANSAC + GN refine replayed the process's
CUDA graph, per hundred: the program's counter
``slam/track_fused/pnp_graph`` (one observation a tracked frame, 1 for a
replay and 0 for an eager call) over its observations, without the part
the profiler covered.  None where the program has no such counter."""


def read(run):
    got = run.section("slam/track_fused/pnp_graph")
    if got is None:
        return None
    return 100.0 * got[0] / got[1]
