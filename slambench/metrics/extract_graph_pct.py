"""Extractions that replayed the process's CUDA graph, per hundred: the
program's counters ``slam/extract/graph`` (a frame's image) and
``slam/stereo/graph`` (a stereo frame's right image), one observation a
call each, 1 for a replay and 0 for an eager call, summed over both and
taken over their observations, without the part the profiler covered.
None where the program has neither counter."""


def read(run):
    got = [s for s in (run.section("slam/extract/graph"),
                       run.section("slam/stereo/graph")) if s is not None]
    if not got:
        return None
    return 100.0 * sum(s[0] for s in got) / sum(s[1] for s in got)
