"""Milliseconds a local BA takes: the program's timer section
``slam/local_ba`` (window, problem, the Schur LM through B5 and B6,
write-back) over its calls in the window, without the part the profiler
covered."""


def read(run):
    got = run.section("slam/local_ba")
    return None if got is None else got[0] / got[1] * 1e3
