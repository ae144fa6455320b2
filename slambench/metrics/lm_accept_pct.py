"""Steps the local BA's LM accepted per hundred it tried: the program's
counters ``slam/local_ba/lm_accepted`` (summed on the card, read after
the window) over ``slam/local_ba/lm_iters``, without the part the
profiler covered."""


def read(run):
    iters = run.section("slam/local_ba/lm_iters")
    acc = run.section("slam/local_ba/lm_accepted")
    if iters is None or acc is None or not iters[0]:
        return None
    return 100.0 * acc[0] / iters[0]
