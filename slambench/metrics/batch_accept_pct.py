"""Frames a ``track_batch`` dispatch accepted per hundred it carried: the
program's counter ``slam/track_batch/accepted`` (one observation a
dispatch) over its dispatches times the cell's ``dispatch_batch``
(configuration, then traffic), without the part the profiler covered."""


def read(run):
    got = run.section("slam/track_batch/accepted")
    k = dict(run.config.get("slam", {}),
             **run.traffic.get("slam", {})).get("dispatch_batch")
    if got is None or not k:
        return None
    return 100.0 * got[0] / (got[1] * k)
