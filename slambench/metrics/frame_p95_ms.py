"""95th percentile over every frame of the window of the time from
handing the frame to ``track`` until its pose is on the host."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    return float(np.percentile(np.asarray(run.latencies), 95)) * 1e3
