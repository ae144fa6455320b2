"""Share of the traced window in which no operation ran on the device:
100 x (1 - union of the device operations' intervals / window)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.window_s or not tr.n_device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
