"""B5's least time a launch (bytes and operations of each recorded launch,
``roofline/schur.py``) over its device time a launch in the traced
window, in percent."""

from slambench.roofline import share_pct


def read(run):
    return share_pct(run, "schur")
