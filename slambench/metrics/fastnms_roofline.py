"""B1's least time a launch (bytes and operations, ``roofline/fastnms.py``)
over its device time a launch in the traced window, in percent."""

from slambench.roofline import share_pct


def read(run):
    return share_pct(run, "fastnms")
