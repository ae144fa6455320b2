"""The trace's arithmetic: busy time is the union of device intervals
(overlaps count once), and idle gaps go to the innermost host range."""

import pytest

from slambench.trace import merge, name_gaps


def test_union_counts_overlaps_once():
    busy = merge([(0, 10), (5, 12), (20, 30), (30, 31), (40, 41)])
    assert busy == [(0, 12), (20, 31), (40, 41)]
    assert sum(b - a for a, b in busy) == 24      # a sum would read 30


def test_gaps_named_by_the_innermost_open_range():
    busy = [(0, 10), (20, 30), (50, 60), (100, 110)]
    ranges = [(0, 60, "slam/track_fused"), (12, 35, "slam/local_ba")]
    idle = name_gaps(busy, ranges)
    assert idle == pytest.approx({"slam/local_ba": 10e-9,
                                  "slam/track_fused": 20e-9,
                                  "bench/other": 40e-9})
