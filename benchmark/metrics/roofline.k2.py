"""K2's share of its roofline: the least time of the batch's noise PSD
tracks (``ops/trackers.py`` -> ``csrc/trackers.cu``, the ``PsdTracker``
walk) over their traced device time a batch."""

import re

from harness.work import roofline_share

KERNELS = re.compile(r"tracker_tiles<.*PsdTracker")


def read(ctx):
    return roofline_share(ctx, "k2", KERNELS)
