"""K4's share of its roofline: the least time of the batch's zero-state
cascades (``ops/filters.py::cascade_sosfilt`` -> ``csrc/cascade.cu``:
drifts, walk and outputs) over their traced device time a batch."""

import re

from harness.work import roofline_share

KERNELS = re.compile(r"cascade_(drifts|walk|out)")


def read(ctx):
    return roofline_share(ctx, "k4", KERNELS)
