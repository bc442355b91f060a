"""K1's share of its roofline: the least time of the batch's power
spectrograms (``ops/spectrogram.py`` -> ``csrc/spectrogram_power.cu``, every
route) over their traced device time a batch."""

import re

from harness.work import roofline_share

KERNELS = re.compile(r"spectrogram_power_|power_from_")


def read(ctx):
    return roofline_share(ctx, "k1", KERNELS)
