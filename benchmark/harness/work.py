"""Operations and bytes of the kernels whose rooflines the benchmark reads,
and the table of peaks.

Frozen here so that a roofline reads the same work whatever implements the
kernel.  Each input byte is counted once and each output byte once,
whatever a kernel reads again.  The counts follow the port's
``chip_smoke.py`` (``bound_of``, ``k1_work``, ``k4_work`` and K2's line of
its work table) at commit 63e936f.  A configuration lists, under
``kernel_work``, the calls of each kernel in one batch, per clip of the
batch: ``{"fn": <function below>, "rows_per_clip": r, ...its sizes...}``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

#: published peaks of the cards the benchmark runs on: HBM bytes/s and
#: float32 FLOP/s outside the tensor cores (NVIDIA's H100 SXM data sheet)
PEAKS = {"H100": (3.35e12, 67e12)}


def peaks_of(device_name: str) -> Optional[Tuple[float, float]]:
    for key, peak in PEAKS.items():
        if key in device_name:
            return peak
    return None


def spectrogram_power(rows: int, samples: int, n_fft: int, hop: int) -> Tuple[float, float]:
    """K1, the centred power spectrogram: samples in and power out, 4 bytes
    each; per frame the window (n_fft), the half-length FFT (5 M log2 M, M =
    n_fft / 2) and 13 a bin for the split and the power."""
    M = n_fft // 2
    T = 1 + samples // hop
    return (4.0 * (rows * samples + rows * (M + 1) * T),
            float(rows * T * (2 * M + 5 * M * math.log2(M) + 13 * (M + 1))))


def noise_psd_track(rows: int, bins: int, frames: int) -> Tuple[float, float]:
    """K2, the noise PSD tracker: power in and the track out (4 bytes an
    element each), a rain mask byte a frame; 20 operations an element."""
    n = rows * bins * frames
    return 8.0 * n + rows * frames, 20.0 * n


def cascade_sosfilt(rows: int, samples: int, sections: int) -> Tuple[float, float]:
    """K4, the zero-state cascade: x in and y out, 4 bytes a sample each; a
    sample and section the transposed direct form's 5 products and 4 sums."""
    n = rows * samples
    return 8.0 * n, 9.0 * n * sections


FUNCTIONS = {"spectrogram_power": spectrogram_power, "noise_psd_track": noise_psd_track,
             "cascade_sosfilt": cascade_sosfilt}


def batch_work(config: Dict[str, Any], kernel: str, clips: int) -> Optional[Tuple[float, float]]:
    """Bytes and operations of ``kernel``'s calls in one batch of ``clips``,
    or None where the configuration runs no such call."""
    calls = config.get("kernel_work", {}).get(kernel)
    if not calls:
        return None
    nbytes = ops = 0.0
    for call in calls:
        kw = {k: v for k, v in call.items() if k not in ("fn", "rows_per_clip", "calls")}
        b, o = FUNCTIONS[call["fn"]](clips * int(call["rows_per_clip"]), **kw)
        nbytes += b * int(call.get("calls", 1))
        ops += o * int(call.get("calls", 1))
    return nbytes, ops


def least_seconds(nbytes: float, ops: float, peaks: Tuple[float, float]) -> float:
    """The least time of the work on the card: bytes over the memory
    bandwidth or operations over the FLOP/s, whichever is larger."""
    return max(nbytes / peaks[0], ops / peaks[1])


def roofline_share(ctx: Any, kernel: str, pattern) -> Optional[float]:
    """``kernel``'s share of its roofline in percent: the least time of its
    calls in a batch over their traced device time a batch (every launch
    whose name ``pattern`` matches).  None where the configuration runs no
    such call, the trace holds no such launch, or the card has no peaks in
    the table."""
    work = batch_work(ctx.config, kernel, ctx.clips_per_batch)
    peaks = peaks_of(ctx.device_name)
    if work is None or peaks is None or ctx.trace is None:
        return None
    seconds = ctx.trace.kernel_seconds(pattern) / ctx.trace.batches
    if seconds <= 0.0:
        return None
    return 100.0 * least_seconds(*work, peaks) / seconds
