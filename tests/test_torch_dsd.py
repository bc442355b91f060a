"""Port parity: the firmware DSD minute vectors (``host_analysis/``).

  * The emulator copy and ``dsd_minutes_vectorized`` against the JAX
    package's: all 100 bins identical (both NumPy float64).
  * ``dsd_minutes_device`` (float32 FFT on the CPU here) against JAX's and
    against the emulator, to ``tests/test_dsd_transform.py:214-260``'s
    bounds: loudness and pft bins (0-61) identical, fft bins within one
    and equal on at least 95%.
  * The duty-cycled minutes: every bin identical to the emulator, in the
    four scenarios of ``tests/test_dsd_transform.py:291-301``.
"""

import numpy as np
import pytest

from audio_processing_tools_tpu.host_analysis import dsd_device as jdev
from audio_processing_tools_tpu.host_analysis import dsd_emulator as jemu

from audio_processing_tools_tpu_torch.host_analysis import (
    DsdProcessingEmualtor,
    DsdProcessingEmulator,
    dsd_minutes_device,
    dsd_minutes_device_duty_cycled,
)
from audio_processing_tools_tpu_torch.host_analysis import dsd_device as tdev
from audio_processing_tools_tpu_torch.host_analysis import dsd_emulator as temu

FS = 11162


def _rain_audio(rng, seconds=120):
    """Noise and 520 Hz drops (``tests/test_dsd_transform.py:24-30``)."""
    n = FS * seconds
    x = 0.01 * rng.standard_normal(n)
    for t0 in rng.integers(0, n - 700, 40 * seconds // 60):
        k = np.arange(600)
        x[t0 : t0 + 600] += 1.5 * np.exp(-k / 100.0) * np.sin(2 * np.pi * 520 * k / FS)
    return x.astype(np.float64)


def _assert_bins(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[..., :62], ref[..., :62])
    if got.size:
        assert np.max(np.abs(got[..., 62:] - ref[..., 62:])) <= 1
        assert (got[..., 62:] == ref[..., 62:]).mean() >= 0.95


@pytest.fixture(scope="module")
def clip130():
    return _rain_audio(np.random.default_rng(1234), seconds=130)


def test_emulator_copy_matches_jax(clip130):
    assert DsdProcessingEmualtor is DsdProcessingEmulator
    assert vars(DsdProcessingEmulator()).keys() == vars(jemu.DsdProcessingEmulator()).keys()
    for k, v in vars(jemu.DsdProcessingEmulator()).items():
        np.testing.assert_array_equal(getattr(DsdProcessingEmulator(), k), v, err_msg=k)
    got = DsdProcessingEmulator(FS, 512, 512, False, 0).process_audio_data(clip130, ts=0)
    ref = jemu.DsdProcessingEmulator(FS, 512, 512, False, 0).process_audio_data(clip130, ts=0)
    assert len(got) == len(ref) == 3
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_vectorized_copy_matches_jax(clip130):
    got = temu.dsd_minutes_vectorized(clip130, FS, 512, ts=0.0)
    ref = jemu.dsd_minutes_vectorized(clip130, FS, 512, ts=0.0)
    np.testing.assert_array_equal(got, ref)
    got = temu.dsd_minutes_vectorized(clip130[: FS * 70], FS, 512, ts=17.0)
    np.testing.assert_array_equal(got, jemu.dsd_minutes_vectorized(clip130[: FS * 70], FS, 512,
                                                                   ts=17.0))


def test_minute_schedule_matches_jax():
    for n in (FS * 130, FS * 60, FS * 10, 511, 512):
        got, ref = tdev._minute_schedule(n, FS, 512), jdev._minute_schedule(n, FS, 512)
        assert len(got[0]) == len(ref[0])
        for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
            np.testing.assert_array_equal(a, b)


def test_dsd_device_matches_jax_and_emulator(clip130):
    """A 130 s raining recording: 2 full minutes and a partial one."""
    got = dsd_minutes_device(clip130.astype(np.float32), FS, device="cpu")
    assert got.dtype == np.float32 and got.shape == (3, 100)
    ref = np.asarray(DsdProcessingEmulator(FS, 512, 512, False, 0)
                     .process_audio_data(clip130, ts=0))
    _assert_bins(got, ref)
    _assert_bins(got, jdev.dsd_minutes_device(clip130.astype(np.float32), FS))


def test_dsd_device_batched():
    rng = np.random.default_rng(1234)
    xb = np.stack([_rain_audio(rng, seconds=65) for _ in range(3)])
    got = dsd_minutes_device(xb.astype(np.float32), FS, device="cpu")
    assert got.shape == (3, 2, 100)  # a full minute and 5 s
    _assert_bins(got, jdev.dsd_minutes_device(xb.astype(np.float32), FS))
    for i in range(3):
        ref = np.asarray(DsdProcessingEmulator(FS, 512, 512, False, 0)
                         .process_audio_data(xb[i], ts=0))
        _assert_bins(got[i], ref)
        # a row alone gives the batch's bits
        np.testing.assert_array_equal(
            dsd_minutes_device(xb[i].astype(np.float32), FS, device="cpu"), got[i])


def test_dsd_device_short_audio():
    x = np.zeros(FS * 10, np.float32)  # one partial minute
    ref = np.asarray(DsdProcessingEmulator(FS, 512, 512, False, 0)
                     .process_audio_data(x.astype(np.float64), ts=0))
    out = dsd_minutes_device(x, FS, device="cpu")
    assert out.shape == ref.shape == (1, 100)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, jdev.dsd_minutes_device(x, FS))
    empty = dsd_minutes_device(np.zeros(100, np.float32), FS, device="cpu")
    assert empty.shape == jdev.dsd_minutes_device(np.zeros(100, np.float32), FS).shape == (0, 100)


def _duty_scenarios(rng):
    """The four 200 s scenarios of ``tests/test_dsd_transform.py:284-301``."""
    k = np.arange(800)
    ping = np.exp(-k / 60.0) * sum(a * np.sin(2 * np.pi * f * k / FS)
                                   for f, a in [(520, 1.0), (900, 0.5)])
    n = FS * 200

    def build(rain_windows):
        x = 0.0005 * rng.standard_normal(n)
        for lo_s, hi_s, m in rain_windows:
            for t0 in rng.integers(int(FS * lo_s), int(FS * hi_s), m):
                x[t0 : t0 + 800] += 0.5 * ping
        return np.clip(x, -1, 1)

    return {
        "rain_then_dry": (build([(0.25, 50, 25)]), 0.0),
        "re_engage": (build([(0.25, 50, 25), (177.2, 179.5, 8), (181, 198, 12)]), 0.0),
        "all_silent": (np.zeros(n), 0.0),
        "ts_offset": (build([(0.25, 50, 25)])[: FS * 150], 23.0),
    }


@pytest.mark.parametrize("name", ["rain_then_dry", "re_engage", "all_silent", "ts_offset"])
def test_duty_cycled_bit_equal_to_emulator(name):
    x, ts = _duty_scenarios(np.random.default_rng(1234))[name]
    ref = DsdProcessingEmulator(FS, 512, 512, False, 0).process_audio_data(x.astype(np.float64), ts)
    got = dsd_minutes_device_duty_cycled(x.astype(np.float32), FS, 512, ts=ts, device="cpu")
    assert len(got) == len(ref) >= 2, (len(got), len(ref))
    for m, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(np.asarray(g), r, err_msg=f"{name}: minute {m}")
    if name == "rain_then_dry":  # the check-window path ran
        assert any(np.all(v[62:] == 0) for v in ref[1:])
    # a (B, n) batch gives a list per recording
    both = dsd_minutes_device_duty_cycled(np.stack([x, x]).astype(np.float32), FS, 512, ts=ts,
                                          device="cpu")
    assert len(both) == 2 and all(np.array_equal(a, b) for a, b in zip(both[1], got))
