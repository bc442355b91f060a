"""Port parity: the RoE companions ``models/wind.py`` (kernel K4 runs its
plain version on the CPU) and ``models/pitch.py`` against the JAX
package's modules of the same names.

Tolerances against JAX: gust times, novelty masks, the pulse list's
indices and times identical; novelties and pulse energies within 1e-5 of
their maximum (the novelty's frequency sum and the filter's sums are in
the port's own fixed order); the NumPy helpers (``compute_rain_mod``,
``compute_novelty_energy``, ``moving_average_smoothing``,
``check_energy_threshold``, ``compare_novelties``) identical; the EAC
within 1e-5 of its maximum (two FFT libraries) and the pitch identical;
``unwrap`` identical to ``jnp.unwrap`` on equal input and within 1e-5 of
NumPy's in float64; the instantaneous frequency on 98% of samples within
1e-5 of its maximum and everywhere within 2e-4: it differences a phase
unwrapped to ~300 rad, whose float32 ulp (3e-5 rad) is 0.054 Hz after the
fs / 2 pi scale, so an FFT's last bit can move a value by that much.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_processing_tools_tpu.models import pitch as jpitch
from audio_processing_tools_tpu.models import wind as jwind
from audio_processing_tools_tpu.ops.stft import stft as jstft

from audio_processing_tools_tpu_torch.models import pitch as tpitch
from audio_processing_tools_tpu_torch.models import wind as twind

FS = 11162


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _gusty(seed, n=FS * 4):
    """Low-frequency swelling 'wind' over noise, with a few rain pings."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    swell = (1 + np.sin(2 * np.pi * 0.4 * t)) ** 2
    x = 0.02 * rng.standard_normal(n) + 0.3 * swell * np.sin(2 * np.pi * 250 * t)
    k = np.arange(300)
    for t0 in rng.integers(1000, n - 400, 12):
        x[t0 : t0 + 300] += 0.8 * np.exp(-k / 25.0) * np.sin(2 * np.pi * 550 * k / FS)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def mag():
    return np.abs(np.asarray(jstft(jnp.asarray(_gusty(1)))))


def test_detect_gusts_matches_jax(mag):
    got = twind.detect_gusts(mag, FS, device="cpu")
    ref = jwind.detect_gusts(mag, FS)
    np.testing.assert_array_equal(got[0], ref[0])  # gust times
    assert got[0].size > 0
    for g, r in zip(got[1:], ref[1:]):
        assert g.shape == r.shape and _rel(g, r) <= 1e-5
        np.testing.assert_array_equal(g > 0, r > 0)
    state = twind.novelty_based_gust_detection(mag, FS, device="cpu")
    jstate = jwind.novelty_based_gust_detection(mag, FS)
    assert set(state) == set(jstate)
    np.testing.assert_array_equal(state["gust_time"], jstate["gust_time"])
    np.testing.assert_array_equal(state["time_spec"], jstate["time_spec"])
    for key, v in jstate["novelty_comparison"].items():
        assert state["novelty_comparison"][key] == pytest.approx(v, rel=1e-5), key


def test_numpy_helpers_identical():
    rng = np.random.default_rng(2)
    nov_rain, nov_gust = rng.random(50) * 10, np.where(rng.random(50) < 0.5, 0, rng.random(50) * 3)
    raining = (rng.random(50) < 0.5).astype(float)
    np.testing.assert_array_equal(twind.compute_rain_mod(nov_rain, nov_gust, raining, 4.0),
                                  jwind.compute_rain_mod(nov_rain, nov_gust, raining, 4.0))
    assert twind.compare_novelties(nov_rain, nov_gust, nov_rain > 5, nov_gust > 1) == \
        jwind.compare_novelties(nov_rain, nov_gust, nov_rain > 5, nov_gust > 1)
    x = np.zeros(FS)
    x[4000:4200] = 0.5
    for kw in ({}, {"gamma": None, "norm": False}):
        g, r = (m.compute_novelty_energy(x, Fs=FS, N=512, H=256, **kw) for m in (twind, jwind))
        np.testing.assert_array_equal(g[0], r[0])
        assert g[1] == r[1]
    np.testing.assert_array_equal(twind.moving_average_smoothing(nov_rain, 5),
                                  jwind.moving_average_smoothing(nov_rain, 5))
    with pytest.raises(ValueError):
        twind.moving_average_smoothing(x, 0)
    spec = np.zeros(129)
    spec[20] = 5.0
    for thr in (1.0, 100.0):
        assert twind.check_energy_threshold(spec, (400, 3500), FS, 256, thr) == \
            jwind.check_energy_threshold(spec, (400, 3500), FS, 256, thr)


def test_analyze_energy_peaks_matches_jax():
    rng = np.random.default_rng(3)
    n = FS * 2
    x = 0.02 * rng.uniform(-1.0, 1.0, n)
    k = np.arange(150)
    for t0 in (5000, 12000, 17000):
        x[t0 : t0 + 150] += 1.5 * np.exp(-k / 12.0) * np.sin(2 * np.pi * 500 * k / FS)
    pulses, energy, efs = twind.analyze_energy_peaks(x.astype(np.float32), FS, device="cpu")
    jpulses, jenergy, jefs = jwind.analyze_energy_peaks(x.astype(np.float32), FS)
    assert efs == jefs and energy.shape == jenergy.shape and energy.dtype == jenergy.dtype
    assert _rel(energy, jenergy) <= 1e-5
    assert len(pulses) == len(jpulses) >= 1
    for p, q in zip(pulses, jpulses):
        assert set(p) == set(q)
        for key, v in q.items():
            if key.endswith("energy"):
                assert p[key] == pytest.approx(v, rel=1e-5), key
            else:
                assert p[key] == v, key
    # no peak at all: a ramp
    assert twind.analyze_energy_peaks(np.linspace(0, 1, 4800), FS, device="cpu")[0] == []


def _harmonic_frames(n=6, L=1024, f0=220.0):
    k = np.arange(L)
    return np.stack([sum((1.0 / h) * np.sin(2 * np.pi * f0 * h * (k + 17 * i) / FS)
                         for h in range(1, 5)) for i in range(n)]).astype(np.float32)


def test_eac_and_pitch_match_jax():
    frames = _harmonic_frames()
    eac = tpitch.compute_eac_for_frames(frames, device="cpu")
    jeac = np.asarray(jpitch.compute_eac_for_frames(frames))
    assert eac.shape == jeac.shape == frames.shape and _rel(eac.numpy(), jeac) <= 1e-5
    for kw in ({}, {"fmin": 100, "fmax": 800, "harmonic_weights": (1.0, 0.6)}):
        f0 = tpitch.estimate_pitch_from_eac(eac, FS, device="cpu", **kw).numpy()
        jf0 = np.asarray(jpitch.estimate_pitch_from_eac(jnp.asarray(jeac), FS, **kw))
        assert f0.dtype == jf0.dtype == np.float32
        np.testing.assert_array_equal(f0, jf0)
        assert np.all(np.abs(f0 - 220) < 15)
    # a lag range that is empty gives zeros
    assert not tpitch.estimate_pitch_from_eac(eac[:, :5], FS, device="cpu").any()


def test_instantaneous_frequency_matches_jax():
    k = np.arange(1024)
    for n in (1024, 1023):
        tone = (np.sin(2 * np.pi * 500 * k[:n] / FS)
                + 0.3 * np.sin(2 * np.pi * 1300 * k[:n] / FS)).astype(np.float32)
        got = tpitch.compute_instantaneous_frequency(tone, FS, device="cpu")
        ref = jpitch.compute_instantaneous_frequency(tone, FS)
        assert got.shape == ref.shape == (n,) and _rel(got, ref) <= 2e-4
        close = np.abs(got - ref) <= 1e-5 * np.abs(ref).max()
        assert close.mean() >= 0.98, close.mean()


def test_unwrap_is_numpy_unwrap():
    rng = np.random.default_rng(4)
    p = np.cumsum(rng.uniform(-3.5, 3.5, (3, 400)), axis=-1)
    p = np.angle(np.exp(1j * p))  # wrapped phases, jumps of every size
    p[0, 10] = p[0, 9] + np.pi    # a jump of exactly pi
    for dim in (-1, 0):
        got = tpitch.unwrap(torch.from_numpy(p.astype(np.float32)), dim=dim).numpy()
        assert _rel(got, np.unwrap(p, axis=dim)) <= 1e-5
        np.testing.assert_array_equal(got, np.asarray(jnp.unwrap(jnp.asarray(p, jnp.float32),
                                                                 axis=dim)))
