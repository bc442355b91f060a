"""Port parity of the detector-variant primitives against the JAX package:
the peak ops, the TD front-end modes (with the one-block causal ``sosfilt``
of short inputs), the TD envelope features and the clip spectral
occupancy."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS

from audio_processing_tools_tpu_torch.ops import features_spec as tfs
from audio_processing_tools_tpu_torch.ops import features_td as ttd
from audio_processing_tools_tpu_torch.ops import peaks as tpk

jfs = importlib.import_module("audio_processing_tools_tpu.ops.features_spec")
jtd = importlib.import_module("audio_processing_tools_tpu.ops.features_td")
jpk = importlib.import_module("audio_processing_tools_tpu.ops.peaks")

FS = 11162
MODE_BANDS = tuple(DEFAULT_MODE_BANDS)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


def _rows_with_ties():
    """Rows on a coarse grid (many equal neighbours and plateaus), plus a
    wide plateau peak, a plateau at the border and a constant row."""
    rng = np.random.default_rng(31)
    x = np.round(rng.normal(0.0, 2.0, (3, 6, 48))).astype(np.float32)
    x[0, 0, 10:15] = 9.0
    x[0, 1, :4] = 9.0
    x[1, 2] = 1.5
    return x


def test_local_maxima_with_plateaus_matches_jax():
    x = _rows_with_ties()
    got = tpk.local_maxima(torch.from_numpy(x)).numpy()
    ref = np.asarray(jpk.local_maxima(jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0, 12] and not got[0, 0, 10:15].sum() - 1  # the plateau's midpoint only
    assert not got[0, 1, :4].any() and not got[1, 2].any()
    assert not tpk.local_maxima(torch.ones(4, 2)).any()


def test_peak_prominences_and_widths_match_jax():
    x = _rows_with_ties()
    mask = tpk.local_maxima(torch.from_numpy(x))
    prom = tpk.peak_prominences(torch.from_numpy(x), mask)
    jmask = jpk.local_maxima(jnp.asarray(x))
    jprom = jpk.peak_prominences(jnp.asarray(x), jmask)
    np.testing.assert_array_equal(prom.numpy(), np.asarray(jprom))
    for rel_height in (0.5, 1.0):
        got = tpk.peak_widths_rel(torch.from_numpy(x), mask, prom, rel_height).numpy()
        ref = np.asarray(jpk.peak_widths_rel(jnp.asarray(x), jmask, jprom, rel_height))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert (prom.numpy()[~mask.numpy()] == 0).all()


@pytest.mark.parametrize("n", [4000, 20], ids=["filtfilt", "short_one_block_sosfilt"])
@pytest.mark.parametrize("mode", ["default", "comb_filter", "bandpass"])
def test_td_input_signal_matches_jax(mode, n):
    x = np.random.default_rng(32).standard_normal((3, n)).astype(np.float32)
    kw = dict(td_input_mode=mode, mode_bands=MODE_BANDS,
              td_input_band=(600.0, 2500.0) if mode == "bandpass" else None)
    got = ttd.td_input_signal(torch.from_numpy(x), FS, **kw).numpy()
    ref = np.stack([np.asarray(jtd.td_input_signal(jnp.asarray(r), FS, **kw)) for r in x])
    assert got.shape == ref.shape == x.shape
    assert _rel(got, ref) <= 1e-5


def test_envelope_features_match_jax():
    rng = np.random.default_rng(33)
    n = 6000
    x = 0.01 * rng.standard_normal((2, n))
    k = np.arange(600)
    for t0 in (700, 2500, 4100):  # sharp damped pings
        x[:, t0 : t0 + 600] += np.exp(-k / 50.0) * np.sin(2 * np.pi * 900.0 * k / FS)
    x = x.astype(np.float32)
    kw = dict(fs=FS, frame_len=256, hop=128, operating_band=(400.0, 3500.0),
              mode_bands=MODE_BANDS, envelope_features_enable=True)
    got = ttd.extract_td_features(torch.from_numpy(x), **kw)
    for b in range(x.shape[0]):
        ref = jtd.extract_td_features(jnp.asarray(x[b]), **kw)
        assert set(got) == set(ref)
        for key in ttd.TD_ENVELOPE_FEATURE_NAMES:
            assert _rel(got[key][b].numpy(), np.asarray(ref[key])) <= 1e-5, key
        assert np.asarray(ref["td_rise_time_sec"]).max() > 0
    # the subframe helpers at the lengths they special-case
    for N in (0, 1, 2, 3):
        env = rng.random((2, N)).astype(np.float32)
        shape = ttd.subframe_peak_shape_features(torch.from_numpy(env), subframe_hop=128, fs=FS)
        for b in range(2):
            ref = jtd.subframe_peak_shape_features(jnp.asarray(env[b]), subframe_hop=128, fs=FS)
            for key, val in ref.items():
                np.testing.assert_allclose(shape[key][b].numpy(), np.asarray(val), rtol=1e-6)
        for T in (0, 1, 4):
            np.testing.assert_allclose(
                ttd._frame_max_from_subframes(torch.from_numpy(env), T)[1].numpy(),
                np.asarray(jtd._frame_max_from_subframes(jnp.asarray(env[1]), T)))
            np.testing.assert_allclose(
                ttd._frame_sum_from_subframes(torch.from_numpy(env), T)[1].numpy(),
                np.asarray(jtd._frame_sum_from_subframes(jnp.asarray(env[1]), T)))


def test_clip_spectral_occupancy_matches_jax():
    rng = np.random.default_rng(34)
    P = (rng.gamma(0.5, 1.0, (3, 129, 70)) ** 2).astype(np.float32)
    rain = rng.random((3, 70)) < 0.3
    rain[1] = False  # an empty rain split
    rain[2] = True   # an empty no-rain split
    assert tfs.default_spectral_occupancy_bands() == jfs.default_spectral_occupancy_bands()
    got = tfs.clip_spectral_occupancy(torch.from_numpy(P), torch.from_numpy(rain), fs=FS, n_fft=256)
    for b in range(3):
        ref = jfs.clip_spectral_occupancy(jnp.asarray(P[b]), jnp.asarray(rain[b]), fs=FS, n_fft=256)
        assert set(got) == set(ref)
        for key, val in ref.items():
            g, r = got[key][b].numpy(), np.asarray(val)
            assert g.shape == r.shape and g.dtype == r.dtype, key
            assert _rel(g, r) <= 1e-5, key
