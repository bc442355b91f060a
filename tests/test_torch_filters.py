"""Port parity: the IIR filter design constants (copied NumPy code) and the
torch cascade / ``sosfiltfilt`` against the JAX package and scipy."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.signal as ss
import torch

from audio_processing_tools_tpu.ops import filters as jf

from audio_processing_tools_tpu_torch.ops import filters as tf

FS = 11162


def _sos_cases():
    return [tf.design_highpass(FS, 350.0, 4), tf.design_bandpass(FS, 400.0, 3500.0, 4),
            tf.butter_sos(3, 0.2, "lowpass")]


def test_design_constants_bit_equal_to_jax():
    np.testing.assert_array_equal(tf.design_highpass(FS, 350.0, 4),
                                  jf.design_highpass(FS, 350.0, 4))
    np.testing.assert_array_equal(tf.design_bandpass(FS, 400.0, 3500.0, 4),
                                  jf.design_bandpass(FS, 400.0, 3500.0, 4))
    for sos in _sos_cases():
        np.testing.assert_array_equal(tf.sosfilt_zi(sos), jf.sosfilt_zi(sos))
        for a, b in zip(tf._cascade_state_space(sos), jf._cascade_state_space(sos)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tf._cascade_matmul_constants(sos, 128),
                        jf._cascade_matmul_constants(sos, 128)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tf._boundary_logdepth_powers(sos, 128, 40),
                        jf._boundary_logdepth_powers(sos, 128, 40)):
            np.testing.assert_array_equal(a, b)


def test_sosfiltfilt_matches_jax_and_scipy():
    sos = tf.design_highpass(FS, 350.0, 4)
    x = np.random.default_rng(6).standard_normal((3, 2 * FS + 11)).astype(np.float32)
    got = tf.sosfiltfilt(sos, torch.from_numpy(x)).numpy()
    ref_jax = np.asarray(jf.sosfiltfilt(sos, jnp.asarray(x)))
    ref_sp = ss.sosfiltfilt(sos, x.astype(np.float64), axis=-1)
    assert np.abs(got - ref_jax).max() / np.abs(ref_jax).max() <= 1e-5
    assert np.abs(got - ref_sp).max() / np.abs(ref_sp).max() <= 1e-5


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_cascade_matmul_logdepth_matches_jax(reverse):
    sos = tf.design_bandpass(FS, 400.0, 3500.0, 4)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 1000)).astype(np.float32)  # ragged last block
    zi = rng.standard_normal((2, sos.shape[0], 2)).astype(np.float32)
    got = tf._sosfilt_cascade_matmul(sos, torch.from_numpy(x), torch.from_numpy(zi),
                                     reverse=reverse).numpy()
    ref = np.asarray(jf._sosfilt_cascade_matmul(sos, jnp.asarray(x), jnp.asarray(zi),
                                                reverse=reverse, boundary="logdepth"))
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-5


def test_sosfiltfilt_short_input_and_scan_boundary_raise():
    sos = tf.design_highpass(FS, 350.0, 4)
    with pytest.raises(ValueError, match="padlen"):
        tf.sosfiltfilt(sos, torch.zeros(1, 15))
    with pytest.raises(NotImplementedError, match="P13"):
        tf._sosfilt_cascade_matmul(sos, torch.zeros(1, 300), torch.zeros(2, 2),
                                   boundary="scan")
