"""Port parity: the IIR filter design constants (copied NumPy code), the
torch cascade / ``sosfiltfilt`` and ``sosfilt`` with ``zi`` (kernel K7's
plain loop on the CPU) against the JAX package and scipy."""

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
    """A too-short input to ``sosfiltfilt`` raises naming padlen.  The
    sequential ``scan`` boundary over more than one block, which raised
    until kernel K4 was ported, is :func:`cascade_sosfilt`: its output
    equals the JAX package's ``boundary="scan"`` within 1e-5 of its
    maximum."""
    sos = tf.design_highpass(FS, 350.0, 4)
    with pytest.raises(ValueError, match="padlen"):
        tf.sosfiltfilt(sos, torch.zeros(1, 15))
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 300)).astype(np.float32)
    zi = (0.1 * rng.standard_normal((sos.shape[0], 2))).astype(np.float32)
    got = tf.cascade_sosfilt(sos, torch.from_numpy(x), torch.from_numpy(zi))[0].numpy()
    ref = np.asarray(jf._sosfilt_cascade_matmul(sos, jnp.asarray(x), jnp.asarray(zi),
                                                boundary="scan"))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-5


@pytest.mark.parametrize("case", [0, 1, 2], ids=["highpass", "bandpass", "lowpass3"])
def test_sosfilt_zi_matches_scipy_and_jax(case):
    """y and zf from a nonzero state within 1e-5 of scipy in float64
    (``tools/tpu_checks.py:78-91``) and of the JAX package's blocked scan."""
    sos = _sos_cases()[case]
    rng = np.random.default_rng(8)
    x = (0.1 * rng.standard_normal((3, 5000))).astype(np.float32)
    zi = (0.01 * rng.standard_normal((3, sos.shape[0], 2))).astype(np.float32)
    y, zf = tf.sosfilt(sos, torch.from_numpy(x), torch.from_numpy(zi))
    y_sp, zf_sp = ss.sosfilt(sos, x.astype(np.float64), axis=-1,
                             zi=zi.astype(np.float64).transpose(1, 0, 2))
    zf_sp = zf_sp.transpose(1, 0, 2)
    y_j, zf_j = jf.sosfilt(sos, jnp.asarray(x), zi=jnp.asarray(zi))
    for got, ref in ((y.numpy(), y_sp), (zf.numpy(), zf_sp), (y.numpy(), np.asarray(y_j)),
                     (zf.numpy(), np.asarray(zf_j))):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-5


def test_sosfilt_zi_is_chunk_invariant_bit_for_bit():
    """The state carried from chunk to chunk gives one call's bits, for any
    cut, and a (S, 2) zi broadcasts over the streams."""
    sos = tf.design_highpass(FS, 350.0, 4)
    rng = np.random.default_rng(9)
    x = torch.from_numpy((0.1 * rng.standard_normal((2, 3000))).astype(np.float32))
    zi = torch.zeros(sos.shape[0], 2)
    y_one, zf_one = tf.sosfilt(sos, x, zi)
    for seed in range(3):
        cuts = np.sort(np.random.default_rng(seed).choice(np.arange(1, 3000), 6, replace=False))
        ys, z = [], zi
        for a, b in zip(np.r_[0, cuts], np.r_[cuts, 3000]):
            y, z = tf.sosfilt(sos, x[:, a:b], z)
            ys.append(y)
        assert torch.equal(torch.cat(ys, dim=-1), y_one) and torch.equal(z, zf_one)


def test_sosfilt_zi_kernel_wrapper_raises_on_a_cpu_tensor():
    """K7's wrapper launches or raises: no fallback to the plain loop."""
    coef = torch.from_numpy(tf._sos_coefficients(tf.design_highpass(FS, 350.0, 4)))
    with pytest.raises(ValueError):
        tf._sosfilt_zi_cuda(coef, torch.zeros(2, 10), torch.zeros(2, 2, 2))
