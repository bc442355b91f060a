"""Port parity: the power spectrogram (kernel K1's plain path on the CPU)
and the STFT helpers against the JAX package.

The JAX side runs its Pallas kernel in interpret mode, as
``tests/test_spectrogram_kernel.py`` does.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from audio_processing_tools_tpu.ops.framing import frame_signal as jframe
from audio_processing_tools_tpu.ops.windows import hann_window as jhann

from audio_processing_tools_tpu_torch import _kernels
from audio_processing_tools_tpu_torch.ops import spectrogram as tspec
from audio_processing_tools_tpu_torch.ops import stft as tstft
from audio_processing_tools_tpu_torch.ops.framing import frame_signal, num_frames
from audio_processing_tools_tpu_torch.ops.windows import hann_window

# the JAX package's ops/__init__ re-exports functions under the module names
jspec = importlib.import_module("audio_processing_tools_tpu.ops.spectrogram")
jstft = importlib.import_module("audio_processing_tools_tpu.ops.stft")

FS = 11162


def _input(shape):
    return (0.1 * np.random.default_rng(20).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, FS), (FS + 37,)], ids=["batch", "1d_odd"])
def test_spectrogram_power_matches_pallas_interpret_and_stft_power(shape):
    x = _input(shape)
    got = tspec.spectrogram_power(torch.from_numpy(x)).numpy()
    pallas = np.asarray(jspec.spectrogram_power(jnp.asarray(x), use_pallas=True,
                                                interpret=True))
    ref = np.asarray(jstft.stft_power(jnp.asarray(x)))
    assert got.shape == pallas.shape == ref.shape
    assert np.abs(got - pallas).max() / pallas.max() < 1e-5
    assert np.abs(got - ref).max() / ref.max() < 1e-5


def test_cpu_tensor_launches_no_kernel():
    _kernels.reset_launches()
    tspec.spectrogram_power(torch.from_numpy(_input((2, 4000))))
    assert _kernels.LAUNCHES["spectrogram_power"] == 0


def test_dft_matrix_t_is_the_jax_constant():
    for n_fft in (256, 512):
        np.testing.assert_array_equal(tspec._dft_matrix_t(n_fft),
                                      jspec._dft_matrix_t(n_fft))


def test_stft_and_helpers_match_jax():
    x = _input((3, 3001))
    got = tstft.stft(torch.from_numpy(x)).numpy()
    ref = np.asarray(jstft.stft(jnp.asarray(x)))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5
    np.testing.assert_array_equal(hann_window(256), jhann(256))
    np.testing.assert_array_equal(hann_window(7, periodic=False), jhann(7, periodic=False))
    np.testing.assert_array_equal(tstft.fft_frequencies(FS, 256), jstft.fft_frequencies(FS, 256))
    np.testing.assert_array_equal(tstft.frames_to_time(np.arange(9), FS, 128),
                                  jstft.frames_to_time(np.arange(9), FS, 128))
    for frame_len, hop in ((256, 128), (100, 37), (8, 8)):
        np.testing.assert_array_equal(
            frame_signal(torch.from_numpy(x), frame_len, hop).numpy(),
            np.asarray(jframe(jnp.asarray(x), frame_len, hop)))
    assert num_frames(100, 256, 128) == 0
    assert frame_signal(torch.zeros(2, 100), 256, 128).shape == (2, 0, 256)
