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


@pytest.mark.parametrize("n_fft", tspec.N_FFTS)
def test_kernel_tables_are_float64_rounded_to_float32(n_fft):
    window, twiddle = tspec.kernel_tables(n_fft)
    k = np.arange(n_fft, dtype=np.float64)
    assert window.dtype == twiddle.dtype == np.float32
    np.testing.assert_array_equal(window, (0.5 - 0.5 * np.cos(2 * np.pi * k / n_fft)).astype(np.float32))
    np.testing.assert_array_equal(window, np.asarray(jhann(n_fft)))
    e = np.exp(-2j * np.pi * k / n_fft)
    np.testing.assert_array_equal(twiddle, np.stack([e.real, e.imag], -1).astype(np.float32))


def test_rectangular_window_is_the_band_noise_frame_power():
    """``window="rect"`` is the unwindowed power of the band-noise estimator's
    frames (``band_noise.py:226-228``: n = hop = frame_len, no centering),
    within 1e-5 of the JAX rFFT's maximum; the kernel's window table is
    ones, and an unknown window raises."""
    x = _input((2, 512 * 9))
    got = tspec.spectrogram_power(torch.from_numpy(x), n_fft=512, hop=512, center=False,
                                  window="rect").numpy()
    X = np.asarray(jnp.fft.rfft(jnp.asarray(x.reshape(2, 9, 512)), axis=-1))
    ref = (X.real ** 2 + X.imag ** 2).transpose(0, 2, 1)
    assert got.shape == ref.shape == (2, 257, 9)
    assert np.abs(got - ref).max() / ref.max() < 1e-5
    window, _ = tspec.kernel_tables(512, "rect")
    np.testing.assert_array_equal(window, np.ones(512, np.float32))
    with pytest.raises(ValueError, match="window"):
        tspec.spectrogram_power(torch.from_numpy(x), window="kaiser")


@pytest.mark.parametrize("n_fft", tspec.N_FFTS)
def test_launch_plan_fits_shared_memory(n_fft):
    for hop in [*range(4, 4 * n_fft + 1, 4), 65536]:
        plan = tspec.launch_plan(n_fft, hop)
        assert plan.smem_bytes <= tspec.SMEM_LIMIT == 232_448
        assert plan.frame_tile in (1, 2, 4, 8, 16, 32)
        assert plan.smem_bytes == tspec._smem_bytes(n_fft, hop, plan.frame_tile)
        if plan.frame_tile < 32:  # the tile is the largest that fits
            assert tspec._smem_bytes(n_fft, hop, 2 * plan.frame_tile) > tspec.SMEM_LIMIT
    if n_fft == 256:
        assert tspec.launch_plan(256, 128) == (32, 68_744)


@pytest.mark.parametrize("n_fft, hop", [(260, 128), (256, 6), (2048, 128), (32, 16), (256, 0)])
def test_launch_plan_refuses_unsupported_geometry(n_fft, hop):
    with pytest.raises(ValueError):
        tspec.launch_plan(n_fft, hop)


def _kernel_fft(z, tw):
    """The kernel's Stockham passes over the last axis of ``z`` (M points):
    its radix plan, its butterfly and output indices and its twiddle-table
    indices; each radix-R butterfly is a plain DFT."""
    M = z.shape[-1]
    radices = [8, min(8, M // 8)] + ([M // 64] if M > 64 else [])
    ns = 1
    for R in radices:
        j = np.arange(M // R)[:, None]
        r = np.arange(R)[None, :]
        v = z[..., j + r * (M // R)] * tw[2 * ((j % ns) * r * (M // (ns * R)))]
        out = np.empty_like(z)
        out[..., (j // ns) * ns * R + j % ns + r * ns] = np.fft.fft(v, axis=-1)
        z = out
        ns *= R
    assert ns == M
    return z


@pytest.mark.parametrize("n_fft", tspec.N_FFTS)
def test_kernel_fft_plan_is_the_dft(n_fft):
    M = n_fft // 2
    _, twiddle = tspec.kernel_tables(n_fft)
    tw = twiddle[:, 0].astype(np.float64) + 1j * twiddle[:, 1]
    rng = np.random.default_rng(n_fft)
    z = rng.standard_normal((3, M)) + 1j * rng.standard_normal((3, M))
    ref = np.fft.fft(z, axis=-1)
    assert np.abs(_kernel_fft(z, tw) - ref).max() / np.abs(ref).max() < 1e-6
    # the exchange buffer's XOR swizzle permutes each frame's M slots
    i = np.arange(M)
    assert sorted(i ^ ((i >> 3) & 15)) == list(i)


@pytest.mark.parametrize("n_fft, hop, center", [(256, 128, True), (64, 32, True),
                                                (1024, 128, False), (512, 256, True)])
def test_half_length_split_matches_jax_stft_power(n_fft, hop, center):
    x = _input((2, 3001))
    window, twiddle = tspec.kernel_tables(n_fft)
    tw = twiddle[:, 0].astype(np.float64) + 1j * twiddle[:, 1]
    pad = n_fft // 2 if center else 0
    xp = np.pad(x, ((0, 0), (pad, pad)))
    T = 1 + (xp.shape[-1] - n_fft) // hop
    frames = np.stack([xp[:, t * hop : t * hop + n_fft] for t in range(T)], axis=1) * window
    M = n_fft // 2
    Z = _kernel_fft(frames[..., 0::2] + 1j * frames[..., 1::2].astype(np.float64), tw)
    k = np.arange(M + 1)
    zk, zm = Z[..., k % M], np.conj(Z[..., (M - k) % M])
    w = np.append(tw[:M], -1.0)  # e^{-2 pi i k / n_fft}, k = 0..M
    X = 0.5 * (zk + zm) - 0.5j * w * (zk - zm)
    got = np.swapaxes(np.abs(X) ** 2, -1, -2)
    ref = np.asarray(jstft.stft_power(jnp.asarray(x), n_fft=n_fft, hop=hop, center=center))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() / ref.max() < 1e-6


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
