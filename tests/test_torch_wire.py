"""Port parity: the mu-law wire of the live server against the JAX
package's ``ops/wire.py``."""

import numpy as np
import pytest
import torch

from audio_processing_tools_tpu.ops import wire as jw

from audio_processing_tools_tpu_torch.ops import wire as tw

CODES = np.arange(-128, 128).astype(np.int8)


def test_encode_is_the_jax_table_for_every_int16():
    pcm = np.arange(-32768, 32768).astype(np.int16)
    np.testing.assert_array_equal(tw.mulaw_encode(pcm), jw.mulaw_encode(pcm))
    np.testing.assert_array_equal(tw.mulaw_encode(pcm[:10].reshape(2, 5)),
                                  jw.mulaw_encode(pcm[:10]).reshape(2, 5))


@pytest.mark.parametrize("decode", ["numpy", "tensor"])
def test_decode_is_the_jax_numpy_twin_bit_for_bit(decode):
    """Both decoders give the JAX package's host decode bits for every code;
    the tensor decode is within 1e-7 of the JAX device decode, as the JAX
    package holds its own device decode to its host twin."""
    ref = jw.mulaw_decode_np(CODES)
    if decode == "numpy":
        got = tw.mulaw_decode_np(CODES)
    else:
        got = tw.mulaw_decode(torch.from_numpy(CODES)).numpy()
        np.testing.assert_allclose(got, np.asarray(jw.mulaw_decode(CODES)), atol=1e-7)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_round_trip_quality():
    rng = np.random.default_rng(1)
    x = np.clip(0.3 * rng.standard_normal(20000), -1, 1)
    pcm = (x * 32767).astype(np.int16)
    xd = tw.mulaw_decode(torch.from_numpy(tw.mulaw_encode(pcm))).numpy()
    xf = pcm.astype(np.float32) / 32768.0
    assert 10 * np.log10(np.mean(xf ** 2) / np.mean((xd - xf) ** 2)) > 35.0
