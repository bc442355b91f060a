"""The port's last public surface against the JAX package: the ``edge``
import-path shims, ``find_peaks``, the block-int4 wire, ``mulaw_encode``
into a given array, the CAF re-containerizer and the ALAC routes.

Tolerances: names, masks, bytes and bits exact; prominences within 1e-6
(both are float32 differences of the same samples)."""

import importlib
import pkgutil
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import audio_processing_tools_tpu.edge as jedge
from audio_processing_tools_tpu.io import caf as jcaf
from audio_processing_tools_tpu.ops import wire as jw
from audio_processing_tools_tpu.ops.peaks import find_peaks as jfind_peaks

from audio_processing_tools_tpu_torch.io import alac as talac
from audio_processing_tools_tpu_torch.io import caf as tcaf
from audio_processing_tools_tpu_torch.ops import wire as tw
from audio_processing_tools_tpu_torch.ops.peaks import find_peaks

FIXTURES = Path(__file__).resolve().parent / "fixtures"
JAX_EDGE = sorted([jedge.__name__] + [m.name for m in pkgutil.walk_packages(
    jedge.__path__, jedge.__name__ + ".")])
PLAIN = (bool, int, float, str, bytes, tuple, list, dict, frozenset)


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_") and not isinstance(v, types.ModuleType)}


def test_every_jax_shim_is_found():
    assert len(JAX_EDGE) == 13


@pytest.mark.parametrize("name", JAX_EDGE)
def test_edge_shim_exports_the_jax_names(name):
    """The port's shim of the same path exports the JAX shim's names, each a
    class, a function or an equal constant."""
    ref = _public(importlib.import_module(name))
    got = _public(importlib.import_module(name.replace(
        "audio_processing_tools_tpu.", "audio_processing_tools_tpu_torch.", 1)))
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert isinstance(got[k], type) == isinstance(v, type), k
        assert callable(got[k]) == callable(v), k
        if isinstance(v, PLAIN):
            assert got[k] == v, k


def _peak_rows(seed: int):
    """Rows with ties and plateaus (small integers), and random floats."""
    rng = np.random.default_rng(seed)
    ties = rng.integers(0, 5, (6, 64)).astype(np.float32)
    ties[0, 10:20] = 7.0  # a wide plateau
    ties[1, :] = 3.0      # a flat row
    floats = rng.standard_normal((4, 97)).astype(np.float32)
    return [ties, floats]


@pytest.mark.parametrize("kw", [{}, {"height": 2.0}, {"prominence": 1.0},
                                {"prominence": 0.0, "height": 3.0}],
                         ids=["plain", "height", "prominence", "both"])
def test_find_peaks_matches_jax(kw):
    for x in _peak_rows(3):
        mask_j, prom_j = jfind_peaks(x, **kw)
        mask, prom = find_peaks(torch.from_numpy(x), **kw)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
        np.testing.assert_allclose(prom.numpy(), np.asarray(prom_j), rtol=0, atol=1e-6)


def _pcm(seed: int = 4):
    rng = np.random.default_rng(seed)
    pcm = (rng.standard_normal((3, 1024)) * 3000).astype(np.int16)
    pcm[0, :64] = 0          # a silent block: scale 0
    pcm[1, :64] = -32768     # the extreme blocks
    pcm[2, :64] = 32767
    return pcm


def test_block4_encode_matches_jax():
    pcm = _pcm()
    for got, ref in zip(tw.block4_encode(pcm), jw.block4_encode(pcm)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        tw.block4_encode(pcm[:, :100])


@pytest.mark.parametrize("decode", ["numpy", "tensor", "tensor_int16_scales"])
def test_block4_decode_gives_the_jax_bits(decode):
    """Every decode gives JAX's host decode bits, and JAX's device decode
    gives the same."""
    packed, scales = jw.block4_encode(_pcm())
    ref = jw.block4_decode_np(packed, scales)
    np.testing.assert_array_equal(np.asarray(jw.block4_decode(packed, scales)).view(np.int32),
                                  ref.view(np.int32))
    if decode == "numpy":
        got = tw.block4_decode_np(packed, scales)
    elif decode == "tensor":
        got = tw.block4_decode(torch.from_numpy(packed), torch.from_numpy(scales)).numpy()
    else:  # the uint16 scales as int16 bits (a wire without an unsigned type)
        got = tw.block4_decode(torch.from_numpy(packed),
                               torch.from_numpy(scales.view(np.int16))).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_mulaw_encode_into_a_given_array():
    pcm = _pcm()
    ref = jw.mulaw_encode(pcm)
    out = np.empty(pcm.shape, np.int8)
    assert tw.mulaw_encode(pcm, out=out) is out
    np.testing.assert_array_equal(out, ref)
    strided = np.zeros((3, 2048), np.int8)[:, ::2]
    tw.mulaw_encode(pcm, out=strided)
    np.testing.assert_array_equal(strided, ref)


@pytest.mark.parametrize("cut", ["mark_file", "payload", "truncated", "empty"])
def test_rearrange_bytes_matches_jax(cut):
    data = (FIXTURES / "alac_golden.bin").read_bytes()
    data = {"mark_file": data, "payload": data[40:], "truncated": data[: len(data) // 2],
            "empty": b""}[cut]
    assert tcaf.rearrange_bytes(data) == jcaf.rearrange_bytes(data)
    caf = tcaf.rearrange_bytes(data, sample_rate=8000.0, pcm_buffer_bytes=4096)
    assert caf == jcaf.rearrange_bytes(data, sample_rate=8000.0, pcm_buffer_bytes=4096)
    assert tcaf.find_caff_packet_table_start(caf) == jcaf.find_caff_packet_table_start(caf)


def test_alac_routes(monkeypatch):
    """The in-process route decodes the golden payload; the ffmpeg route
    runs only when asked, and raises where there is no ffmpeg."""
    payload = (FIXTURES / "alac_golden.bin").read_bytes()[40:]
    pcm = talac.decode_alac_to_pcm(payload)
    np.testing.assert_array_equal(pcm, np.load(FIXTURES / "alac_golden_pcm.npy"))
    np.testing.assert_array_equal(talac.decode_alac_to_pcm(payload, method="auto"), pcm)
    assert talac.have_alac_decoder()
    with pytest.raises(ValueError):
        talac.decode_alac_to_pcm(payload, method="bogus")
    monkeypatch.setenv("FFMPEG_PATH", "/nonexistent/ffmpeg")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(talac.os.path, "exists", lambda p: False)
    assert not talac.have_ffmpeg()
    with pytest.raises(FileNotFoundError):
        talac.decode_alac_to_pcm(payload, method="ffmpeg")
