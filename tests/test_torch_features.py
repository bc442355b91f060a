"""Port parity: TD features, raw spectral features and statistics against
the JAX package.  The JAX per-clip functions are vmapped over the batch;
the port takes the batch axis directly."""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import torch

from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu.ops import features_td as jtd
from audio_processing_tools_tpu.ops import stats as jst

from audio_processing_tools_tpu_torch.ops import features_spec as tsp
from audio_processing_tools_tpu_torch.ops import features_td as ttd
from audio_processing_tools_tpu_torch.ops import stats as tst

jsp = importlib.import_module("audio_processing_tools_tpu.ops.features_spec")
jstft = importlib.import_module("audio_processing_tools_tpu.ops.stft")

FS = 11162


def _clips():
    rng = np.random.default_rng(8)
    x = 0.01 * rng.standard_normal((3, FS))
    k = np.arange(600)
    ping = np.exp(-k / 50.0) * np.sin(2 * np.pi * 523.0 * k / FS)
    for s in range(500, FS - 700, 1400):
        x[0, s : s + 600] += 0.4 * ping
    x[2, 3000:3100] = 0.0  # a silent stretch
    return x.astype(np.float32)


def _rel(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


def test_td_features_match_jax_within_1e_4():
    x = _clips()
    kw = dict(fs=FS, frame_len=256, hop=128)
    ref = jax.vmap(lambda v: jtd.extract_td_features(
        v, operating_band=(400.0, 3500.0), mode_bands=DEFAULT_MODE_BANDS, **kw))(
        jnp.asarray(x))
    got = ttd.extract_td_features(torch.from_numpy(x), **kw)
    assert set(got) == set(ref)
    for name in got:
        r = np.asarray(ref[name])
        g = got[name].numpy()
        if g.ndim == 1:  # frame_times: one row, the JAX side has one per clip
            g = np.broadcast_to(g, r.shape)
        assert g.shape == r.shape, name
        assert _rel(g, r) <= 1e-4, (name, _rel(g, r))


def test_subframe_energy_matches_jax():
    x = _clips()
    for B, H in ((128, 128), (100, 50)):
        ref = jax.vmap(lambda v: jtd.subframe_energy(v, B, H))(jnp.asarray(x))
        got = ttd.subframe_energy(torch.from_numpy(x), B, H)
        assert _rel(got.numpy(), np.asarray(ref)) <= 1e-5


def test_raw_spectral_features_match_jax_within_1e_5():
    x = _clips()
    P = np.array(jstft.stft_power(jnp.asarray(x)))
    kw = dict(fs=FS, n_fft=256, operating_band=(400.0, 3500.0),
              low_band=(50.0, 200.0), mode_bands=DEFAULT_MODE_BANDS, eps=1e-9)
    ref = jax.vmap(lambda p: jsp.extract_raw_spectral_features(p, **kw))(jnp.asarray(P))
    got = tsp.extract_raw_spectral_features(torch.from_numpy(P), **kw)
    assert set(got) == set(ref) == set(tsp.RAW_SPECTRAL_FEATURE_NAMES)
    for name in got:
        assert _rel(got[name].numpy(), np.asarray(ref[name])) <= 1e-5, name


def test_stats_match_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 50, 256)).astype(np.float32)
    x[0, 0] = 0.0
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    for fisher, bias in ((False, False), (True, True)):
        assert _rel(tst.kurtosis(tx, fisher=fisher, bias=bias).numpy(),
                    np.asarray(jst.kurtosis(jx, fisher=fisher, bias=bias))) <= 1e-5
    assert _rel(tst.crest_factor(tx).numpy(), np.asarray(jst.crest_factor(jx))) <= 1e-6
    for q in (0.0, 0.37, 0.99, 1.0):
        np.testing.assert_array_equal(tst.quantile_linear(tx, q).numpy(),
                                      np.asarray(jst.quantile_linear(jx, q)))
    y = np.array([np.nan, np.inf, -np.inf, 1.5], np.float32)
    np.testing.assert_array_equal(tst.nan_to_num(torch.from_numpy(y)).numpy(),
                                  np.asarray(jst.nan_to_num(jnp.asarray(y))))
