"""Port parity: the two tracker recurrences (kernels K2 and K3 run their
plain loops on the CPU) and the causal smoothers against the JAX package."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from audio_processing_tools_tpu.ops import trackers as jtr

from audio_processing_tools_tpu_torch import _kernels
from audio_processing_tools_tpu_torch.ops import trackers as ttr


def _rel(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _psd_args(adaptive):
    return dict(cfg_q=0.25, win_sec=0.5, frames_per_sec=11162 / 128, ema_up=0.6,
                ema_down=0.95, eps=1e-9, noise_psd_max_ratio=0.8,
                adaptive_q_enable=adaptive, adaptive_q_min=0.1,
                adaptive_q_alpha=0.9)


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed_q", "adaptive_q"])
def test_noise_psd_track_matches_jax(adaptive):
    rng = np.random.default_rng(3)
    P = (rng.gamma(1.0, 1.0, (3, 17, 120)) ** 2).astype(np.float32)
    is_rain = rng.random((3, 120)) < 0.3
    assert ttr.make_psd_params(**_psd_args(adaptive)) == tuple(
        jtr.make_psd_params(**_psd_args(adaptive)))
    _kernels.reset_launches()
    got = ttr.noise_psd_track(torch.from_numpy(P), torch.from_numpy(is_rain),
                              ttr.make_psd_params(**_psd_args(adaptive))).numpy()
    assert _kernels.LAUNCHES["noise_psd_track"] == 0
    ref = np.asarray(jtr.noise_psd_track(jnp.asarray(P), jnp.asarray(is_rain),
                                         jtr.make_psd_params(**_psd_args(adaptive))))
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 1e-5


def test_causal_low_quantile_baseline_matches_jax_on_stacked_rows():
    rng = np.random.default_rng(4)
    # (clips, 1 + modes, T) flux rows as the classifier stacks them, with a
    # NaN and an inf to exercise the epilogue
    x = (rng.gamma(0.5, 3.0, (4, 6, 150))).astype(np.float32)
    x[0, 1, 40] = np.nan
    x[2, 3, 7] = np.inf
    kw = dict(q_percent=20.0, samples_per_sec=11162 / 128, win_sec=0.5,
              min_hist_sec=0.05, floor=1.0)
    _kernels.reset_launches()
    got, warm = ttr.causal_low_quantile_baseline(torch.from_numpy(x), **kw)
    assert _kernels.LAUNCHES["causal_low_quantile_baseline"] == 0
    ref, ref_warm = jtr.causal_low_quantile_baseline(jnp.asarray(x), **kw)
    assert _rel(got.numpy(), np.asarray(ref)) <= 1e-5
    np.testing.assert_array_equal(warm.numpy(), np.asarray(ref_warm))


def test_causal_time_mean_and_median_match_jax():
    rng = np.random.default_rng(5)
    X = rng.random((2, 9, 64)).astype(np.float32)
    for L in (1, 4, 5):
        assert _rel(ttr.causal_time_mean(torch.from_numpy(X), L).numpy(),
                    np.asarray(jtr.causal_time_mean(jnp.asarray(X), L))) <= 1e-5
        np.testing.assert_array_equal(
            ttr.causal_time_median(torch.from_numpy(X), L).numpy(),
            np.asarray(jtr.causal_time_median(jnp.asarray(X), L)))


def test_causal_time_mean_gives_the_jax_bits_where_the_running_sum_cancels():
    """Quiet rows after loud ones: the float32 running-sum difference is
    mostly rounding there, and the port's additions follow the JAX
    program's order, so the two agree bit for bit at every length."""
    rng = np.random.default_rng(6)
    for T in (5, 16, 17, 300, 873):
        X = (rng.gamma(0.3, 1.0, (3, 4, T)) ** 3).astype(np.float32)
        X[..., T // 2 :] *= 1e-6
        got = ttr.causal_time_mean(torch.from_numpy(X), 3).numpy()
        ref = np.asarray(jtr.causal_time_mean(jnp.asarray(X), 3))
        np.testing.assert_array_equal(got, ref)
