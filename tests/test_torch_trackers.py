"""Port parity: the two tracker recurrences (kernels K2 and K3 run their
plain loops on the CPU), their streaming carry forms and the causal
smoothers against the JAX package, and the kernels' launch plan and strided
input."""

import re
from pathlib import Path

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


# ---------------------------------------------------------------------------
# K2 and K3's launch plan (the kernels run only on the card; their plan, the
# strided band view and the plain loops they are held to run here)
# ---------------------------------------------------------------------------

KERNELS = ("noise_psd_track", "causal_low_quantile_baseline")
CSRC = Path(ttr.__file__).resolve().parent.parent / "csrc" / "trackers.cu"


def _c_constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", CSRC.read_text())
    assert m, name
    return int(m.group(1))


@pytest.mark.parametrize("kernel", KERNELS)
def test_tracker_launch_plan_fits_shared_memory(kernel):
    for lanes in (1, 2, 131, 132, 263, 264, 768, 4224, 9088, 2**20, 2**31 - 1):
        plan = ttr.tracker_launch_plan(kernel, lanes, 873)
        assert plan.smem_bytes <= ttr.SMEM_LIMIT == 232_448
        assert plan.lanes_per_block in (1, 2, 4, 8, 16, 32)
        assert plan.threads == ttr.TRACKER_THREADS and plan.threads % 32 == 0
        # the largest lanes per block that still gives the target grid
        if plan.lanes_per_block < ttr.TRACKER_MAX_LANES:
            assert -(-lanes // (2 * plan.lanes_per_block)) < ttr.TRACKER_TARGET_BLOCKS


def test_tracker_launch_plan_mirrors_the_c_launcher():
    """The plan's constants and shared-memory formula are the source's."""
    assert ttr.TRACKER_THREADS == _c_constant("kThreads")
    assert ttr.TRACKER_MAX_LANES == _c_constant("kMaxLanes")
    assert ttr.TRACKER_TARGET_BLOCKS == _c_constant("kTargetBlocks")
    assert ttr.TRACKER_FRAME_TILE == _c_constant("kFrameTile")
    m = re.search(r"return (\d+) \* \(size_t\)L \* kPitch \+ \(rain \? (\d+) \* \(size_t\)L \* "
                  r"kRainWords : 0\);", CSRC.read_text())
    tiles, rain = int(m.group(1)), int(m.group(2))
    pitch, words = ttr.TRACKER_FRAME_TILE + 1, ttr.TRACKER_FRAME_TILE // 4 + 1
    for lanes in (7, 768, 9088):
        k2 = ttr.tracker_launch_plan("noise_psd_track", lanes, 873)
        k3 = ttr.tracker_launch_plan("causal_low_quantile_baseline", lanes, 873)
        L = k2.lanes_per_block
        assert k2.smem_bytes == tiles * L * pitch + rain * L * words
        assert k3.smem_bytes == tiles * L * pitch


@pytest.mark.parametrize("lanes, T", [(1, 1), (7, 873), (15, 873), (497, 873), (765, 873),
                                      (768, 100), (9088, 1), (9088, 50), (9088, 64), (9088, 128),
                                      (9088, 873), (9301, 100), (100_000, 9)])
def test_tracker_launch_plan_covers_every_lane_and_frame(lanes, T):
    """The kernel's loops at this plan (blocks of lanes, tiles of frames,
    loader threads striding over a tile) reach each (lane, frame) once."""
    for kernel in KERNELS:
        plan = ttr.tracker_launch_plan(kernel, lanes, T)
        L, ft = plan.lanes_per_block, plan.frame_tile
        assert (plan.grid - 1) * L < lanes <= plan.grid * L
        assert (plan.n_tiles - 1) * ft < T <= plan.n_tiles * ft
        loaders = plan.threads - 32
        nl = np.minimum(L, lanes - L * np.arange(plan.grid))  # lanes of each block
        assert nl.sum() == lanes and (nl >= 1).all()
        for nl_b in set(nl.tolist()):
            for tile in range(plan.n_tiles):
                nt = min(ft, T - tile * ft)
                i = np.concatenate([np.arange(ld, nl_b * ft, loaders) for ld in range(loaders)])
                row, j = i // ft, i % ft
                kept = j < nt
                cells = row[kept] * ft + j[kept]
                assert len(cells) == nl_b * nt and len(np.unique(cells)) == nl_b * nt


def test_tracker_launch_plan_spreads_the_main_shapes_over_the_card():
    k2 = ttr.tracker_launch_plan("noise_psd_track", 128 * 71, 873)
    k3 = ttr.tracker_launch_plan("causal_low_quantile_baseline", 128 * 6, 873)
    assert k2.grid >= 132 and k3.grid >= 132
    assert (k2.lanes_per_block, k2.grid, k2.n_tiles) == (32, 284, 14)
    assert (k3.lanes_per_block, k3.grid, k3.n_tiles) == (4, 192, 14)


@pytest.mark.parametrize("kernel, lanes, T", [
    ("noise_psd_track", 0, 873), ("noise_psd_track", 9088, 0),
    ("causal_low_quantile_baseline", 2**31, 873), ("causal_low_quantile_baseline", 768, 2**31),
    ("gain_time_smooth", 9088, 873)])
def test_tracker_launch_plan_refuses_what_the_launcher_refuses(kernel, lanes, T):
    with pytest.raises(ValueError):
        ttr.tracker_launch_plan(kernel, lanes, T)


def test_rain_words_hold_every_byte_a_walker_reads():
    """K2 stages each clip's rain bytes of a tile as the aligned words that
    hold them; a walker reads byte ``shift + j`` of its row, where ``shift``
    is the misalignment of the clip's first byte.  At every alignment of the
    mask and every clip and tile, those bytes lie in the words staged."""
    ft = ttr.TRACKER_FRAME_TILE
    words = ft // 4 + 1
    for base in range(4):
        for T in (1, 50, 64, 873):
            for clip in range(5):
                shift = (base + clip * T) % 4
                for t0 in range(0, T, ft):
                    nt = min(ft, T - t0)
                    first = base + clip * T + t0
                    assert first % 4 == shift  # tiles start at multiples of 4
                    staged = sum(4 * k < first % 4 + nt for k in range(words))
                    assert shift + nt <= 4 * staged and staged <= words
                    # a batch of 8 frames reads words j0/4 .. j0/4 + 2
                    assert all(j0 // 4 + 2 < words for j0 in range(0, nt, 8))


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed_q", "adaptive_q"])
def test_noise_psd_track_reads_a_band_view_in_place(adaptive):
    """The engine hands K2 the band rows of the spectrogram as a view; the
    wrapper takes it as it is (clip and row strides), and the result equals
    the contiguous call and the JAX tracker."""
    rng = np.random.default_rng(7)
    P = (rng.gamma(1.0, 1.0, (3, 40, 150)) ** 2).astype(np.float32)
    is_rain = rng.random((3, 150)) < 0.3
    view = torch.from_numpy(P)[:, 5:22, :]
    assert not view.is_contiguous()
    assert ttr._band_strides(view) == (40 * 150, 150)
    params = ttr.make_psd_params(**_psd_args(adaptive))
    rain = torch.from_numpy(is_rain)
    got = ttr.noise_psd_track(view, rain, params).numpy()
    np.testing.assert_array_equal(got, ttr.noise_psd_track(view.contiguous(), rain, params).numpy())
    ref = np.asarray(jtr.noise_psd_track(jnp.asarray(P[:, 5:22, :]), jnp.asarray(is_rain),
                                         jtr.make_psd_params(**_psd_args(adaptive))))
    assert _rel(got, ref) <= 1e-5


def test_band_strides_refuse_frames_that_are_not_contiguous():
    P = torch.zeros(3, 150, 40)
    with pytest.raises(ValueError):
        ttr._band_strides(P.transpose(1, 2))  # (3, 40, 150) with frames 40 apart
    with pytest.raises(ValueError):
        ttr._band_strides(P[0])
    assert ttr._band_strides(P.transpose(1, 2)[..., :1]) == (6000, 1)  # one frame


def test_kernel_wrappers_raise_on_a_cpu_tensor():
    """The kernels' wrappers launch or raise: no fallback to the plain loop."""
    params = ttr.make_psd_params(**_psd_args(False))
    with pytest.raises(ValueError):
        ttr._noise_psd_track_cuda(torch.zeros(2, 3, 10), torch.zeros(2, 10, dtype=torch.bool),
                                  params)
    with pytest.raises(ValueError):
        ttr._baseline_cuda(torch.zeros(4, 10), ttr._baseline_consts(20.0, 87.2, 0.5, 0.0, 1.0))



# ---------------------------------------------------------------------------
# The carry forms of K2 and K3 (streaming)
# ---------------------------------------------------------------------------

CUTS = {"1-frame": [1] * 12, "4-frame": [4, 4, 4], "mixed": [1, 4, 174, 7]}


@pytest.mark.parametrize("cuts", list(CUTS), ids=list(CUTS))
@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed_q", "adaptive_q"])
def test_noise_psd_track_chunk_threads_the_carry(adaptive, cuts):
    """Chunks threaded through the carry give the bits of one call (and of
    the offline tracker), and the JAX chunk form's values and carry."""
    rng = np.random.default_rng(10)
    T = sum(CUTS[cuts])
    P = (rng.gamma(1.0, 1.0, (2, 9, T)) ** 2).astype(np.float32)
    rain = rng.random((2, T)) < 0.3
    params = ttr.make_psd_params(**_psd_args(adaptive))
    Pt, rt = torch.from_numpy(P), torch.from_numpy(rain)
    one, carry_one = ttr.noise_psd_track_chunk(Pt, rt, ttr.psd_carry_init(Pt[..., 0], params),
                                               params)
    np.testing.assert_array_equal(one.numpy(), ttr.noise_psd_track(Pt, rt, params).numpy())
    carry, parts, t0 = ttr.psd_carry_init(Pt[..., 0], params), [], 0
    for n in CUTS[cuts]:
        N, carry = ttr.noise_psd_track_chunk(Pt[..., t0 : t0 + n], rt[:, t0 : t0 + n], carry,
                                             params)
        parts.append(N)
        t0 += n
    assert torch.equal(torch.cat(parts, dim=-1), one)
    for a, b in zip(carry, carry_one):
        assert torch.equal(a, b)
    jparams = jtr.make_psd_params(**_psd_args(adaptive))
    for b in range(2):  # the JAX carry's flag is one per call
        ref, jcarry = jtr.noise_psd_track_chunk(
            jnp.asarray(P[b]), jnp.asarray(rain[b]), jtr.psd_carry_init(jnp.asarray(P[b, :, 0]),
                                                                        jparams), jparams)
        assert _rel(one[b].numpy(), np.asarray(ref)) <= 1e-5
        for got, want in zip(carry_one[:5], jcarry[:5]):
            assert _rel(got[b].numpy(), np.asarray(want)) <= 1e-5
        assert not bool(carry_one[5][b]) and not bool(jcarry[5])


@pytest.mark.parametrize("cuts", list(CUTS), ids=list(CUTS))
def test_causal_low_quantile_baseline_chunk_threads_the_carry(cuts):
    rng = np.random.default_rng(11)
    T = sum(CUTS[cuts])
    x = rng.gamma(0.5, 3.0, (3, 6, T)).astype(np.float32)
    x[0, 1, 2] = np.nan
    kw = dict(q_percent=20.0, samples_per_sec=11162 / 128, win_sec=0.5, floor=1.0)
    xt = torch.from_numpy(x)
    one, carry_one = ttr.causal_low_quantile_baseline_chunk(
        xt, ttr.baseline_carry_init(xt[..., 0], 1.0), **kw)
    np.testing.assert_array_equal(one.numpy(),
                                  ttr.causal_low_quantile_baseline(xt, **kw)[0].numpy())
    carry, parts, t0 = ttr.baseline_carry_init(xt[..., 0], 1.0), [], 0
    for n in CUTS[cuts]:
        b, carry = ttr.causal_low_quantile_baseline_chunk(xt[..., t0 : t0 + n], carry, **kw)
        parts.append(b)
        t0 += n
    assert torch.equal(torch.cat(parts, dim=-1), one)
    for a, b in zip(carry, carry_one):
        np.testing.assert_array_equal(a.numpy(), b.numpy())  # NaN where NaN
    ref, jcarry = jtr.causal_low_quantile_baseline_chunk(
        jnp.asarray(x), jtr.baseline_carry_init(jnp.asarray(x[..., 0]), 1.0), **kw)
    assert _rel(one.numpy(), np.asarray(ref)) <= 1e-5
    for got, want in zip(carry_one, jcarry):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_tracker_launch_plan_takes_every_streaming_chunk_length():
    """The live chunks are 4 to 174 frames: one partial tile up to three
    tiles, the last of them partial."""
    for T in (1, 4, 8, 63, 64, 65, 87, 174):
        for kernel, lanes in (("noise_psd_track", 64 * 71), ("causal_low_quantile_baseline", 64 * 6)):
            plan = ttr.tracker_launch_plan(kernel, lanes, T)
            assert plan.n_tiles == -(-T // ttr.TRACKER_FRAME_TILE)
            assert (plan.n_tiles - 1) * plan.frame_tile < T <= plan.n_tiles * plan.frame_tile


def test_carry_forms_raise_on_a_cpu_tensor():
    params = ttr.make_psd_params(**_psd_args(False))
    P = torch.zeros(2, 3, 10)
    with pytest.raises(ValueError):
        ttr._noise_psd_track_cuda(P, torch.zeros(2, 10, dtype=torch.bool), params,
                                  ttr.psd_carry_init(P[..., 0], params))
    x = torch.zeros(4, 10)
    with pytest.raises(ValueError):
        ttr._baseline_cuda(x, ttr._baseline_consts(20.0, 87.2, 0.5, 0.0, 1.0),
                           ttr.baseline_carry_init(x[..., 0], 1.0))
