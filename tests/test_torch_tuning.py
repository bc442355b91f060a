"""Port parity: the threshold-tuning path (``tuning/``: the sweep harness,
the spectral sweep whose decision counts are kernel K10 on the card, the
RoE sweep, the gradient fits and the named profiles) against the JAX
package's ``tuning/``, on the CPU, where every kernel runs its plain
version.

Tolerances against JAX:

  * the harness (combinations, the JSON resume files, the thread-pool
    twin): identical;
  * the five feature planes of ``spectral_threshold_features``: within 1e-4
    of each plane's maximum (the dB-domain bound of ROADMAP R4; the planes
    are flux ratios and the TD crest);
  * sweep predictions and confusion lists, on JAX's features and end to end
    on clips: identical; the decision counts on features with NaN and inf
    frames: identical to the rule written in NumPy;
  * the sweep on a mesh of four CPU entries: identical to the unsharded one;
  * the RoE sweep: ``rain_drop_count_mod`` identical to JAX's sweep and to
    the port's full engine combo by combo;
  * the gradient fits on JAX's features: see :func:`test_gradient_fit_on_jax_features`;
  * the tuned profile through the port's engine: 28/32 against the
    default's 24/32, per class as JAX pins it.
"""

import glob
import importlib
import json
import math

import numpy as np
import pytest
import torch

from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu.utils.corpus import make_hard_corpus

from audio_processing_tools_tpu_torch.ops import sweep as tsw
from audio_processing_tools_tpu_torch.parallel.mesh import make_mesh
from audio_processing_tools_tpu_torch.tuning import gradient as tgr

# the packages export functions named like these modules
jgs = importlib.import_module("audio_processing_tools_tpu.tuning.grid_search")
tgs = importlib.import_module("audio_processing_tools_tpu_torch.tuning.grid_search")

FS = 11162
PING = ((520, 1), (900, 0.5), (1600, 0.35), (2450, 0.25))
FULL_GRID = {  # every knob of the sweep, 2 x 2 x 2 x 2 x 2 x 3 x 2 = 192 combos
    "new_rain_primary_flux_min": [1.4, 2.2],
    "new_rain_mode1_flux_min": [2.0, 2.6],
    "new_rain_mode2_flux_min": [2.3, 2.9],
    "new_rain_mode3_flux_min": [2.5, 3.2],
    "new_rain_min_support_count": [1, 2],
    "td_gate_threshold": [2.0, 2.5, 3.75],
    "clip_rain_min_frames": [1, 3],
}


def _tuning_clips():
    """The clips of ``tests/test_tuning.py::test_grid_search_vmapped``."""
    rng = np.random.default_rng(1234)

    def rain(n):
        x = 0.005 * rng.standard_normal(n)
        for t0 in rng.integers(FS // 4, n - 2000, 20):
            k = np.arange(800)
            ping = sum(a * np.sin(2 * np.pi * f * k / FS) for f, a in PING)
            x[t0 : t0 + 800] += 0.5 * np.exp(-k / 60.0) * ping
        return x.astype(np.float32)

    n = FS * 2
    clips = np.stack([rain(n), rain(n), (0.02 * rng.standard_normal(n)).astype(np.float32),
                      (0.01 * rng.standard_normal(n)).astype(np.float32)])
    return clips, np.array([True, True, False, False])


def _harmonic_clips(seed, drops, noise):
    """Harmonic-ping rain and noise clips of 4 s
    (``tests/test_tuning.py:89-104, 176-192``)."""
    rng = np.random.default_rng(seed)
    n = FS * 4

    def harmonic_rain(count, fn=520.0):
        x = 0.003 * rng.standard_normal(n)
        k = np.arange(1000)
        ping = sum((1.0 / h) * np.sin(2 * np.pi * fn * h * k / FS) for h in range(1, 6))
        for t0 in rng.integers(0, n - 1200, count):
            x[t0 : t0 + 1000] += 0.6 * np.exp(-k / 80.0) * ping
        return x

    clips = [harmonic_rain(d) for d in drops] + [s * rng.standard_normal(n) for s in noise]
    labels = np.array([True] * len(drops) + [False] * len(noise))
    return np.stack(clips).astype(np.float32), labels


@pytest.fixture(scope="module")
def tuning_clips():
    return _tuning_clips()


@pytest.fixture(scope="module")
def hard():
    clips, labels, kinds = make_hard_corpus(seed=17, per_class=8)
    return clips, labels, kinds


@pytest.fixture(scope="module")
def hard_jax_features(hard):
    feats, base = jgs.spectral_threshold_features(hard[0], {"sample_rate": FS})
    return {k: np.asarray(v) for k, v in feats.items()}, base


@pytest.fixture(scope="module")
def hard_jax_sweep(hard):
    """JAX's ``grid_search_vmapped`` of ``FULL_GRID`` on the hard corpus."""
    return jgs.grid_search_vmapped(hard[0], hard[1], FULL_GRID, {"sample_rate": FS})


# ---------------------------------------------------------------------------
# the host harness


def _alg(calls):
    def alg(df, **params):
        calls.append(params)
        return 0.9, [1], [2], [], []

    return alg


@pytest.mark.parametrize("case", ["combinations", "serial resume", "parallel resume",
                                  "cross-package resume"])
def test_harness(case, tmp_path):
    grid = {"thr": [1, 2], "mode": ["x", "y", "z"]}
    if case == "combinations":
        got = tgs.generate_param_combinations(grid)
        assert got == jgs.generate_param_combinations(grid) and len(got) == 6
        assert tgs.replace_callables({"f": len, "l": [np.sum], "t": (max, 1)}) == \
            jgs.replace_callables({"f": len, "l": [np.sum], "t": (max, 1)})
        name = tgs.params_to_filename("k", "exp")
        assert name.startswith("exp_" + jgs.params_to_filename("k", "exp").split("_")[1])
        return
    calls = []
    if case == "cross-package resume":
        # results the JAX harness wrote are found by the port's resume
        jgs.grid_search(None, _alg([]), grid, "t1", str(tmp_path))
        tgs.grid_search(None, _alg(calls), grid, "t1", str(tmp_path))
        assert calls == []
        assert sorted(tgs.load_processed_param_ids(str(tmp_path / "t1_*.json"))) == \
            sorted(jgs.load_processed_param_ids(str(tmp_path / "t1_*.json")))
        return
    run = tgs.grid_search if case == "serial resume" else tgs.grid_search_parallel
    run(None, _alg(calls), grid, "t1", str(tmp_path))
    assert len(calls) == 6
    files = glob.glob(str(tmp_path / "t1_*.json"))
    assert len(files) == 6
    with open(files[0]) as f:
        saved = json.load(f)
    assert saved["overall_accuracy"] == 0.9 and saved["test_name"] == "t1"
    assert set(saved) == {"test_name", "parameters", "overall_accuracy", "tp_classifications",
                          "tn_classifications", "fp_classifications", "fn_classifications"}
    run(None, _alg(calls), grid, "t1", str(tmp_path))  # resume: nothing runs again
    assert len(calls) == 6
    assert len(tgs.load_processed_param_ids(str(tmp_path / "t1_*.json"))) == 6


# ---------------------------------------------------------------------------
# features and the sweep


def test_spectral_features_match_jax(hard, hard_jax_features, hard_jax_sweep):
    feats, base = tgs.spectral_threshold_features(hard[0], {"sample_rate": FS}, device="cpu")
    jfeats, jbase = hard_jax_features
    assert base == jbase
    for k in tsw.FEATURES:
        got, ref = feats[k].numpy(), jfeats[k]
        assert got.shape == ref.shape == (32, 175) and got.dtype == np.float32, k
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        assert err <= 1e-4, f"{k}: max|d|/max {err:.3e}"
    # decisions on the port's own features: the JAX sweep on JAX's
    combos = tgs.generate_param_combinations(FULL_GRID)
    assert tgs.sweep_from_features(feats, hard[1], combos, base) == hard_jax_sweep


def test_sweep_on_jax_features_matches_jax(hard, hard_jax_features, hard_jax_sweep):
    jfeats, base = hard_jax_features
    combos = tgs.generate_param_combinations(FULL_GRID)
    got = tgs.sweep_from_features(jfeats, hard[1], combos, base, device="cpu")
    ref = hard_jax_sweep
    assert len(got) == len(ref) == 192
    assert got == ref
    accs = {r["overall_accuracy"] for r in got}
    assert len(accs) > 3  # the grid moves the decisions


def _counts_numpy(f, pm, m1, m2, m3, msc, tdg):
    """``eval_combo``'s rule for one combo in NumPy float32: (B,) counts."""
    with np.errstate(invalid="ignore"):
        gate = (f["td_crest"] > np.float32(tdg)).astype(np.float32)
        v = [np.log1p(np.maximum(f[k] * gate, np.float32(0))) for k in ("primary", "s1", "s2", "s3")]
        hits = ((v[1] >= np.float32(m1)).astype(np.int32) + (v[2] >= np.float32(m2))
                + (v[3] >= np.float32(m3)))
        return ((v[0] >= np.float32(pm)) & (hits >= msc)).sum(-1)


def _counts_log_planes(f, pm, m1, m2, m3, msc, tdg):
    """The same counts the way K10 forms them (``csrc/sweep.cu``): the
    wrapper's log planes where the gate is open, 0 times them where closed."""
    logs = tsw.log_planes({k: torch.from_numpy(f[k]) for k in tsw.FEATURES}).numpy()
    with np.errstate(invalid="ignore"):
        gate = f["td_crest"] > np.float32(tdg)
        v = np.where(gate[None], logs, logs * np.float32(0))
        hits = ((v[1] >= np.float32(m1)).astype(np.int32) + (v[2] >= np.float32(m2))
                + (v[3] >= np.float32(m3)))
        return ((v[0] >= np.float32(pm)) & (hits >= msc)).sum(-1)


def test_decision_counts_nan_and_inf_frames(hard_jax_features):
    """A NaN feature never counts, whatever the gate; an inf feature counts
    only where the gate is open (inf * 0 is NaN), as in JAX."""
    f = {k: v.copy() for k, v in hard_jax_features[0].items()}
    rng = np.random.default_rng(5)
    f["primary"][3, :] = np.nan                       # a row of NaN frames
    f["s1"][5, rng.integers(0, 175, 40)] = np.nan
    f["s2"][7, rng.integers(0, 175, 40)] = np.inf
    f["primary"][9, rng.integers(0, 175, 40)] = np.inf
    f["td_crest"][11, rng.integers(0, 175, 40)] = np.nan
    combos = tgs.generate_param_combinations({**FULL_GRID, "new_rain_mode1_flux_min": [-1.0, 2.6],
                                              "td_gate_threshold": [-1.0, 2.5]})
    counts, cmin = tgs.combo_counts({k: torch.from_numpy(v) for k, v in f.items()}, combos)
    assert counts.shape == (len(combos), 32) and counts.dtype == np.int32
    for i, c in enumerate(combos):
        args = (c["new_rain_primary_flux_min"], c["new_rain_mode1_flux_min"],
                c["new_rain_mode2_flux_min"], c["new_rain_mode3_flux_min"],
                c["new_rain_min_support_count"], c["td_gate_threshold"])
        ref = _counts_numpy(f, *args)
        np.testing.assert_array_equal(counts[i], ref, err_msg=str(c))
        np.testing.assert_array_equal(_counts_log_planes(f, *args), ref, err_msg=str(c))
        assert counts[i, 3] == 0
    assert (cmin == [max(1, c["clip_rain_min_frames"]) for c in combos]).all()


@pytest.mark.parametrize("case", ["tuning clips", "hard corpus grid"])
def test_grid_search_vmapped_matches_jax(case, tuning_clips, hard):
    if case == "tuning clips":  # tests/test_tuning.py:49-77
        clips, labels = tuning_clips
        grid = {"new_rain_primary_flux_min": [1.8, 6.0], "clip_rain_min_frames": [3]}
    else:  # tests/test_accuracy_regression.py:295-313
        clips, labels = hard[0], hard[1]
        grid = {"new_rain_primary_flux_min": [1.0, 1.4, 1.8, 2.6, 4.0],
                "clip_rain_min_frames": [1, 3]}
    got = tgs.grid_search_vmapped(clips, labels, grid, base_params={"sample_rate": FS},
                                  device="cpu")
    assert got == jgs.grid_search_vmapped(clips, labels, grid, base_params={"sample_rate": FS})
    by = {(r["parameters"]["new_rain_primary_flux_min"],
           r["parameters"]["clip_rain_min_frames"]): r for r in got}
    if case == "tuning clips":
        assert by[(1.8, 3)]["overall_accuracy"] == 1.0
        assert by[(6.0, 3)]["overall_accuracy"] <= 0.5
        assert set(by[(1.8, 3)]["tp_classifications"]) == {0, 1}
    else:
        detuned = by[(4.0, 3)]["overall_accuracy"]
        assert detuned < 0.7 and max(r["overall_accuracy"] for r in got) >= detuned + 0.15


def test_sweep_on_a_mesh_equals_unsharded(hard_jax_features):
    """Combos split over a mesh of four CPU entries (padded from 10 to 12
    with the last combo) give the unsharded result
    (``tests/test_parallel.py::test_grid_search_vmapped_sharded_matches_unsharded``)."""
    jfeats, base = hard_jax_features
    labels = np.arange(32) % 2 == 0
    grid = {"new_rain_primary_flux_min": [1.0, 1.4, 1.8, 2.6, 4.0], "td_gate_threshold": [2.5, 3.5]}
    combos = tgs.generate_param_combinations(grid)
    one = tgs.sweep_from_features(jfeats, labels, combos, base, device="cpu")
    four = tgs.sweep_from_features(jfeats, labels, combos, base, mesh=make_mesh(4, device="cpu"),
                                   device="cpu")
    assert len(four) == len(one) == 10 and four == one


def test_roe_sweep_matches_jax_and_full_engine():
    """``roe_grid_search_vmapped`` equals JAX's sweep and the port's full
    engine (``roe_detect_batch``, equal to single clips by
    ``tests/test_torch_roe.py``) combo by combo (``tests/test_tuning.py:80-131``).  Each swept
    threshold is a float32 tensor, as under JAX's ``vmap``: the grid holds a
    ``min_drop_count`` whose float32 product with the 4 s check duration
    (3.0) and float64 product (3.000000004) straddle an integer, so the sweep
    takes ceil 3 where the full engine, like JAX's, takes 4."""
    from audio_processing_tools_tpu_torch.models import roe as troe

    clips, labels = _harmonic_clips(1234, (40, 12), (0.02, 0.004))
    base = {"sample_rate": FS, "check_duration": 4}
    straddle = 0.750000001
    assert math.ceil(straddle * 4) == 4 and math.ceil(np.float32(straddle) * np.float32(4)) == 3
    grid = {
        "harmonic_threshold": [[4.5, 4.0, 3.5, 3.5, 3.5, 3.5], [3.5, 3.0, 2.5, 2.5, 2.5, 2.5],
                               [6.0, 5.0, 4.5, 4.5, 4.5, 4.5]],
        "crest_thr": [3.75, 3.0],
        "min_drop_count": [0.3, 1.0, straddle],
    }
    got = tgs.roe_grid_search_vmapped(clips, labels, grid, base, device="cpu")
    ref = jgs.roe_grid_search_vmapped(clips, labels, grid, base)
    assert len(got) == len(ref) == 18
    assert got == ref
    feats = troe.roe_sweep_features(clips, device="cpu", **base)
    for r in got[:6]:  # the default harmonic thresholds: both crests, all three counts
        p = {**base, **r["parameters"]}
        full = troe.roe_detect_batch(clips, device="cpu", **p)["rain_drop_count_mod"]
        if p["min_drop_count"] != straddle:
            np.testing.assert_array_equal(full, r["rain_drop_count_mod"], err_msg=str(p))
        else:  # the full engine follows the float64 product
            cfg = feats["cfg"]
            kw = {k: p.get(k, getattr(cfg, k)) for k in tgs.ROE_SCALARS}
            eager = troe.roe_apply_thresholds(
                feats, harmonic_threshold=p["harmonic_threshold"], **kw).numpy()
            np.testing.assert_array_equal(eager, full)
    default = next(r for r in got if r["parameters"]["harmonic_threshold"][0] == 4.5
                   and r["parameters"]["crest_thr"] == 3.75
                   and r["parameters"]["min_drop_count"] == 0.3)
    assert default["overall_accuracy"] >= 0.75


# ---------------------------------------------------------------------------
# the gradient fits


def _roe_feature_tensors(jfeats, base):
    from audio_processing_tools_tpu_torch.models.roe import build_roe_config

    out = {k: torch.from_numpy(np.array(jfeats[k]))
           for k in ("nov1", "nopeak", "kurtosis", "crest_factor", "diff_energy")}
    out["cfg"] = build_roe_config(**{**base, "return_spectra": False})
    return out


@pytest.mark.parametrize("kind", ["spectral", "roe"])
def test_gradient_fit_on_jax_features(kind, hard, hard_jax_features):
    """The Adam fit's core on JAX's features against JAX's fit
    (``tests/test_tuning.py:134-212``): ``loss_history[0]`` within 1e-5
    relative, the first 20 losses within 1e-4 relative, the tuned
    thresholds within 0.05 absolute, ``accuracy``, ``init_accuracy`` and the
    confusion lists equal; and the assertions of the JAX tests.

    Observed (CPU, torch 2.13.0 against jax 0.9.0): spectral loss[0]
    identical, the first 20 losses within 1.2e-05 relative (the whole 250
    within 1.2e-05), thresholds within 4.8e-07; RoE loss[0] within 7.2e-08
    relative, the first 20 within 2.8e-06 (the whole 250 within 3.4e-05),
    thresholds within 4.5e-06.  The gaps are float32 rounding of two
    autograd and Adam implementations (optax's and torch's BCE forms, the
    temperature's pow).
    """
    from audio_processing_tools_tpu.models.roe import roe_sweep_features as jroe_features
    from audio_processing_tools_tpu.tuning import gradient as jgr

    if kind == "spectral":
        clips, labels = hard[0], hard[1]
        base = {"sample_rate": FS, "clip_rain_min_frames": 3}
        kw = dict(init={"new_rain_primary_flux_min": 4.0}, steps=250, lr=0.05)
        ref = jgr.gradient_tune_thresholds(clips, labels, base_params=base, **kw)
        jfeats, jbase = hard_jax_features  # the clip minimum does not enter the features
        got = tgr.fit_spectral_thresholds(jfeats, labels, {**jbase, **base}, device="cpu", **kw)
        thr = list(got["thresholds"].values())
        ref_thr = list(ref["thresholds"].values())
    else:
        clips, labels = _harmonic_clips(9, (40, 15, 25), (0.02, 0.004, 0.01))
        base = {"sample_rate": FS, "check_duration": 4}
        kw = dict(init={"harmonic_threshold": [9.0, 8.0, 7.0, 7.0, 7.0, 7.0],
                        "min_drop_count": 2.0, "kurtosis_thr": 8.0, "crest_thr": 8.0,
                        "diff_energy_thr": 20.0}, steps=250, lr=0.08)
        ref = jgr.roe_gradient_tune_thresholds(clips, labels, base_params=base, **kw)
        got = tgr.fit_roe_thresholds(_roe_feature_tensors(jroe_features(clips, **base), base),
                                     labels, base, **kw)
        flat = lambda t: [*t["harmonic_threshold"], *(t[k] for k in tgr.ROE_TUNABLE_SCALARS)]
        thr, ref_thr = flat(got["thresholds"]), flat(ref["thresholds"])
    lh, rlh = got["loss_history"], np.asarray(ref["loss_history"])
    assert lh.shape == rlh.shape == (250,) and np.all(np.isfinite(lh))
    assert abs(lh[0] - rlh[0]) <= 1e-5 * abs(rlh[0]), (lh[0], rlh[0])
    assert np.all(np.abs(lh[:20] - rlh[:20]) <= 1e-4 * np.abs(rlh[:20]))
    assert np.abs(np.subtract(thr, ref_thr)).max() <= 0.05, (thr, ref_thr)
    for key in ("accuracy", "init_accuracy", "overall_accuracy", "tp_classifications",
                "tn_classifications", "fp_classifications", "fn_classifications"):
        assert got[key] == ref[key], key
    assert set(got) == set(ref)
    if kind == "spectral":  # tests/test_tuning.py:152-165
        assert got["init_accuracy"] < 0.7
        assert got["accuracy"] >= got["init_accuracy"] + 0.15
        assert got["thresholds"]["new_rain_primary_flux_min"] < 3.5
    else:  # tests/test_tuning.py:205-212
        assert got["init_accuracy"] <= 0.5
        assert got["accuracy"] >= got["init_accuracy"] + 0.3
        assert got["thresholds"]["min_drop_count"] < 2.0
        assert len(got["thresholds"]["harmonic_threshold"]) == 6


# ---------------------------------------------------------------------------
# the named profiles


def test_profile_registry_roundtrip():
    """``tests/test_accuracy_regression.py:266-284`` on the port's copy, and
    the same overrides as JAX's."""
    from audio_processing_tools_tpu import tuning as jtun
    from audio_processing_tools_tpu_torch import tuning as ttun

    assert ttun.TUNED_ACCURACY_V1 in ttun.available_profiles()
    assert ttun.available_profiles() == jtun.available_profiles()
    base = {"sample_rate": FS, "detector": {"mode_bands": [(1, 2)]}}
    out = ttun.apply_profile(base, ttun.TUNED_ACCURACY_V1)
    assert "new_rain_primary_flux_min" not in base["detector"]
    assert out["detector"]["mode_bands"] == [(1, 2)]
    assert out["detector"]["td_gate_threshold"] == 3.75
    assert out["clip_rain_min_frames"] == 2
    assert out == jtun.apply_profile(base, jtun.TUNED_ACCURACY_V1)
    with pytest.raises(KeyError, match="unknown profile"):
        ttun.get_profile("nope")


def test_tuned_profile_through_the_port_engine(hard):
    """The tuned profile through the port's ``RainDetectorProcessor`` on the
    hard corpus: 28/32 against the default's 24/32, per class as
    ``tests/test_accuracy_regression.py:214-236`` pins it."""
    from audio_processing_tools_tpu_torch.models.spectral_noise import RainDetectorProcessor
    from audio_processing_tools_tpu_torch.tuning import TUNED_ACCURACY_V1, apply_profile

    clips, labels, kinds = hard
    default = {"sample_rate": FS, "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
               "classifier_only_mode": True, "clip_rain_min_frames": 3}
    proc = RainDetectorProcessor(device="cpu")

    def correct(params):
        pred = np.array([m["clip_is_rain"] for m, _ in proc.run_batch(clips, params)])
        return {kind: int(sum(pred[i] == labels[i] for i, k in enumerate(kinds) if k == kind))
                for kind in sorted(set(kinds))}

    d = correct(default)
    t = correct(apply_profile(default, TUNED_ACCURACY_V1))
    assert d == {"rain_faint": 7, "drizzle": 6, "rain_in_wind": 6, "wind_gusty": 5}
    assert t == {"rain_faint": 7, "drizzle": 8, "rain_in_wind": 6, "wind_gusty": 7}
    assert sum(d.values()) == 24 and sum(t.values()) == 28


def test_sweep_params_and_the_cuda_route_on_cpu_tensors():
    """Thresholds enter as float32 (a float64 grid rounded once), support
    counts as int32; the kernel's route takes only CUDA tensors and raises
    on CPU ones (no fallback)."""
    params = tsw.sweep_params(np.array([1.8, 2.0000001]), [2.6, 2.6], [2.6, 2.6], [3.0, 3.0],
                              np.array([2, 1], np.int64), [2.5, 3.75], "cpu")
    assert params.primary_flux_min.dtype == torch.float32
    assert params.primary_flux_min[1].item() == float(np.float32(2.0000001))
    assert params.min_support_count.dtype == torch.int32
    feats = {k: torch.zeros((2, 5)) for k in tsw.FEATURES}
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsw._decision_counts_cuda(feats, params)
    assert tsw.decision_counts(feats, params).tolist() == [[0, 0], [0, 0]]
