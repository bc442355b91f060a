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


def _popcount32(w: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (as ``__popc``), by the SWAR sums on its
    unsigned value held in int64."""
    v = w.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _thresholds(params):
    """(C, 5) float32 NumPy: pm, m1, m2, m3, tdg, as ``k10_operands`` copies them."""
    return torch.stack([params.primary_flux_min, params.mode1_flux_min, params.mode2_flux_min,
                        params.mode3_flux_min, params.td_gate_threshold], 1).numpy()


def _k10_model(feats, params, S=None):
    """K10 (``csrc/sweep.cu``) modelled in torch on the CPU: the wrapper's
    slices and pair tables (``k10_plan``, or ``k10_tables`` for a given
    slice size), one bitmask of int32 words per (slice, row, clip) from the
    rule's own compares (``where(gate, L, 0 * L) >= thr``, frames past T
    zero), the count's word logic (the support words' xor and majority,
    ``hits >= msc`` picked from them, the primary word) as bitwise
    operations, and popcounts.  (C, B) int32."""
    logs = tsw.log_planes(feats)
    crest = feats["td_crest"]
    B, T = crest.shape
    C = params.primary_flux_min.shape[0]
    thr = _thresholds(params)
    if S is None:
        S, tables = tsw.k10_plan(thr, T, B)
    else:
        tables = tsw.k10_tables(thr, S)
    rows, offs, index = (torch.from_numpy(t) for t in tables)
    W = -(-T // 32)
    # a mask row for every table row: (n_slices, P, B, W), axis after axis
    axis = torch.zeros(rows.shape[:2], dtype=torch.long)
    for k in range(1, 4):
        axis += (torch.arange(rows.shape[1]) >= offs[:, k:k + 1]).long()
    L = logs[axis]  # (n_slices, P, B, T)
    tdg, thr_r = rows[..., 0, None, None], rows[..., 1, None, None]
    v = torch.where(crest > tdg, L, L * 0)
    bits = torch.nn.functional.pad(v >= thr_r, (0, 32 * W - T))
    weights = torch.tensor([1 << i for i in range(32)], dtype=torch.int64)
    masks = (bits.reshape(*bits.shape[:-1], W, 32).to(torch.int64) * weights).sum(-1)
    masks = torch.where(masks >= 2**31, masks - 2**32, masks).to(torch.int32)
    # each combo's four pass words: (4, C, B, W)
    combo = torch.arange(C)
    p = torch.stack([masks[combo // S, index[combo, k].long()] for k in range(4)])
    msc = params.min_support_count[:, None, None]
    s0 = p[1] ^ p[2] ^ p[3]
    s1 = (p[1] & p[2]) | (p[1] & p[3]) | (p[2] & p[3])
    ones = torch.tensor(-1, dtype=torch.int32)
    x = torch.where(msc == 1, ones, 0)
    ge = torch.where(msc == 2, s1, (s0 & s1) | (x & (s0 | s1)))
    rain = p[0] & (ge | torch.where(msc <= 0, ones, 0))
    counts = _popcount32(rain).sum(-1)
    return torch.where(params.min_support_count[:, None] >= 4, 0, counts).to(torch.int32)


def _random_params(rng, C):
    """A grid whose every threshold is distinct, some non-positive, support
    counts -1 to 4."""
    def f(lo, hi):
        return rng.uniform(lo, hi, C)

    return tsw.sweep_params(f(0.0, 4.0), f(-0.5, 3.5), f(-0.5, 3.5), f(-0.5, 4.0),
                            rng.integers(-1, 5, C), f(-0.5, 5.0), "cpu")


def test_k10_pair_tables_index_every_combo():
    """The wrapper's dedup: per slice and flux axis, the table holds the
    distinct (gate, flux) bit patterns of the slice's combos once each, and
    each combo's row on each axis holds its own pair; the plan's slices give
    the card enough blocks and fit the shared memory a block aims at."""
    rng = np.random.default_rng(13)
    combos = tgs.generate_param_combinations(FULL_GRID)
    grids = {"full grid": tgs.combo_sweep_params(combos, {}, "cpu"),
             "random": _random_params(rng, 300),
             "nan and signed zeros": tsw.sweep_params(
                 [0.0, -0.0, np.nan, np.nan, 0.0], [1.0] * 5, [np.nan, 2.0, np.nan, 2.0, -0.0],
                 [3.0] * 5, [2, 2, 0, 4, 3], [np.nan, 2.5, np.nan, 2.5, 2.5], "cpu")}
    for name, params in grids.items():
        thr = _thresholds(params)
        C = thr.shape[0]
        for S in (1, 7, 64, C):
            rows, offs, index = tsw.k10_tables(thr, S)
            n_slices = -(-C // S)
            P = rows.shape[1]
            assert rows.shape == (n_slices, P, 2) and rows.dtype == np.float32
            assert offs.shape == (n_slices, 5) and offs.dtype == np.int32
            assert index.shape == (n_slices * S, 4) and index.dtype == np.int32
            assert P == offs[:, 4].max() and (np.diff(offs, axis=1) >= 1).all()
            for c in range(n_slices * S):
                s, src = c // S, min(c, C - 1)  # the last slice is padded with the last combo
                for k in range(4):
                    r = int(index[c, k])
                    assert offs[s, k] <= r < offs[s, k + 1], (name, S, c, k)
                    want = np.array([thr[src, 4], thr[src, k]], np.float32).view(np.uint32)
                    assert (rows[s, r].view(np.uint32) == want).all(), (name, S, c, k)
            for s in range(n_slices):
                for k in range(4):
                    pairs = {tuple(rows[s, r].view(np.uint32)) for r in range(offs[s, k],
                                                                              offs[s, k + 1])}
                    assert len(pairs) == offs[s, k + 1] - offs[s, k], (name, S, s, k)
    sweep = _thresholds(tgs.combo_sweep_params(tgs.generate_param_combinations({
        "new_rain_primary_flux_min": [1.2, 1.5, 1.8, 2.1, 2.4, 2.7, 3.0, 4.0],
        "new_rain_mode1_flux_min": [2.0, 2.3, 2.6, 2.9], "new_rain_mode2_flux_min": [2.0, 2.3, 2.6, 2.9],
        "new_rain_mode3_flux_min": [2.5, 3.0], "new_rain_min_support_count": [1, 2],
        "td_gate_threshold": [2.0, 2.5, 3.0, 3.75], "clip_rain_min_frames": [1, 3]}), {}, "cpu"))
    S, (rows, offs, _) = tsw.k10_plan(sweep, 873, 128)
    assert (S, rows.shape[1]) == (2048, 56) and (offs[:, 4] == 56).all()
    distinct = _thresholds(_random_params(rng, 4096))
    S, (rows, _, _) = tsw.k10_plan(distinct, 873, 128)
    assert S == 64 and rows.shape[1] == 256
    assert tsw.k10_plan(sweep[:1], 873, 128)[0] == 1
    for T in (1, 873, tsw.K10_MAX_FRAMES):
        for thr_g in (sweep, distinct):
            S, (rows, _, _) = tsw.k10_plan(thr_g, T, 128)
            assert S * 128 >= tsw.K10_TARGET_BLOCKS or S == 1
            assert S == 1 or rows.shape[1] * tsw._k10_row_bytes(T) <= tsw.K10_SLICE_BYTES
    # at the most frames, 32 combos whose pairs are all distinct still fit a block
    assert 4 * 32 * tsw._k10_row_bytes(tsw.K10_MAX_FRAMES) <= tsw.K10_SMEM_BYTES
    assert 4 * 32 * tsw._k10_row_bytes(tsw.K10_MAX_FRAMES + 64) > tsw.K10_SMEM_BYTES


@pytest.mark.parametrize("case", ["full grid", "nan and inf frames", "random thresholds",
                                  "odd frame counts"])
def test_k10_bit_sliced_model_equals_the_plain_counts(case, hard, hard_jax_features,
                                                      hard_jax_sweep):
    """The bit-sliced design of K10, modelled on the CPU, gives
    ``_decision_counts_plain``'s integers, and on JAX's features the JAX
    sweep's predictions (``eval_combo``)."""
    f = {k: v.copy() for k, v in hard_jax_features[0].items()}
    rng = np.random.default_rng(5)
    combos = tgs.generate_param_combinations(FULL_GRID)
    params = tgs.combo_sweep_params(combos, {}, "cpu")
    slices = [None, 7, 192]
    if case == "nan and inf frames":  # test_decision_counts_nan_and_inf_frames's frames
        f["primary"][3, :] = np.nan
        f["s1"][5, rng.integers(0, 175, 40)] = np.nan
        f["s2"][7, rng.integers(0, 175, 40)] = np.inf
        f["primary"][9, rng.integers(0, 175, 40)] = np.inf
        f["td_crest"][11, rng.integers(0, 175, 40)] = np.nan
        combos = tgs.generate_param_combinations({
            **FULL_GRID, "new_rain_mode1_flux_min": [-1.0, 2.6],
            "td_gate_threshold": [-1.0, 2.5], "new_rain_min_support_count": [0, 1, 2, 3, 4]})
        params = tgs.combo_sweep_params(combos, {}, "cpu")
    elif case == "random thresholds":
        params = _random_params(rng, 500)
        slices = [None, 64, 129]
    elif case == "odd frame counts":
        params = _random_params(rng, 200)
        f = {k: np.concatenate([v, v[:, :50]], 1)[:, :203] for k, v in f.items()}  # 203 frames
    feats = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in f.items()}
    ref = tsw._decision_counts_plain(feats, params)
    for S in slices:
        assert torch.equal(_k10_model(feats, params, S), ref), (case, S)
    for t in (1, 31, 33):
        short = {k: v[:, :t].contiguous() for k, v in feats.items()}
        assert torch.equal(_k10_model(short, params), tsw._decision_counts_plain(short, params))
    if case == "full grid":
        labels = hard[1]
        counts = _k10_model(feats, params).numpy()
        cmin = np.array([max(1, c["clip_rain_min_frames"]) for c in combos])
        got = [{"parameters": c, **tgs._confusion(counts[i] >= cmin[i], labels)}
               for i, c in enumerate(combos)]
        assert got == hard_jax_sweep


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
