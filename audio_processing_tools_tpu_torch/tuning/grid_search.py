"""Grid search with resume semantics, and the device threshold sweeps.

Counterpart of ``audio_processing_tools_tpu/tuning/grid_search.py``:

  * the host harness (``:27-138``): combinations, the JSON resume files,
    :func:`grid_search` (serial) and :func:`grid_search_parallel` (a thread
    pool), unchanged in meaning;
  * :func:`spectral_threshold_features` (``:141-173``): the
    threshold-independent front end once (prefilter, K1, the K2 tracker, the
    K3 baseline: the classifier-only engine with its detector debug);
  * :func:`grid_search_vmapped` (``:176-268``): every combo of a decision-
    threshold grid scored on those features.  JAX vmaps ``eval_combo`` over
    the combos in one compiled program; here the combos are tensors and the
    counts come from :func:`~audio_processing_tools_tpu_torch.ops.sweep.
    decision_counts` (kernel K10 on the card, one launch a sweep).
    :func:`sweep_from_features` is its core and takes the features as
    tensors or NumPy arrays;
  * :func:`roe_grid_search_vmapped` (``:271-349``): the legacy RoE
    classifier's sweep, RoE's front end once (K1 once, K4 twice) and then
    ``roe_apply_thresholds`` combo by combo, each threshold a float32
    tensor as under JAX's ``vmap``.

Every entry point runs on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import datetime as dt
import glob
import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from itertools import product
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from audio_processing_tools_tpu_torch.ops.sweep import FEATURES, decision_counts, sweep_params


def generate_param_combinations(param_grid: Dict[str, list]) -> List[Dict[str, Any]]:
    return [dict(zip(param_grid.keys(), c)) for c in product(*param_grid.values())]


def replace_callables(obj):
    """Replace callables by their names for JSON serialization."""
    if isinstance(obj, dict):
        return {k: replace_callables(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [replace_callables(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(replace_callables(v) for v in obj)
    if callable(obj):
        return obj.__name__
    return obj


def load_processed_param_ids(pattern: str) -> List[str]:
    """Hash keys of already-saved results (resume support)."""
    ids = []
    for filename in glob.glob(pattern):
        with open(filename, "r") as f:
            result = json.load(f)
        ids.append(str(tuple(result["parameters"].items())))
    return ids


def save_result_to_disk(result: Dict[str, Any], filename: str) -> None:
    result = replace_callables(result)
    with open(filename, "w") as f:
        json.dump(result, f, indent=4)


def params_to_filename(params_key: str, alg_identifier: str) -> str:
    params_hash = hashlib.sha256(params_key.encode()).hexdigest()
    stamp = dt.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    return f"{alg_identifier}_{params_hash}_{stamp}.json"


def _run_and_save(params_key, audio_df, params, identifier, results_dir,
                  custom_alg) -> None:
    result_tuple = custom_alg(audio_df, **params)
    result = {
        "test_name": identifier,
        "parameters": params,
        "overall_accuracy": result_tuple[0],
        "tp_classifications": result_tuple[1],
        "tn_classifications": result_tuple[2],
        "fp_classifications": result_tuple[3],
        "fn_classifications": result_tuple[4],
    }
    save_result_to_disk(
        result, os.path.join(results_dir, params_to_filename(params_key, identifier))
    )


# name parity with the reference's per-combo runner (``grid_search.py:120``)
execute_algorithm = _run_and_save


def grid_search(audio_df, custom_alg: Callable, param_grid: Dict[str, list],
                test_name: str, results_dir: str) -> None:
    """Serial cartesian sweep with JSON resume (``grid_search.py:51-117``)."""
    os.makedirs(results_dir, exist_ok=True)
    existing = load_processed_param_ids(
        os.path.join(results_dir, f"{test_name}_*.json")
    )
    for params in generate_param_combinations(param_grid):
        params_key = str(tuple(params.items()))
        if str(replace_callables(tuple(params.items()))) in existing or params_key in existing:
            print(f"Skipping already processed combination: {params}")
            continue
        _run_and_save(params_key, audio_df, params, test_name, results_dir,
                      custom_alg)
        print(f"Processed and saved: {params}")


def grid_search_parallel(audio_df, custom_alg: Callable,
                         param_grid: Dict[str, list],
                         experiment_identifier: str,
                         results_dir: str = "./parameter_search_results/",
                         max_workers: int | None = None) -> None:
    """Parallel sweep (thread pool: device work releases the GIL) with the
    reference's resume semantics (``grid_search.py:153-225``)."""
    os.makedirs(results_dir, exist_ok=True)
    existing = load_processed_param_ids(
        os.path.join(results_dir, f"{experiment_identifier}_*.json")
    )
    tasks = []
    for params in generate_param_combinations(param_grid):
        key_for_check = str(replace_callables(tuple(params.items())))
        params_key = str(tuple(params.items()))
        if key_for_check in existing:
            print(f"Already Processed {params}, skipping")
            continue
        tasks.append((params_key, params))

    t0 = time.time()
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        futures = {
            ex.submit(_run_and_save, pk, audio_df, p, experiment_identifier,
                      results_dir, custom_alg): p
            for pk, p in tasks
        }
        for fut in as_completed(futures):
            params = futures[fut]
            try:
                fut.result()
            except Exception as e:
                print(f"Error processing parameter combination {params}: {e}")
                raise
    print(f"Grid search completed in {time.time() - t0:.2f} seconds.")


def spectral_threshold_features(clips, base_params: Dict[str, Any] | None = None,
                                device: str | torch.device = "cuda"):
    """Run the threshold-independent front end once; return flux features.

    Shared by :func:`grid_search_vmapped` and
    :func:`~audio_processing_tools_tpu_torch.tuning.gradient.gradient_tune_thresholds`:
    the costly part (prefilter, K1, the PSD tracker K2, the flux baseline
    K3) does not depend on the decision thresholds, so both sweep styles
    reuse one engine pass (``grid_search.py:141-173``).  ``clips`` (B, N):
    NumPy is placed on ``device``; a tensor runs where it lies.  Returns
    ``(feats, base)``, ``feats`` holding ``primary``/``s1``/``s2``/``s3``/
    ``td_crest`` float32 tensors of shape (B, T) on that device.
    """
    from audio_processing_tools_tpu_torch.config import DEFAULT_MODE_BANDS, build_noise_config
    from audio_processing_tools_tpu_torch.models.spectral_noise import SpectralNoiseEngine

    base = dict(base_params or {})
    base.setdefault("detector", {"mode_bands": list(DEFAULT_MODE_BANDS)})
    base.setdefault("classifier_only_mode", True)
    base.setdefault("return_detector_debug", True)
    sr = int(base.get("sample_rate", 11162))

    eng = SpectralNoiseEngine(build_noise_config(sr, base), device=device)
    if not torch.is_tensor(clips):
        clips = np.asarray(clips, np.float32)
    out = eng.process_batch(clips, sr=sr)
    dd = out["det_debug"]
    feats = {
        "primary": dd["primary_mode_flux"],
        "s1": dd["support_mode_flux_1"],
        "s2": dd["support_mode_flux_2"],
        "s3": dd["support_mode_flux_3"],
        "td_crest": dd["td_crest_factor"],
    }
    return {k: v.to(torch.float32).contiguous() for k, v in feats.items()}, base


def as_feature_tensors(feats: Dict[str, Any], device: str | torch.device = "cuda"
                       ) -> Dict[str, torch.Tensor]:
    """The five feature planes as float32 tensors: tensors stay where they
    lie, NumPy arrays are placed on ``device``."""
    return {k: (feats[k] if torch.is_tensor(feats[k])
                else torch.as_tensor(np.array(feats[k], np.float32), device=torch.device(device))
                ).to(torch.float32).contiguous() for k in FEATURES}


def _confusion(pred: np.ndarray, labels: np.ndarray) -> Dict[str, Any]:
    tp = np.flatnonzero(pred & labels).tolist()
    tn = np.flatnonzero(~pred & ~labels).tolist()
    fp = np.flatnonzero(pred & ~labels).tolist()
    fn = np.flatnonzero(~pred & labels).tolist()
    return {"overall_accuracy": 1 - (len(fp) + len(fn)) / max(len(labels), 1),
            "tp_classifications": tp, "tn_classifications": tn,
            "fp_classifications": fp, "fn_classifications": fn}


def _knob(c: Dict[str, Any], base: Dict[str, Any], key: str, default) -> float:
    """A sweep knob as ``grid_search.py:219-220`` reads it: the combo's
    value, else ``base``'s, else the engine default."""
    return float(c.get(key, base.get(key, default)))


def combo_sweep_params(combos: List[Dict[str, Any]], base: Optional[Dict[str, Any]],
                       device: str | torch.device):
    """The decision rule's per-combo parameters (``grid_search.py:222-228``):
    the thresholds float32, the support count int32, on ``device``."""
    base = dict(base or {})
    return sweep_params(
        [_knob(c, base, "new_rain_primary_flux_min", 1.8) for c in combos],
        [_knob(c, base, "new_rain_mode1_flux_min", 2.6) for c in combos],
        [_knob(c, base, "new_rain_mode2_flux_min", 2.6) for c in combos],
        [_knob(c, base, "new_rain_mode3_flux_min", 3.0) for c in combos],
        [int(_knob(c, base, "new_rain_min_support_count", 2)) for c in combos],
        [_knob(c, base, "td_gate_threshold", 2.5) for c in combos], device)


def combo_counts(feats: Dict[str, torch.Tensor], combos: List[Dict[str, Any]],
                 base: Optional[Dict[str, Any]] = None, mesh=None):
    """``(counts (C, B) int32, cmin (C,))`` on the host: the decision rule's
    rain-frame counts for every combo (:func:`combo_sweep_params`) and the
    clip rule's ``max(1, clip_rain_min_frames)``.  With ``mesh`` (a
    :class:`~audio_processing_tools_tpu_torch.parallel.mesh.Mesh`), the
    combos are padded with the last one to a multiple of the mesh's size and
    split in order over the entries of its first axis; each entry's device
    holds one copy of the features and its block runs there.  The pad rows
    are dropped."""
    base = dict(base or {})
    n_combos = len(combos)
    padded, entries = combos, [feats["td_crest"].device]
    if mesh is not None and combos:
        padded = combos + [combos[-1]] * ((-n_combos) % mesh.size)
        entries = mesh.axis_devices(mesh.axis_names[0])
    per = len(padded) // len(entries)
    copies: Dict[torch.device, Dict[str, torch.Tensor]] = {}
    outs = []
    for i, dev in enumerate(entries):
        if dev not in copies:
            copies[dev] = {k: v.to(dev) for k, v in feats.items()}
        block = padded[i * per : (i + 1) * per]
        outs.append(decision_counts(copies[dev], combo_sweep_params(block, base, dev)).cpu().numpy())
    cmin = np.asarray([max(1, int(_knob(c, base, "clip_rain_min_frames", 1))) for c in combos],
                      np.int64)
    return np.concatenate(outs)[:n_combos], cmin


def sweep_from_features(feats: Dict[str, Any], labels, combos: List[Dict[str, Any]],
                        base: Optional[Dict[str, Any]] = None, mesh=None,
                        device: str | torch.device = "cuda") -> List[Dict[str, Any]]:
    """The core of :func:`grid_search_vmapped`: score every combo of
    ``combos`` on precomputed features (tensors, or NumPy arrays placed on
    ``device``).  One result dict per combo, JAX's keys: ``parameters``,
    ``overall_accuracy`` and the four confusion index lists."""
    counts, cmin = combo_counts(as_feature_tensors(feats, device), combos, base, mesh)
    predicted = counts >= cmin[:, None]
    labels = np.asarray(labels, bool)
    return [{"parameters": combo, **_confusion(predicted[i], labels)}
            for i, combo in enumerate(combos)]


def grid_search_vmapped(clips, labels, threshold_grid: Dict[str, list],
                        base_params: Dict[str, Any] | None = None, mesh=None,
                        device: str | torch.device = "cuda") -> List[Dict[str, Any]]:
    """Device sweep of the spectral detector's decision thresholds.

    The front end runs once (:func:`spectral_threshold_features`); every
    combo of ``threshold_grid`` is then scored by the decision rule (K10 on
    the card).  Knobs: ``new_rain_primary_flux_min``,
    ``new_rain_mode1/2/3_flux_min``, ``new_rain_min_support_count``,
    ``td_gate_threshold``, ``clip_rain_min_frames``.  Structural parameters
    (``mode_bands``, ``n_fft``, ``hop``, prefilter settings) belong in
    ``base_params`` (one front end per setting) or in :func:`grid_search`.

    ``mesh``: an optional port ``Mesh``; the combo axis is split over the
    entries of its first axis (padded to a multiple of the mesh's size, pad
    rows dropped), and the result equals the unsharded one.

    Returns one result dict (accuracy + confusion lists) per combo.
    """
    feats, base = spectral_threshold_features(clips, base_params, device=device)
    return sweep_from_features(feats, labels, generate_param_combinations(threshold_grid),
                               base, mesh)


ROE_SCALARS = ("kurtosis_thr", "crest_thr", "diff_energy_thr", "min_drop_count",
               "rain_drop_min_thr", "rain_drop_max_thr", "rain_peaks_min_thr",
               "rain_peaks_max_thr")


def roe_grid_search_vmapped(clips, labels, threshold_grid: Dict[str, list],
                            base_params: Dict[str, Any] | None = None,
                            device: str | torch.device = "cuda") -> List[Dict[str, Any]]:
    """Threshold sweep of the legacy RoE classifier (``grid_search.py:271-349``).

    The front end (band-pass, STFT, SNR novelties, peak search, TD pulse
    features) runs once per clip (``roe_sweep_features``: K1 once and K4
    twice on the card); every combo is then re-evaluated by
    ``roe_apply_thresholds``.  Sweepable knobs:
    ``harmonic_threshold`` (length-6 lists), ``kurtosis_thr``, ``crest_thr``,
    ``diff_energy_thr``, ``min_drop_count``, ``rain_drop_min_thr``,
    ``rain_drop_max_thr``, ``rain_peaks_min_thr``, ``rain_peaks_max_thr``;
    structural parameters (bands, sample rate, handle_fp/fn) belong in
    ``base_params``.  Each result carries ``rain_drop_count_mod`` per clip.
    The combos run one after another (a few dozen small launches each): RoE
    grids are small beside the front end's ~1,260 launches.
    """
    from audio_processing_tools_tpu_torch.models.roe import (
        roe_apply_thresholds,
        roe_sweep_features,
    )

    base = dict(base_params or {})
    if not torch.is_tensor(clips):
        clips = np.asarray(clips, np.float32)
    feats = roe_sweep_features(clips, device=device, **base)
    cfg, dev = feats["cfg"], feats["nov1"].device
    combos = generate_param_combinations(threshold_grid)

    def get(c, name):
        return c.get(name, base.get(name, getattr(cfg, name)))

    # combo by combo, each threshold a float32 tensor as under JAX's vmap: a
    # min_drop_count takes the float32 product with the check duration
    harm = torch.as_tensor(np.asarray([get(c, "harmonic_threshold") for c in combos],
                                      np.float32).reshape(-1, 6), device=dev)
    scalars = {name: torch.as_tensor(np.asarray([float(get(c, name)) for c in combos],
                                                np.float32), device=dev)
               for name in ROE_SCALARS}
    mods = [roe_apply_thresholds(feats, harmonic_threshold=harm[i],
                                 **{name: v[i] for name, v in scalars.items()})
            for i in range(len(combos))]
    mods = (torch.stack(mods).cpu().numpy() if mods
            else np.zeros((0, feats["nov1"].shape[0]), np.int32))
    predicted = mods > 0
    labels = np.asarray(labels, bool)
    return [{"parameters": combo, **_confusion(predicted[i], labels),
             "rain_drop_count_mod": mods[i].tolist()} for i, combo in enumerate(combos)]
