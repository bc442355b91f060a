"""Port parity: the batch orchestrator (``framework/batch.py``), its Parquet
spill (``framework/parquet_io.py``) and the evaluation harness, against the
JAX package's, on the corpus of ``tests/test_framework.py:23-45`` with the
port's processors on the CPU.

Equal DataFrames except the ``latency_s`` columns and the wall-time attrs:
integer, boolean and string columns identical, float values within 1e-5
relative (the noise-floor bound of ``tests/test_torch_suppressor.py``), float
arrays within 1e-5 of their maximum and the feature dump's within 1e-4 of its
maximum (the dB-domain bound of ROADMAP R4); the frame-class arrays of the
states identical."""

import functools
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from audio_processing_tools_tpu import evaluation as jeval
from audio_processing_tools_tpu.framework import (
    NoiseProcessor as JNoiseProcessor,
    RainProcessor as JRainProcessor,
    process_audio_batches_v2 as jrun,
)
from audio_processing_tools_tpu.models.roe import rain_detection_algo as jroe_algo
from audio_processing_tools_tpu.models.spectral_noise import (
    RainDetectorProcessor as JRainDetectorProcessor,
)
from audio_processing_tools_tpu.io.mark import write_mark_audio_file

from audio_processing_tools_tpu_torch import evaluation as teval
from audio_processing_tools_tpu_torch import framework as tframework
from audio_processing_tools_tpu_torch.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu_torch.framework import (
    NoiseProcessor,
    RainProcessor,
    process_audio_batches_v2,
    restore_state_df_from_parquet,
)
from audio_processing_tools_tpu_torch.framework.batch import run_batches
from audio_processing_tools_tpu_torch.models.roe import rain_detection_algo as troe_algo
from audio_processing_tools_tpu_torch.models.spectral_noise import RainDetectorProcessor
from audio_processing_tools_tpu_torch.utils.corpus import make_labeled_corpus, write_corpus_dir

FS = 11162
DUR = 2.0
DET = {"mode_bands": list(DEFAULT_MODE_BANDS)}
PARAMS = {"sample_rate": FS, "check_duration": DUR, "detector": DET, "clip_rain_min_frames": 3}
WALL = ("wall_time_sec", "files_per_sec_total")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """``tests/test_framework.py:23-45`` with its seed."""
    rng = np.random.default_rng(42)
    d = tmp_path_factory.mktemp("fwb") / "corpus"
    d.mkdir()
    k = np.arange(800)
    ping = sum(a * np.sin(2 * np.pi * f * k / FS)
               for f, a in [(520, 1), (900, 0.5), (1600, 0.35), (2450, 0.25)])
    for i in range(3):
        x = 0.005 * rng.standard_normal(int(FS * DUR))
        for t0 in rng.integers(FS // 4, int(FS * DUR) - 2000, 15):
            x[t0 : t0 + 800] += 0.5 * np.exp(-k / 60.0) * ping
        pcm = (np.clip(x, -1, 1) * 32767).astype(np.int16)
        (d / f"clip{i}_true.bin").write_bytes(write_mark_audio_file(pcm, sample_rate=FS))
    for i in range(3):
        pcm = (np.clip(0.02 * rng.standard_normal(int(FS * DUR)), -1, 1) * 32767).astype(np.int16)
        (d / f"quiet{i}_false.bin").write_bytes(write_mark_audio_file(pcm, sample_rate=FS))
    return d


def _same_value(a, b, where):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), where
        for key in b:
            _same_value(a[key], b[key], f"{where}/{key}")
        return
    if b is None or isinstance(b, str):
        assert a == b, where
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, where
    if b.dtype.kind == "f":
        assert a.dtype.kind == "f", where
        if b.ndim == 0:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=where)
            return
        bound = 1e-4 if where.startswith("features") else 1e-5
        assert np.array_equal(np.isnan(a), np.isnan(b)), where
        fin = ~np.isnan(b)
        assert np.abs(a[fin] - b[fin]).max(initial=0) <= bound * np.abs(b[fin]).max(initial=0), where
    else:
        np.testing.assert_array_equal(a, b, err_msg=where)


def _same_frame(got: pd.DataFrame, ref: pd.DataFrame, skip=()):
    keep = [c for c in ref.columns if "latency_s" not in c and c not in skip]
    assert sorted(c for c in got.columns if "latency_s" not in c and c not in skip) == sorted(keep)
    assert len(got) == len(ref)
    for c in keep:
        for i, (a, b) in enumerate(zip(got[c], ref[c])):
            _same_value(a, b, f"{c}[{i}]")
    assert _attrs(got) == _attrs(ref)


def _attrs(df: pd.DataFrame):
    """The attrs but the wall-time metrics, spilled files by name."""
    out = {k: v for k, v in df.attrs.items() if k not in WALL}
    if "saved_parquet_files" in out:
        out["saved_parquet_files"] = [Path(p).name for p in out["saved_parquet_files"]]
    return out


def _both(corpus, port_procs, jax_procs, **kw):
    kw = {"params_global": PARAMS, "InputType": "LocalPath",
          "test_vector_path": str(corpus), "batch_save_dir": None, **kw}
    return (process_audio_batches_v2(processors=port_procs, **kw),
            jrun(processors=jax_procs, **kw))


@pytest.mark.parametrize("device_batch", [True, False], ids=["device_batch", "per_file"])
def test_rain_detector_matches_jax(corpus, device_batch):
    (res, st), (jres, jst) = _both(
        corpus, [RainDetectorProcessor(name="rain_detector", device="cpu")],
        [JRainDetectorProcessor(name="rain_detector")],
        debug_params={"device_batch": device_batch})
    _same_frame(res, jres)
    assert st.keys() == jst.keys()
    _same_frame(st["rain_detector"], jst["rain_detector"])
    truth = res["file_key"].str.contains("true")
    assert (res["rain_detector__clip_is_rain"] == truth).all()
    assert res.attrs["num_files_processed_total"] == 6 and res.attrs["files_per_sec_total"] > 0


def test_noise_and_rain_processors_match_jax(corpus):
    params = {**PARAMS, "rain_drop_min_thr": 3, "return_spectra": False}
    (res, st), (jres, jst) = _both(
        corpus,
        [NoiseProcessor(name="noise", device="cpu"),
         RainProcessor(name="rain", fn=functools.partial(troe_algo, device="cpu"))],
        [JNoiseProcessor(name="noise"), JRainProcessor(name="rain", fn=jroe_algo)],
        params_global=params, max_files=4)
    assert {"rain__predicted", "rain__mismatch", "noise__mean_noise_floor_db"} <= set(res.columns)
    # RoE's frain_mean: within 1e-6, the bound of tests/test_torch_roe.py
    _same_frame(res, jres)
    for c in ("frame_class", "is_rain", "file_key"):
        for a, b in zip(st["noise"][c], jst["noise"][c]):
            np.testing.assert_array_equal(a, b)
    for c in ("rain_drop_count", "rain_peaks_count", "raining", "file_key"):
        for a, b in zip(st["rain"][c], jst["rain"][c]):
            np.testing.assert_array_equal(a, b)


def test_param_updates_chain_max_files_and_empty(corpus):
    seen = {}

    class A:
        name = "a"

        def run(self, audio, params):
            return {"v": 1}, {"_param_updates": {"injected": 42}}

    class B:
        name = "b"

        def run(self, audio, params):
            seen["injected"] = params.get("injected")
            return {"v": 2}, {}

    res, st = process_audio_batches_v2(
        processors=[A(), B()], params_global={"sample_rate": FS, "check_duration": DUR},
        InputType="LocalPath", test_vector_path=str(corpus), batch_save_dir=None, max_files=1)
    assert seen["injected"] == 42 and len(res) == 1 and res["b__v"].tolist() == [2]
    (res, st), (jres, jst) = _both(
        corpus, [RainDetectorProcessor(name="rain_detector", device="cpu")],
        [JRainDetectorProcessor(name="rain_detector")], max_files=0)
    assert res.empty and jres.empty and st["rain_detector"].empty
    assert res.attrs["num_files_processed_total"] == 0
    with pytest.raises(ValueError, match="max_files"):
        process_audio_batches_v2(processors=[A()], params_global=PARAMS, InputType="LocalPath",
                                 test_vector_path=str(corpus), max_files=-1, batch_save_dir=None)
    with pytest.raises(KeyError):
        process_audio_batches_v2(processors=[A()], params_global={"sample_rate": FS},
                                 InputType="LocalPath", test_vector_path=str(corpus))


def test_core_runs_without_pandas_dataframes(corpus):
    """``run_batches`` is the orchestrator's pandas-free core: the same rows
    the DataFrame is built from."""
    run = run_batches(processors=[RainDetectorProcessor(name="rain_detector", device="cpu")],
                      params_global=PARAMS, InputType="LocalPath",
                      test_vector_path=str(corpus), batch_save_dir=None)
    res, _ = process_audio_batches_v2(
        processors=[RainDetectorProcessor(name="rain_detector", device="cpu")],
        params_global=PARAMS, InputType="LocalPath", test_vector_path=str(corpus),
        batch_save_dir=None)
    assert run["num_files"] == 6 and run["saved_result_paths"] == []
    rows = sorted(run["results_rows"], key=lambda r: r["file_key"])
    assert [r["rain_detector__rain_frame_count"] for r in rows] == \
        res["rain_detector__rain_frame_count"].tolist()
    assert len(run["states_by_processor"]["rain_detector"]) == 6


def test_parquet_spill_matches_jax_and_restores(corpus, tmp_path):
    params = {**PARAMS, "dump_features": True, "detector": {**DET, "feature_dump_level": 1}}
    kw = {"params_global": params, "InputType": "LocalPath", "test_vector_path": str(corpus),
          "batch_size": 2, "max_batch_save": 2}
    _, st = process_audio_batches_v2(
        processors=[RainDetectorProcessor(name="rain_detector", device="cpu")],
        batch_save_dir=str(tmp_path / "port"), **kw)
    _, jst = jrun(processors=[JRainDetectorProcessor(name="rain_detector")],
                  batch_save_dir=str(tmp_path / "jax"), **kw)
    saved = st["rain_detector"].attrs["saved_parquet_files"]
    jsaved = jst["rain_detector"].attrs["saved_parquet_files"]
    assert [Path(p).name for p in saved] == [Path(p).name for p in jsaved]
    assert len(saved) == 3
    results = sorted(str(p) for p in (tmp_path / "port").glob("*results*"))
    jresults = sorted(str(p) for p in (tmp_path / "jax").glob("*results*"))
    assert len(results) == len(jresults) == 3
    for a, b in zip(results + saved, jresults + jsaved):
        got, ref = pd.read_parquet(a), pd.read_parquet(b)
        assert list(got.columns) == list(ref.columns)
        _same_frame(got, ref)
    _same_frame(restore_state_df_from_parquet(saved[0]),
                restore_state_df_from_parquet(jsaved[0]))


def test_state_rows_round_trip_through_parquet(tmp_path):
    """The 2-D ``features['normalized_mode_flux_by_mode']`` (the streaming
    detector's dump) spills as per-mode columns, the same columns and values
    as the JAX package's file, and ``restore_state_df_from_parquet`` reassembles it."""
    from audio_processing_tools_tpu.framework import parquet_io as jpq
    from audio_processing_tools_tpu_torch.framework import parquet_io as tpq

    rng = np.random.default_rng(5)
    rows = [{"file_key": f"k{i}", "frame_class": rng.integers(0, 3, 40).astype(np.int8),
             "score": np.float32(rng.random()), "cfg": {"n": np.int64(i), "f": (1.0, 2.0)},
             "features": {"normalized_mode_flux_by_mode": rng.random((5, 40)).astype(np.float32),
                          "rain_conf": rng.random(40).astype(np.float32)}}
            for i in (2, 0, 1)]
    assert tpq.make_state_rows_parquet_safe(rows)[0].keys() == \
        jpq.make_state_rows_parquet_safe(rows)[0].keys()
    paths = {}
    for name, mod in (("port", tpq), ("jax", jpq)):
        _, sp = mod.flush_saved_batches(results_rows=[], states_by_processor={"p": rows},
                                        save_dir=Path(tmp_path / name), save_prefix="d",
                                        flush_idx=1)
        paths[name] = sp["p"][0]
    assert Path(paths["port"]).name == Path(paths["jax"]).name
    got = restore_state_df_from_parquet(paths["port"])
    _same_frame(got, jpq.restore_state_df_from_parquet(paths["jax"]))
    assert list(got["file_key"]) == ["k0", "k1", "k2"]
    for i, row in zip((0, 1, 2), got.itertuples()):
        src = next(r for r in rows if r["file_key"] == f"k{i}")
        np.testing.assert_array_equal(row.features["normalized_mode_flux_by_mode"],
                                      src["features"]["normalized_mode_flux_by_mode"])


def test_end_to_end_flow_matches_jax(tmp_path):
    """The flow of ``examples/end_to_end.py``: corpus, orchestrator,
    ``evaluate_corpus`` with its CSVs."""
    clips, labels, kinds = make_labeled_corpus(seed=7, seconds=2.0)
    corpus_dir = tmp_path / "corpus"
    write_corpus_dir(str(corpus_dir), clips, labels, kinds)
    kw = {"params_global": {**PARAMS, "check_duration": 2.0}, "InputType": "LocalPath",
          "test_vector_path": str(corpus_dir), "batch_save_dir": None}
    res, _ = process_audio_batches_v2(
        processors=[RainDetectorProcessor(name="rain_detector", device="cpu")], **kw)
    jres, _ = jrun(processors=[JRainDetectorProcessor(name="rain_detector")], **kw)
    stats = teval.evaluate_corpus(res, out_dir=str(tmp_path / "port"))
    jstats = jeval.evaluate_corpus(jres, out_dir=str(tmp_path / "jax"))
    assert stats == jstats and stats["n"] == 24 and stats["accuracy"] == 1.0
    for name in ("results_fp.csv", "results_fn.csv", "test_results.csv"):
        got = pd.read_csv(tmp_path / "port" / name)
        ref = pd.read_csv(tmp_path / "jax" / name)
        _same_frame(got, ref)
    assert teval.evaluate_corpus(res.iloc[:0])["n"] == 0


def test_framework_exports_match_jax():
    from audio_processing_tools_tpu import framework as jframework

    assert tframework.__all__ == jframework.__all__
