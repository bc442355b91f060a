"""Port parity: the ETL module (``transform.py``).

  * The pure DataFrame helpers equal the JAX package's (``pandas.testing``).
  * The classification ETL on a fake DB and fetch, as
    ``tests/test_dsd_transform.py:113-195``, with the port's modules
    patched: columns, the version stamp, right-edge minutes, one upsert,
    the cache skip, and counts equal to the port's ``roe_detect_batch`` on
    the same minutes (``device="cpu"``).
  * The DSD worker through a local cache (no boto3): the JAX package's
    frame, the update times aside.
"""

import datetime as dt

import numpy as np
import pandas as pd
import pandas.testing as pdt
import pytest

import audio_processing_tools_tpu.transform as jtr
from audio_processing_tools_tpu.io.mark import write_mark_audio_file as jwrite

import audio_processing_tools_tpu_torch as tpkg
import audio_processing_tools_tpu_torch.io.db as tdb
import audio_processing_tools_tpu_torch.io.fetch as tfetch
import audio_processing_tools_tpu_torch.transform as ttr
from audio_processing_tools_tpu_torch.io.audio import pcm_to_float
from audio_processing_tools_tpu_torch.io.mark import write_mark_audio_file
from audio_processing_tools_tpu_torch.models.roe import roe_detect_batch

FS = 11162
TS = 1700000000


def _roe_rain(rng, seconds, fn=500.0, drops_per_10s=60):
    """Harmonic-ping rain the RoE classifier is built for."""
    n = int(FS * seconds)
    x = 0.003 * rng.standard_normal(n)
    k = np.arange(1000)
    ping = sum((1.0 / h) * np.sin(2 * np.pi * fn * h * k / FS) for h in range(1, 6))
    for t0 in rng.integers(0, n - 1200, int(drops_per_10s * seconds / 10)):
        x[t0 : t0 + 1000] += 0.6 * np.exp(-k / 80.0) * ping
    return (np.clip(x, -1, 1) * 32767).astype(np.int16)


def test_pure_helpers_match_jax():
    rng = np.random.default_rng(3)
    sig = np.sin(2 * np.pi * 500 * np.arange(FS) / FS) + 0.1 * rng.standard_normal(FS)
    pdt.assert_frame_equal(ttr.get_real_fft_df(sig, FS), jtr.get_real_fft_df(sig, FS))
    out = [rng.random(100) * 10 for _ in range(3)]
    for start in (dt.datetime(2024, 1, 1, 12, 0, 0), TS, float(TS) + 0.5):
        pdt.assert_frame_equal(ttr.emulator_output_to_df(out, "DEV1", start),
                               jtr.emulator_output_to_df(out, "DEV1", start))
    pdt.assert_frame_equal(ttr.emulator_output_to_df(out, "D", TS, output_interval_min=5),
                           jtr.emulator_output_to_df(out, "D", TS, output_interval_min=5))
    assert ttr.dsd_weights == jtr.dsd_weights
    assert ttr.reverse_binning_func(7, threshold=0.5) == jtr.reverse_binning_func(7, threshold=0.5)
    df = pd.DataFrame({f"dsd{i}": rng.random(4) for i in range(32)})
    for add_to_df in (True, False):
        for add_sum in (True, False):
            pdt.assert_frame_equal(
                ttr.add_weighted_dsd_data(df, add_to_df=add_to_df, add_weighted_dsd_sum=add_sum),
                jtr.add_weighted_dsd_data(df, add_to_df=add_to_df, add_weighted_dsd_sum=add_sum))
    w = rng.random(32)
    pdt.assert_frame_equal(ttr.add_weighted_dsd_data(df, weights=w),
                           jtr.add_weighted_dsd_data(df, weights=w))
    assert ttr.get_package_version() == jtr.get_package_version() == tpkg.__version__ == "0.1.0"
    for a, b in zip(ttr.butter_bandpass(400, 700, FS), jtr.butter_bandpass(400, 700, FS)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttr.butter_bandpass_filter(sig, 400, 700, FS),
                                  jtr.butter_bandpass_filter(sig, 400, 700, FS))


def test_classification_etl_fake_db(monkeypatch, tmp_path):
    rng = np.random.default_rng(5)
    keys = [f"audio/DEV{i}/field/{TS + 60 * i}" for i in range(2)]
    pcm = {k: _roe_rain(rng, 61) for k in keys}
    blobs = {k: write_mark_audio_file(pcm[k], sample_rate=FS, timestamp=TS, device_id=f"DEV{i}")
             for i, k in enumerate(keys)}
    calls = {"upserts": [], "queries": []}

    def fake_get_db_data(query, engine, **kw):
        calls["queries"].append(query)
        return fake_get_db_data.existing

    fake_get_db_data.existing = pd.DataFrame()
    monkeypatch.setattr(ttr, "validate_db_engine", lambda e: None)
    monkeypatch.setattr(tdb, "get_db_data", fake_get_db_data)
    monkeypatch.setattr(tdb, "upsert_df",
                        lambda df, table, engine, **kw: calls["upserts"].append((table, df.reset_index())))
    monkeypatch.setattr(tfetch, "get_device_raw_audio_data",
                        lambda keys=(), **kw: {k: blobs[k] for k in keys})

    out = ttr.dsp_classification_from_audio_keys(keys, db_engine=object(),
                                                 local_cache_location=str(tmp_path), device="cpu")
    assert len(out) == 2 and set(out["key"]) == set(keys)  # one complete minute each
    for col in ("time", "rain_drop_count", "frain_mean", "sample_rate",
                "dsp_classifier_version", "device", "update_time", "create_time"):
        assert col in out.columns, col
    assert (out["dsp_classifier_version"] == tpkg.__version__).all()
    for i, k in enumerate(keys):
        row = out[out["key"] == k].iloc[0]
        assert row["time"] == dt.datetime.fromtimestamp(TS + 60 * i) + dt.timedelta(minutes=1)
        assert row["device"] == f"DEV{i}" and row["sample_rate"] == FS
        ref = roe_detect_batch(pcm_to_float(pcm[k][None, : 60 * FS]), device="cpu",
                               sample_rate=FS)
        assert row["rain_drop_count"] == int(ref["rain_drop_count_mod"][0])
        assert row["frain_mean"] == float(ref["frain_mean"][0])
    assert out["rain_drop_count"].max() > 0
    table, upserted = calls["upserts"][0]
    assert table == "dsp_classification_from_raw_audio" and len(upserted) == 2
    assert "dsp_classification_from_raw_audio" in calls["queries"][0]

    # second run: the cache covers the keys, nothing is classified or upserted
    fake_get_db_data.existing = out
    out2 = ttr.dsp_classification_from_audio_keys(keys, db_engine=object(),
                                                  local_cache_location=str(tmp_path), device="cpu")
    assert len(calls["upserts"]) == 1 and len(out2) == len(out)


def test_classify_minutes_batches_recordings():
    """Recordings of 2 and 1 complete minutes in one batch give each
    recording's own per-minute results."""
    rng = np.random.default_rng(8)
    sigs = [_roe_rain(rng, 125), _roe_rain(rng, 61)]
    both = ttr._classify_minutes(sigs, FS, device="cpu")
    assert [len(d) for d, _ in both] == [2, 1]
    for sig, (drops, frain) in zip(sigs, both):
        (d1, f1), = ttr._classify_minutes([sig], FS, device="cpu")
        np.testing.assert_array_equal(drops, d1)
        np.testing.assert_array_equal(frain, f1)


def test_classification_worker_rejects_short_audio(monkeypatch, tmp_path):
    blob = write_mark_audio_file((np.random.default_rng(2).standard_normal(FS * 30) * 500)
                                 .astype(np.int16), sample_rate=FS, timestamp=TS,
                                 device_id="SHORT")
    monkeypatch.setattr(tfetch, "get_device_raw_audio_data",
                        lambda keys=(), **kw: {k: blob for k in keys})
    with pytest.raises(ValueError, match="less than 1 minute"):
        ttr.process_audio_file_classification(f"audio/SHORT/field/{TS}", str(tmp_path), False,
                                              False, device="cpu")


@pytest.mark.parametrize("seconds", [70, 45])
def test_dsd_worker_through_local_cache_matches_jax(tmp_path, seconds):
    """The DSD worker reads the key from the local cache (no S3, no boto3)
    and gives the JAX package's frame; the first 60 s only."""
    rng = np.random.default_rng(seconds)
    key = f"raw_audio/DEV7/a/b/c/20240102_03_04_05_000000_rain_{seconds}"
    pcm = _roe_rain(rng, seconds, fn=520.0)
    path = tmp_path / key
    path.parent.mkdir(parents=True)
    path.write_bytes(jwrite(pcm, sample_rate=FS, timestamp=TS, device_id="DEV7"))
    got = ttr.process_audio_file_dsd(key, str(tmp_path), False, False)
    ref = jtr.process_audio_file_dsd(key, str(tmp_path), False, False)
    times = ["update_time", "create_time"]
    pdt.assert_frame_equal(got.drop(columns=times), ref.drop(columns=times))
    assert (got["dsd_emulator_version"] == tpkg.__version__).all()
    assert got["time"].iloc[0] == pd.Timestamp(2024, 1, 2, 3, 5, 5)
