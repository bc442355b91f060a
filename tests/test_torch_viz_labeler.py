"""Port parity: the engine debug dashboards (``viz/visualize_noise_output.py``)
and the labeler (``labeler.py``), the counterparts of
``tests/test_viz_labeler.py`` on the port engine's CPU output, matplotlib on
Agg.

Tolerances against JAX: ``frames_to_df`` has JAX's columns in JAX's order
(``time_s`` first, then ``det_debug``'s keys, sorted as JAX's ``jit``
returns them);
its decision columns (frame class, gate masks) are identical and its float
columns within 1e-4 of each column's maximum (the dB-domain bound of
ROADMAP R4); ``generate_uid`` and ``str_to_bool`` are identical.
"""

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pandas as pd
import pytest
import torch

from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu.labeler import TestVectorLabeler as JaxLabeler
from audio_processing_tools_tpu.models.spectral_noise import SpectralNoiseEngine as JaxEngine
from audio_processing_tools_tpu.viz import frames_to_df as jax_frames_to_df

from audio_processing_tools_tpu_torch import labeler as labeler_mod
from audio_processing_tools_tpu_torch.labeler import TestVectorLabeler
from audio_processing_tools_tpu_torch.models.spectral_noise import SpectralNoiseEngine
from audio_processing_tools_tpu_torch.viz import (
    frames_to_df,
    plot_frame_classifier_debug,
    plot_frame_classifier_tuning,
    plot_noise_suppressor_debug,
    show_noise_processing_results,
)

FS = 11162
PARAMS = {
    "sample_rate": FS, "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
    "return_debug": True, "return_detector_debug": True,
    "return_noise_psd": True, "compute_output_audio": True,
    "return_spectra": True, "return_filtered_audio": True,
}


@pytest.fixture(scope="module")
def clip():
    return (0.02 * np.random.default_rng(0).standard_normal(FS * 2)).astype(np.float32)


@pytest.fixture(scope="module")
def engine_out(clip):
    eng = SpectralNoiseEngine(device="cpu")
    eng.setup(PARAMS)
    return eng.process(clip)


@pytest.fixture(scope="module")
def jax_out(clip):
    eng = JaxEngine()
    eng.setup(PARAMS)
    return eng.process(clip)


def test_frames_to_df_matches_jax(engine_out, jax_out):
    df = frames_to_df(engine_out["det_debug"], engine_out["times"])
    ref = jax_frames_to_df(jax_out["det_debug"], jax_out["times"])
    # the same columns in the same order: det_debug's keys are JAX's order
    assert list(df.columns) == list(ref.columns) and len(df) == len(ref)
    assert df.columns[0] == ref.columns[0] == "time_s"
    assert "td_crest_factor" in df.columns and "time_s" in df.columns
    for col in df.columns:
        a, b = df[col].to_numpy(), ref[col].to_numpy()
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=col)
        else:
            scale = max(float(np.abs(b).max()), 1e-30)
            assert float(np.abs(a - b).max()) <= 1e-4 * scale, col


def test_panels_read_tensors(engine_out, clip):
    """Each panel function returns a figure, on NumPy output and on the batch's
    tensors (one clip's row)."""
    eng = SpectralNoiseEngine(device="cpu")
    eng.setup(PARAMS)
    batch = eng.process_batch(torch.from_numpy(clip[None]))
    row = {k: v[0] for k, v in batch["det_debug"].items() if torch.is_tensor(v)}
    times = batch["times"][0] if batch["times"].dim() > 1 else batch["times"]
    df_t = frames_to_df(row, times)
    df_n = frames_to_df(engine_out["det_debug"], engine_out["times"])
    assert list(df_t.columns) == list(df_n.columns)
    for fig in (plot_frame_classifier_debug(row, times),
                plot_frame_classifier_tuning(row, times=times),
                plot_noise_suppressor_debug({k: v[0] for k, v in batch["debug"].items()
                                             if torch.is_tensor(v)}, times),
                show_noise_processing_results(engine_out, FS, play_audio=False)):
        assert fig is not None and len(fig.axes) >= 1


def test_overview_dashboard_panel_content(engine_out):
    fig = show_noise_processing_results(engine_out, FS, play_audio=False)
    assert len(fig.axes) >= 7
    wf = fig.axes[0]
    labels = [ln.get_label() for ln in wf.lines]
    assert len(wf.lines) == 2 and "Original" in labels and "Denoised" in labels
    assert len([ax for ax in fig.axes if ax.collections]) >= 4
    titles = " | ".join(ax.get_title() for ax in fig.axes)
    for frag in ("Waveforms", "Original spectrogram", "Denoised spectrogram",
                 "noise PSD", "Gain G", "P_band_all", "N_band_all"):
        assert frag in titles, frag


def test_overview_dashboard_playback_widget(engine_out, monkeypatch):
    import IPython.display as ipd

    played = []
    monkeypatch.setattr(ipd, "Audio", lambda *a, **k: played.append(k) or "w")
    monkeypatch.setattr(ipd, "display", lambda *a, **k: None)
    show_noise_processing_results(engine_out, FS, play_audio=True)
    assert len(played) == 2 and all(k.get("rate") == FS for k in played)


def test_classifier_debug_and_tuning_panels(engine_out):
    dbg = engine_out["det_debug"]
    fig = plot_frame_classifier_debug(dbg, engine_out["times"])
    assert len(fig.axes) == 5
    assert {"rain_conf", "noise_conf"} <= {ln.get_label() for ln in fig.axes[0].lines}
    fig2 = plot_frame_classifier_debug(dbg, engine_out["times"], audio=engine_out["x_filt"], sr=FS)
    assert len(fig2.axes) == 6 and len(fig2.axes[0].lines) == 1
    fig = plot_frame_classifier_tuning(dbg, times=engine_out["times"])
    assert len(fig.axes) == 5
    for ax in fig.axes[1:]:
        assert len([ln for ln in ax.lines if ln.get_linestyle() == "--"]) == 1
    figw = plot_frame_classifier_tuning(dbg, times=np.asarray(engine_out["times"]), t0=0.5, t1=1.0)
    xs = figw.axes[0].lines[0].get_xdata()
    assert xs.min() >= 0.5 - 1e-6 and xs.max() <= 1.0 + 1e-6


def test_suppressor_debug_panels(engine_out):
    fig = plot_noise_suppressor_debug(engine_out["debug"], engine_out["times"])
    titles = " | ".join(ax.get_title() for ax in fig.axes)
    for frag in ("Gain G", "P_band_all", "N_band_all", "PSD update"):
        assert frag in titles, frag
    fig2 = plot_noise_suppressor_debug({})
    assert len(fig2.axes) == 1 and fig2.axes[0].texts


# ---------------------------------------------------------------------------
# the labeler


def test_labeler_validation_uid_and_bool():
    with pytest.raises(ValueError):
        TestVectorLabeler(pd.DataFrame({"x": [1]}), db_engine=None)
    with pytest.raises(ValueError):
        TestVectorLabeler(pd.DataFrame({"source_file": ["a", "a"]}), db_engine=None)
    for s in ("key0.015.0", "", "DEV1/2024/abc.bin0.010.0"):
        assert TestVectorLabeler.generate_uid(s) == JaxLabeler.generate_uid(s)
    for s in ("TRUE", "false", "True", "0", "yes"):
        assert TestVectorLabeler.str_to_bool(s) is JaxLabeler.str_to_bool(s)


def _one_clip_df():
    return pd.DataFrame({"source_file": ["k1"], "device_id": ["DEV1"],
                         "time": [pd.Timestamp("2024-01-01")]})


def test_labeler_save_for_review(tmp_path):
    from ipywidgets import Output

    from audio_processing_tools_tpu_torch.io.mark import write_mark_audio_file

    lab = TestVectorLabeler(_one_clip_df(), db_engine=None, out_folder=str(tmp_path))
    pcm = (np.random.default_rng(1).standard_normal(FS) * 1000).astype(np.int16)
    lab.save_file_for_review(_one_clip_df().iloc[0],
                             write_mark_audio_file(pcm, sample_rate=FS, device_id="DEV1"),
                             Output())
    saved = list(tmp_path.glob("*.wav"))
    assert len(saved) == 1 and saved[0].name == "DEV1_k1.wav"


def test_labeler_process_index_plays_audio(tmp_path, monkeypatch):
    import IPython.display as ipd
    from ipywidgets import Output

    import audio_processing_tools_tpu_torch.io.fetch as fetch
    from audio_processing_tools_tpu_torch.io.mark import write_mark_audio_file

    pcm = (np.random.default_rng(2).standard_normal(FS * 2) * 1000).astype(np.int16)
    blob = write_mark_audio_file(pcm, sample_rate=FS, device_id="DEV1")
    monkeypatch.setattr(fetch, "get_device_raw_audio_data",
                        lambda keys=(), **kw: {k: blob for k in keys})
    played = []

    class FakeAudio:
        def __init__(self, data=None, rate=None, **kw):
            played.append((np.asarray(data), rate))

    monkeypatch.setattr(ipd, "Audio", FakeAudio)
    lab = TestVectorLabeler(_one_clip_df(), db_engine=None, out_folder=str(tmp_path),
                            local_audio_cache=str(tmp_path))
    lab.process_index("k1", next_index_callback=lambda: None, output_widget=Output())
    assert len(played) == 1
    data, rate = played[0]
    assert rate == FS and data.shape[0] == len(pcm) and np.abs(data).max() <= 1.0


def test_labeler_button_flow_upserts_label(tmp_path, monkeypatch):
    """The Raining button with a fake database engine: the label row is
    built and upserted to ``device_audio_rain_classification``."""
    import sys
    import types

    from ipywidgets import Output

    import audio_processing_tools_tpu_torch.io.db as db

    upserts = []
    monkeypatch.setattr(db, "upsert_df", lambda df, table, eng, **kw: upserts.append((table, df, eng)))
    fake_requests = types.ModuleType("requests")

    def no_egress(*a, **k):
        raise OSError("no egress")

    fake_requests.get = no_egress
    monkeypatch.setitem(sys.modules, "requests", fake_requests)

    class InlineThread:
        def __init__(self, target=None, args=(), daemon=None):
            self.target, self.args = target, args

        def start(self):
            self.target(*self.args)

    monkeypatch.setattr(labeler_mod.threading, "Thread", InlineThread)
    engine = object()
    lab = TestVectorLabeler(_one_clip_df(), db_engine=None, db_engine_upsert=engine,
                            out_folder=str(tmp_path))
    data = _one_clip_df().iloc[0].copy()
    data["segment_start_seconds"] = 0
    data["segment_end_seconds"] = 15
    clicked = []
    lab.make_button_handler(data, Output(), True, lambda: clicked.append(True))(None)
    assert clicked == [True] and len(upserts) == 1
    table, row_df, eng = upserts[0]
    assert table == "device_audio_rain_classification" and eng is engine
    row = row_df.reset_index().iloc[0]
    assert row["raining"] == True and row["manually_labeled"] == True  # noqa: E712
    assert row["source"] == "manually labeled" and row["creator"] == "unknown"
    assert row_df.index.name == "uid"
    assert row_df.index[0] == JaxLabeler.generate_uid("k1" + "0" + "15")


def test_labeler_device_context_plot_with_ibm_overlay(monkeypatch):
    import matplotlib.pyplot as plt

    import audio_processing_tools_tpu_torch.io.db as db

    t0 = pd.Timestamp("2024-03-01 12:00:00")
    audio_df = pd.DataFrame({
        "source_file": [f"k{i}" for i in range(5)],
        "device_id": ["DEV1"] * 4 + ["DEV2"],
        "time": [t0 + pd.Timedelta(hours=h) for h in (-30, -2, 0, 2, 0)],
        "lat": [45.0] * 5, "long": [-122.0] * 5,
    }).set_index("source_file", drop=False)
    ibm = pd.DataFrame({"time": [t0 + pd.Timedelta(hours=h) for h in range(-4, 5)],
                        "ibm_precip": np.linspace(0, 2.0, 9)})
    queries = []
    monkeypatch.setattr(db, "get_db_data", lambda q, eng, **kw: queries.append(q) or ibm)
    monkeypatch.setattr(plt, "show", lambda: None)
    TestVectorLabeler.plot_device_context(object(), "k2", audio_df, window_size=5,
                                          display_ibm_data=True)
    fig = plt.gcf()
    assert len(fig.axes) == 2
    main, twin = fig.axes
    assert len(main.lines) == 2 and len(main.lines[0].get_xdata()) == 4
    assert len(twin.lines) == 1 and len(twin.lines[0].get_ydata()) == 9
    assert "ext_weather.hist_local_hourly" in queries[0]
    plt.close("all")
