"""Port parity: the host tools of the port (``utils/``, ``cli/corpus.py``,
``cli/header_parser.py``, ``cli/audio_parser.py``, ``io/tabular.py``,
``postprocess/``, ``evaluation.py``, ``viz/``) against the JAX package's.
They are NumPy and pandas code, so the bound is equality: the same bits,
the same bytes, the same printed lines, equal DataFrames."""

import io
import json
import os
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pandas as pd
import pandas.testing as pdt
import pytest

from audio_processing_tools_tpu import evaluation as jeval
from audio_processing_tools_tpu import postprocess as jpost
from audio_processing_tools_tpu.cli import audio_parser as jaudio_parser
from audio_processing_tools_tpu.cli import corpus as jcorpus_cli
from audio_processing_tools_tpu.cli import header_parser as jheader_parser
from audio_processing_tools_tpu.io import tabular as jtab
from audio_processing_tools_tpu.utils import corpus as jcorpus

from audio_processing_tools_tpu_torch import evaluation as teval
from audio_processing_tools_tpu_torch import postprocess as tpost
from audio_processing_tools_tpu_torch import utils as tutils
from audio_processing_tools_tpu_torch.cli import audio_parser as taudio_parser
from audio_processing_tools_tpu_torch.cli import corpus as tcorpus_cli
from audio_processing_tools_tpu_torch.cli import header_parser as theader_parser
from audio_processing_tools_tpu_torch.io import tabular as ttab
from audio_processing_tools_tpu_torch.io.mark import write_mark_audio_file
from audio_processing_tools_tpu_torch.utils import corpus as tcorpus

FS = 11162


def _stdout(fn, *args, **kw) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue()


def _tree_bytes(d: Path):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("kind", tcorpus.CLIP_CLASSES + tcorpus.HARD_CLIP_CLASSES)
def test_synth_clip_bits_match_jax(kind):
    got = tcorpus.synth_clip(kind, np.random.default_rng(3), seconds=1.5)
    ref = jcorpus.synth_clip(kind, np.random.default_rng(3), seconds=1.5)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_corpora_match_jax():
    for got, ref in ((tcorpus.make_labeled_corpus(5, seconds=1.0),
                      jcorpus.make_labeled_corpus(5, seconds=1.0)),
                     (tcorpus.make_hard_corpus(17, seconds=1.0, per_class=2),
                      jcorpus.make_hard_corpus(17, seconds=1.0, per_class=2))):
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2]
    with pytest.raises(ValueError, match="unknown clip class"):
        tcorpus.synth_clip("hail", np.random.default_rng(0))


def test_corpus_files_are_jax_bytes(tmp_path):
    clips, labels, kinds = tcorpus.make_labeled_corpus(9, seconds=0.5)
    paths = tcorpus.write_corpus_dir(str(tmp_path / "port"), clips, labels, kinds)
    jpaths = jcorpus.write_corpus_dir(str(tmp_path / "jax"), clips, labels, kinds)
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in jpaths]
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")


@pytest.mark.parametrize("codec", ["pcm", "alac"])
def test_corpus_cli_matches_jax(tmp_path, codec):
    extra = ["--alac"] if codec == "alac" else []
    argv = ["--seed", "4", "--seconds", "0.5", "--rain-heavy", "2", "--noise", "1",
            "--wind", "1", "--tonal", "0", "--rain-light", "0"] + extra
    got = _stdout(tcorpus_cli.main, ["--out", str(tmp_path / "port")] + argv)
    ref = _stdout(jcorpus_cli.main, ["--out", str(tmp_path / "jax")] + argv)
    a, b = json.loads(got), json.loads(ref)
    assert a.pop("out") != b.pop("out") and a == b and a["codec"] == codec and a["files"] == 4
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")


@pytest.fixture(scope="module")
def mark_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("marks")
    rng = np.random.default_rng(8)
    for i in range(3):
        pcm = (rng.standard_normal(FS // 2) * 3000).astype(np.int16)
        (d / f"clip{i}.bin").write_bytes(write_mark_audio_file(
            pcm, sample_rate=FS, timestamp=1700000000 + i, device_id=f"DEV{i}", lat=1.5))
    (d / "bad.bin").write_bytes(b"not a mark file at all, longer than forty bytes....")
    return d


def test_header_parser_prints_jax_lines(mark_dir):
    got = _stdout(theader_parser.main, [str(mark_dir)])
    ref = _stdout(jheader_parser.main, [str(mark_dir)])
    assert got == ref and got.count("BAD HEADER") == 1 and got.count("payload_bytes") == 3
    one = str(mark_dir / "clip1.bin")
    assert _stdout(theader_parser.main, [one]) == _stdout(jheader_parser.main, [one])


def test_audio_parser_prints_jax_lines_and_wav(mark_dir, tmp_path):
    src = str(mark_dir / "clip2.bin")
    out = {}
    for name, mod in (("port", taudio_parser), ("jax", jaudio_parser)):
        (tmp_path / name).mkdir()
        out[name] = _stdout(mod.main, [src, "--wav-out", str(tmp_path / name / "a.wav"),
                                       "--plot-out", str(tmp_path / name / "a.png")])
    assert out["port"].replace("/port/", "/jax/") == out["jax"] and "rms:" in out["jax"]
    assert (tmp_path / "port" / "a.wav").read_bytes() == (tmp_path / "jax" / "a.wav").read_bytes()
    assert (tmp_path / "port" / "a.png").stat().st_size > 0


def test_tabularize_and_metadata_handler_match_jax(mark_dir, monkeypatch):
    blobs = {f"audio/DEV{i}/f/{1700000000 + i}": (mark_dir / f"clip{i}.bin").read_bytes()
             for i in range(3)}
    got, ref = ttab.tabularize_audio_data(blobs), jtab.tabularize_audio_data(blobs)
    pdt.assert_frame_equal(got.drop(columns="signal"), ref.drop(columns="signal"))
    for a, b in zip(got["signal"], ref["signal"]):
        np.testing.assert_array_equal(a.contents, b.contents)
        assert repr(a) == repr(b)
    assert ttab.tabularize_audio_data({}).empty

    import audio_processing_tools_tpu.io.db as jdb
    import audio_processing_tools_tpu.io.fetch as jfetch
    import audio_processing_tools_tpu_torch.io.db as tdb
    import audio_processing_tools_tpu_torch.io.fetch as tfetch

    upserts = {"port": [], "jax": []}
    for name, fetch, db in (("port", tfetch, tdb), ("jax", jfetch, jdb)):
        monkeypatch.setattr(fetch, "get_device_raw_audio_data",
                            lambda keys=(), **kw: {k: blobs[k] for k in keys if k in blobs})
        monkeypatch.setattr(db, "upsert_df",
                            lambda df, table, eng, name=name, **kw: upserts[name].append((table, df)))
    keys = list(blobs) + ["audio/MISSING/f/0"]
    out = {"port": _stdout(ttab.AudioMetadataHandler(keys, object(), batch_size=2)
                           .fetch_and_store_metadata),
           "jax": _stdout(jtab.AudioMetadataHandler(keys, object(), batch_size=2)
                          .fetch_and_store_metadata)}
    assert out["port"] == out["jax"] and len(upserts["port"]) == 2
    for (t1, d1), (t2, d2) in zip(upserts["port"], upserts["jax"]):
        assert t1 == t2 == "audio_metadata"
        pdt.assert_frame_equal(d1, d2)


def _results_df():
    """``tests/test_postprocess_eval.py:10-20``."""
    return pd.DataFrame({
        "file_key": ["a", "b", "c", "d"],
        "rain_actual": [True, True, False, False],
        "rain__rain_drops": [12, 1, 8, 0],
        "rain__rain_drop_count": [12, 1, 8, 0],
        "rain__rain_peaks_count": [20, 2, 11, 0],
        "rain__rain_drop_count_mod": [12, 0, 8, 0],
        "rain__frain_mean": [510.0, 0.0, 480.0, 0.0],
        "rain__predicted": [True, False, True, False],
    })


def test_postprocess_matches_jax():
    states = pd.DataFrame({"file_key": ["a", "b", "c", "d"], "nov": [[1.0], [0.0], [2.0], [0.0]],
                           "kurtosis": [[3.0]] * 4, "crest_factor": [[4.0]] * 4,
                           "diff_energy": [[7.0]] * 4})
    no_pred = _results_df().drop(columns=["rain__predicted"])
    cases = [(_results_df(), states, {"handle_fp": True}),
             (_results_df(), states, {}),
             (no_pred, pd.DataFrame(columns=["file_key"]), {"rain_drop_min_thr": 3}),
             (no_pred, pd.DataFrame(columns=["file_key"]), {"handle_fn": True}),
             (pd.DataFrame(), pd.DataFrame(), {})]
    for results, st, params in cases:
        for a, b in zip(tpost.postprocess_rain(results, st, params),
                        jpost.postprocess_rain(results, st, params)):
            pdt.assert_frame_equal(a, b)
    noise = pd.DataFrame({"file_key": ["a"], "rain_actual": [True], "noise__snr_db": [4.2]})
    for results in (noise, pd.DataFrame()):
        pdt.assert_frame_equal(tpost.postprocess_noise(results, pd.DataFrame(), {}),
                               jpost.postprocess_noise(results, pd.DataFrame(), {}))


def test_evaluate_corpus_matches_jax(tmp_path):
    got = teval.evaluate_corpus(_results_df(), predicted_col="rain__predicted",
                                out_dir=str(tmp_path / "port"))
    ref = jeval.evaluate_corpus(_results_df(), predicted_col="rain__predicted",
                                out_dir=str(tmp_path / "jax"))
    assert got == ref and got["n_fp"] == 1
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")
    for key in ("tp", "tn", "fp", "fn"):
        pdt.assert_frame_equal(teval.confusion_split(_results_df(), "rain__predicted")[key],
                               jeval.confusion_split(_results_df(), "rain__predicted")[key])


def test_viz_plots_render():
    import matplotlib

    matplotlib.use("Agg")
    from audio_processing_tools_tpu_torch import viz

    x = tcorpus.synth_clip("rain_heavy", np.random.default_rng(0), seconds=0.5)
    for fn in (viz.plot_audio_signal, viz.plot_audio_fft, viz.plot_audio_spectrogram):
        fig = fn(x, FS)
        assert fig.axes and fig.axes[0].get_title()
    assert viz.__all__ == ["plot_audio_signal", "plot_audio_fft", "plot_audio_spectrogram",
                           "show_noise_processing_results", "frames_to_df",
                           "plot_frame_classifier_debug", "plot_frame_classifier_tuning",
                           "plot_noise_suppressor_debug"]


def test_timer_timed_and_device_trace(tmp_path):
    import torch

    timer = tutils.Timer()
    for _ in range(3):
        with timer.section("a"):
            pass
    rep = timer.report()
    assert rep["a"]["count"] == 3 and rep["a"]["total_s"] >= 0
    assert rep["a"]["mean_s"] == pytest.approx(rep["a"]["total_s"] / 3)
    assert tutils.timed(lambda a, b=0: a + b, 2, b=3)[0] == 5
    with tutils.device_trace(str(tmp_path / "trace")):
        torch.fft.rfft(torch.ones(1024)).abs().sum()
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("fft" in str(e.get("name", "")) for e in events)
