"""Port parity: the host I/O copies (``io/audio.py``, ``io/fetch.py``,
``io/db.py``) against the JAX package's; NumPy on both sides, so every
array is held identical."""

import sys

import numpy as np
import pytest

import audio_processing_tools_tpu.io.audio as jaudio
from audio_processing_tools_tpu.io.mark import write_mark_audio_file as jwrite

import audio_processing_tools_tpu_torch.io.audio as taudio
import audio_processing_tools_tpu_torch.io.db as tdb
import audio_processing_tools_tpu_torch.io.fetch as tfetch
from audio_processing_tools_tpu_torch.io.mark import parse_s3_audio_key

FS = 11162


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_sample_conversions_match_jax():
    rng = np.random.default_rng(0)
    pcm = (rng.standard_normal(999) * 9000).astype(np.int16)
    _same(taudio.pcm_to_float(pcm), jaudio.pcm_to_float(pcm))
    _same(taudio.pcm_to_float(pcm, scale_factor=1000), jaudio.pcm_to_float(pcm, scale_factor=1000))
    for data in (pcm, pcm.tobytes(), 1.7 * rng.standard_normal(50), np.float32([0.5, -2.0])):
        _same(taudio.safe_to_float(data), jaudio.safe_to_float(data))
    for bad, kw in ((pcm.astype(np.int32), {}), (pcm.tobytes(), {"bytes_per_sample": 3})):
        with pytest.raises(ValueError):
            taudio.safe_to_float(bad, **kw)
        with pytest.raises(ValueError):
            jaudio.safe_to_float(bad, **kw)
    y = rng.standard_normal(4000).astype(np.float32)
    for sr_in, sr_out in ((16000, FS), (FS, 8000), (44100, FS)):
        _same(taudio.resample_poly(y, sr_in, sr_out), jaudio.resample_poly(y, sr_in, sr_out))
    stereo = 1.3 * rng.standard_normal((2, 30000))
    for y2, sr_in, dur in ((stereo, 16000, 1.0), (stereo.T, FS, 2.0), (stereo[0], FS, 3.0),
                           (stereo[0], 22050, 1.0)):
        _same(taudio.ensure_mono_len_sr(y2, sr_in, FS, dur),
              jaudio.ensure_mono_len_sr(y2, sr_in, FS, dur))


def test_wav_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    for y in (0.8 * np.clip(rng.standard_normal(3000), -1.5, 1.5),
              (rng.standard_normal((2, 1000)) * 3000).astype(np.int16)):
        a, b = tmp_path / "port.wav", tmp_path / "jax.wav"
        taudio.write_wav(str(a), y, FS)
        jaudio.write_wav(str(b), y, FS)
        assert a.read_bytes() == b.read_bytes()
        got, sr = taudio.load_wav(str(a))
        ref, sr_ref = jaudio.load_wav(str(b))
        assert sr == sr_ref == FS
        _same(got, ref)


@pytest.fixture()
def local_tree(tmp_path):
    """MARK and WAV files under rain-labelled directories, one too short,
    one WAV at another rate, one unreadable."""
    rng = np.random.default_rng(2)
    (tmp_path / "True").mkdir()
    (tmp_path / "False" / "sub").mkdir(parents=True)
    for i in range(2):
        pcm = (rng.standard_normal(FS * 2) * 3000).astype(np.int16)
        (tmp_path / "True" / f"clip{i}.bin").write_bytes(jwrite(pcm, sample_rate=FS, timestamp=i))
    (tmp_path / "False" / "short.bin").write_bytes(
        jwrite((rng.standard_normal(100) * 3000).astype(np.int16), sample_rate=FS))
    jaudio.write_wav(str(tmp_path / "False" / "sub" / "a.wav"), 0.3 * rng.standard_normal(FS * 3),
                     16000)
    jaudio.write_wav(str(tmp_path / "unlabelled.WAV"), 0.3 * rng.standard_normal(FS * 2), FS)
    (tmp_path / "False" / "broken.wav").write_bytes(b"not a wav")
    (tmp_path / "notes.txt").write_text("ignored")
    return tmp_path


def test_get_keys_and_input_data_match_jax(local_tree, monkeypatch):
    monkeypatch.chdir(local_tree)  # no local_keys.csv here
    for status in (True, False):
        got = taudio.get_keys("LocalPath", test_vector_path=str(local_tree), localStatus=status)
        ref = jaudio.get_keys("LocalPath", test_vector_path=str(local_tree), localStatus=status)
        assert got == ref and len(got) == 6
    for dur in (1.0, 1.5):
        got = taudio.get_input_data(ref, "LocalPath", FS, dur, True, None, None)
        want = jaudio.get_input_data(ref, "LocalPath", FS, dur, True, None, None)
        assert got.keys() == want.keys() and len(got) == 4
        for k in got:
            assert got[k]["raining"] == want[k]["raining"]
            _same(got[k]["file_contents"], want[k]["file_contents"])

    def inject(key, y):
        return y * 0.5, {"key": key}

    got = taudio.get_input_data(ref, "LocalPath", FS, 1.0, True, None, None, noise_injector=inject)
    want = jaudio.get_input_data(ref, "LocalPath", FS, 1.0, True, None, None,
                                 noise_injector=inject)
    for k in got:
        assert got[k]["synthetic_noise_info"] == want[k]["synthetic_noise_info"]
        _same(got[k]["file_contents"], want[k]["file_contents"])
    for mode, kw in (("RemotePath", {}), ("CsvInput", {}), ("KeyList", {}), ("Nope", {})):
        with pytest.raises(ValueError) as e_port:
            taudio.get_keys(mode, **kw)
        with pytest.raises(ValueError) as e_jax:
            jaudio.get_keys(mode, **kw)
        assert str(e_port.value) == str(e_jax.value)


def test_remote_input_data_from_cache_without_boto3(local_tree, monkeypatch):
    """Remote keys served wholly from the local cache need no boto3."""
    monkeypatch.setitem(sys.modules, "boto3", None)  # import boto3 raises ImportError
    monkeypatch.setattr(tfetch, "_default_session", None)
    key = "raw_audio/DEV1/x/y/z/20240102_03_04_05_000000_rain_1"
    path = local_tree / key
    path.parent.mkdir(parents=True)
    path.write_bytes((local_tree / "True" / "clip0.bin").read_bytes())
    got = tfetch.get_device_raw_audio_data(keys=[key], local_cache_location=str(local_tree))
    assert got == {key: path.read_bytes()}
    data = taudio.get_input_data([{"source_file": key, "raining": True}], "S3", FS, 1.5, True,
                                 str(local_tree), None)
    assert list(data) == [key] and data[key]["file_contents"].shape == (int(FS * 1.5),)
    # a key missing from the cache reaches S3, which needs boto3
    assert tfetch.get_device_raw_audio_data(keys=["audio/none/x/1"],
                                            local_cache_location=str(local_tree)) == {}
    with pytest.raises(ImportError, match="boto3 is required"):
        tfetch.get_prod_boto_session()
    assert parse_s3_audio_key(key)["device_id"] == "DEV1"


def test_db_is_gated_on_sqlalchemy(monkeypatch):
    monkeypatch.setitem(sys.modules, "sqlalchemy", None)
    for call in (lambda: tdb.get_db_data("SELECT 1", object()),
                 lambda: tdb.upsert_df(None, "t", object())):
        with pytest.raises(ImportError, match="SQLAlchemy is required"):
            call()
