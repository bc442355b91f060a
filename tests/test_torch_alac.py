"""Port parity: ALAC ingest (``io/alac_native.py`` and the ALAC branches of
``io/mark.py``) against the JAX package's modules of the same names.

Tolerance: none.  Every comparison is bit-exact: decoded PCM, encoded
payload bytes and BER packet splits.  The port builds its
decoder from its own copy of the C++ source and never loads the JAX
package's shared libraries.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from audio_processing_tools_tpu.io import alac_native as jnat
from audio_processing_tools_tpu.io import caf as jcaf
from audio_processing_tools_tpu.io import mark as jmark

from audio_processing_tools_tpu_torch.io import alac_native as tnat
from audio_processing_tools_tpu_torch.io import mark as tmark

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
FS = 11162

needs_jax_shim = pytest.mark.skipif(not jnat.have_alac_shim(),
                                    reason="the JAX package's libavcodec shim is unavailable")
needs_port_shim = pytest.mark.skipif(not tnat.have_alac_shim(),
                                     reason="libavcodec does not link here")


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    sig = 0.2 * np.sin(2 * np.pi * 523.0 * t / FS) + 0.01 * rng.standard_normal(n)
    return (np.clip(sig, -1, 1) * 32767).astype(np.int16)


def test_golden_fixture_parses_bit_exact():
    blob = (FIXTURES / "alac_golden.bin").read_bytes()
    sig, meta = tmark.parse_mark_audio_file(blob)
    jsig, jmeta = jmark.parse_mark_audio_file(blob)
    np.testing.assert_array_equal(sig, np.load(FIXTURES / "alac_golden_pcm.npy"))
    np.testing.assert_array_equal(sig, jsig)
    assert sig.dtype == np.int16 and meta == jmeta
    assert meta["format"] == "alac" and meta["device_id"] == "GOLDEN01"
    # force_file_type overrides the header's version either way
    pcm_view, m = tmark.parse_mark_audio_file(blob, force_file_type="pcm")
    assert m["format"] == "pcm" and pcm_view.size == (len(blob) - 40) // 2


@needs_jax_shim
@pytest.mark.parametrize("n", [1, 127, 128, 129, 1000, 5581])
def test_jax_encoded_payloads_decode(n):
    pcm = _signal(n, seed=n)
    payload = jnat.encode_alac_payload(pcm, FS)
    packets = tnat.split_ber_packets(payload)
    np.testing.assert_array_equal(tnat.decode_alac_payload(payload), pcm)
    np.testing.assert_array_equal(tnat.decode_alac_packets(packets), pcm)
    if tnat.have_alac_shim():  # the decoder of streams outside the fast subset
        np.testing.assert_array_equal(
            tnat._avcodec_decode_packets(packets, tnat.FIRMWARE_MAGIC_COOKIE), pcm)


@needs_jax_shim
@needs_port_shim
def test_encoder_bytes_equal_jax():
    for n, seed in ((1, 0), (128, 1), (1000, 2), (5581, 3)):
        pcm = _signal(n, seed)
        assert tnat.encode_alac_payload(pcm, FS) == jnat.encode_alac_payload(pcm, FS)
        packets, cookie = tnat.encode_alac_frames(pcm, FS)
        jpackets, jcookie = jnat.encode_alac_frames(pcm, FS)
        assert packets == jpackets and cookie == jcookie


@needs_port_shim
def test_mark_round_trip_file_version_1():
    pcm = _signal(2 * FS + 77, seed=5)
    blob = tmark.write_mark_audio_file(pcm, sample_rate=FS, timestamp=1700000001,
                                       file_version=1, device_id="ALACDEV")
    for parse in (tmark.parse_mark_audio_file, jmark.parse_mark_audio_file):
        sig, meta = parse(blob)
        np.testing.assert_array_equal(sig, pcm)
        assert meta["format"] == "alac" and meta["audio_file_version"] == 1
        assert meta["device_id"] == "ALACDEV" and meta["sample_rate"] == FS
    if jnat.have_alac_shim():
        assert blob == jmark.write_mark_audio_file(pcm, sample_rate=FS, timestamp=1700000001,
                                                   file_version=1, device_id="ALACDEV")
    assert len(blob) - 40 < pcm.nbytes  # compressed, not verbatim


def test_ber_split_matches_jax():
    blob = (FIXTURES / "alac_golden.bin").read_bytes()
    payload = blob[40:]
    packets = tnat.split_ber_packets(payload)
    assert packets == jnat.split_ber_packets(payload)
    assert len(packets) == 44  # 43 full 128-sample packets and one of 77
    # a leading MARK header inside the stream is skipped the same way
    assert tnat.split_ber_packets(blob) == jnat.split_ber_packets(blob)
    assert tnat.split_ber_packets(b"") == jnat.split_ber_packets(b"") == []
    for size in (0, 5, 127, 128, 300, 0x3FFF):
        assert tnat._ber_frame_header(size) == jnat._ber_frame_header(size)
        assert tnat.read_ber_integer(tnat._ber_frame_header(size), 2)[0] == size
    assert tnat.FIRMWARE_MAGIC_COOKIE == jcaf.FIRMWARE_MAGIC_COOKIE
    assert tnat.ALAC_DEFAULT_FRAMES_PER_PACKET == jcaf.ALAC_DEFAULT_FRAMES_PER_PACKET


def test_tiled_packets_decode_to_tiled_pcm():
    """ALAC packets are independent: a payload of whole BER-framed packets
    of another payload, in any order, decodes to the same 128-sample blocks
    (the construction of the card's ALAC phase)."""
    payload = (FIXTURES / "alac_golden.bin").read_bytes()[40:]
    pcm = np.load(FIXTURES / "alac_golden_pcm.npy")
    packets = tnat.split_ber_packets(payload)
    full, last = packets[:-1], packets[-1]
    blocks = pcm[: 128 * len(full)].reshape(len(full), 128)
    order = np.roll(np.arange(len(full)), -3)
    body = b"".join(tnat._ber_frame_header(len(full[i])) + full[i] for i in order)
    got = tnat.decode_alac_payload(body + tnat._ber_frame_header(len(last)) + last)
    np.testing.assert_array_equal(got, np.concatenate([blocks[order].ravel(), pcm[-77:]]))


@needs_jax_shim
def test_corrupt_packet_raises():
    payload = bytearray(jnat.encode_alac_payload(_signal(256), FS))
    payload[3] = 0x40  # element tag 2 (CCE): not a valid ALAC element
    with pytest.raises(RuntimeError, match="ALAC decode failed"):
        tnat.decode_alac_payload(bytes(payload))
    with pytest.raises(RuntimeError, match="ALAC decode failed"):
        tnat.decode_alac_packets(tnat.split_ber_packets(bytes(payload)))


def test_empty_and_truncated_payloads():
    """Nothing decodes to nothing; a payload cut inside its last packet
    decodes the whole packets before it, as the JAX decoder does."""
    assert tnat.decode_alac_packets([]).size == 0
    assert tnat.decode_alac_payload(b"").size == 0
    payload = (FIXTURES / "alac_golden.bin").read_bytes()[40:]
    pcm = np.load(FIXTURES / "alac_golden_pcm.npy")
    cut = payload[: len(payload) - 10]
    got = tnat.decode_alac_payload(cut)
    np.testing.assert_array_equal(got, jnat.decode_alac_payload(cut))
    np.testing.assert_array_equal(got, pcm[: 43 * 128])


def test_cookie_picks_the_decoder(monkeypatch):
    """A mono 16-bit cookie goes to the fast decoder and any other to the
    libavcodec shim, with no fallback from one to the other."""
    payload = (FIXTURES / "alac_golden.bin").read_bytes()[40:]
    stereo = bytearray(tnat.FIRMWARE_MAGIC_COOKIE)
    stereo[9] = 2
    stereo = bytes(stereo)
    assert tnat._fast_supports(tnat.FIRMWARE_MAGIC_COOKIE) and not tnat._fast_supports(stereo)
    calls = []

    def shim(packets, cookie):
        calls.append((len(packets), cookie))
        return np.zeros(0, np.int16)

    monkeypatch.setattr(tnat, "_avcodec_decode_packets", shim)
    tnat.decode_alac_payload(payload, stereo)
    tnat.decode_alac_packets(tnat.split_ber_packets(payload), stereo)
    assert calls == [(44, stereo), (44, stereo)]
    np.testing.assert_array_equal(tnat.decode_alac_payload(payload),
                                  np.load(FIXTURES / "alac_golden_pcm.npy"))
    assert len(calls) == 2


def test_missing_libavcodec_raises_naming_it(monkeypatch):
    """Where ``-lavcodec`` does not link, encoding raises a ``RuntimeError``
    that names libavcodec (simulated with a library that does not exist)."""
    monkeypatch.setattr(tnat, "AVCODEC_LIBS", ("-lapt_no_such_library",))
    monkeypatch.setattr(tnat, "_BUILD_ERRORS", {})
    monkeypatch.setattr(tnat, "_lib", None)
    monkeypatch.setattr(tnat, "_lib_checked", False)
    assert not tnat.have_alac_shim()
    with pytest.raises(RuntimeError, match="libavcodec"):
        tmark.write_mark_audio_file(np.zeros(10, np.int16), file_version=1)
    stereo = bytearray(tnat.FIRMWARE_MAGIC_COOKIE)
    stereo[9] = 2
    with pytest.raises(RuntimeError, match="libavcodec"):
        tnat.decode_alac_packets([b"\x00" * 8], bytes(stereo))
    # decoding needs no libavcodec: the fast decoder takes the firmware's stream
    blob = (FIXTURES / "alac_golden.bin").read_bytes()
    np.testing.assert_array_equal(tmark.parse_mark_audio_file(blob)[0],
                                  np.load(FIXTURES / "alac_golden_pcm.npy"))


def test_decoder_built_from_port_source():
    """In a fresh process that imports nothing of JAX, the port compiles its
    own ``native/alac_decode.cpp`` into ``build/`` and decodes the golden
    file; no shared library of the JAX package is mapped."""
    probe = (
        "import sys, numpy as np\n"
        "from pathlib import Path\n"
        "from audio_processing_tools_tpu_torch.io import alac_native as nat, mark\n"
        "blob = Path('tests/fixtures/alac_golden.bin').read_bytes()\n"
        "sig, meta = mark.parse_mark_audio_file(blob)\n"
        "assert np.array_equal(sig, np.load('tests/fixtures/alac_golden_pcm.npy'))\n"
        "lib = nat.build_library('alac_decode.cpp', 'libalac_fast.so')\n"
        "assert lib.is_relative_to(Path('build').resolve() / 'apt_torch_native'), lib\n"
        "assert nat.NATIVE == Path('audio_processing_tools_tpu_torch/native').resolve()\n"
        "maps = Path('/proc/self/maps').read_text()\n"
        "assert str(lib) in maps\n"
        "assert 'audio_processing_tools_tpu/native' not in maps\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'audio_processing_tools_tpu')]\n"
        "assert not bad, bad\n"
        "print('PORT_DECODER_OK')\n"
    )
    r = subprocess.run([sys.executable, "-c", probe], cwd=str(REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "PORT_DECODER_OK" in r.stdout


def test_new_modules_import_with_jax_blocked():
    """Every module this slice adds to the port imports in a process where
    ``import jax`` (and the JAX package) raises ``ImportError``."""
    probe = (
        "import importlib, importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'audio_processing_tools_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "mods = ['io.alac_native', 'io.mark', 'ops.mel',\n"
        "        'models.mel_classifier', 'models.roe', 'models.wind', 'models.pitch',\n"
        "        'models.time_domain', 'host_analysis', 'host_analysis.dsd_emulator',\n"
        "        'host_analysis.dsd_device', 'io.audio', 'io.fetch', 'io.db', 'transform',\n"
        "        'framework', 'framework.processor']\n"
        "for m in mods:\n"
        "    importlib.import_module('audio_processing_tools_tpu_torch.' + m)\n"
        "print('IMPORTED', len(mods))\n"
    )
    r = subprocess.run([sys.executable, "-c", probe], cwd=str(REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "IMPORTED 17" in r.stdout


def test_slice_imports_with_pandas_and_pyarrow_blocked():
    """The card's machine has no pandas and no pyarrow: the confirmer, DSD,
    the ETL module, the host I/O and the processors import without them
    (pandas only inside the functions that build a DataFrame), and the
    card's part of the ETL and the DSD minutes run."""
    probe = (
        "import importlib, importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'audio_processing_tools_tpu',\n"
        "                                  'pandas', 'pyarrow'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "mods = ['transform', 'host_analysis', 'host_analysis.dsd_emulator',\n"
        "        'host_analysis.dsd_device', 'io.audio', 'io.fetch', 'io.db', 'io.mark',\n"
        "        'framework', 'framework.processor', 'models.time_domain']\n"
        "for m in mods:\n"
        "    importlib.import_module('audio_processing_tools_tpu_torch.' + m)\n"
        "import numpy as np\n"
        "from audio_processing_tools_tpu_torch import transform\n"
        "from audio_processing_tools_tpu_torch.host_analysis import dsd_minutes_device\n"
        "sig = (np.random.default_rng(0).standard_normal(11162 * 61) * 300).astype(np.int16)\n"
        "[(drops, frain)] = transform._classify_minutes([sig], 11162, device='cpu')\n"
        "assert drops.shape == frain.shape == (1,)\n"
        "assert dsd_minutes_device(sig[:11162 * 5] / 32768.0, device='cpu').shape == (1, 100)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('pandas', 'pyarrow')]\n"
        "print('IMPORTED', len(mods))\n"
    )
    r = subprocess.run([sys.executable, "-c", probe], cwd=str(REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "IMPORTED 11" in r.stdout
