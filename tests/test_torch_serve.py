"""The port's live server on the CPU: protocol, state threading,
packetization, the mu-law and mixed wire, emit-audio, dynamic batching, and
its replies against the JAX package's server."""

import concurrent.futures as cf
import json
import socket
import struct
import threading

import numpy as np
import pytest

from audio_processing_tools_tpu.cli import serve as jserve
from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu.io.audio import write_wav
from audio_processing_tools_tpu.utils.corpus import synth_clip

from audio_processing_tools_tpu_torch.cli import serve
from audio_processing_tools_tpu_torch.models.frame_classifier import FrameClass
from audio_processing_tools_tpu_torch.models.streaming import StreamingRainDetector
from audio_processing_tools_tpu_torch.ops.wire import mulaw_encode

FS = 11162
PARAMS = {
    "sample_rate": FS,
    "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
    "clip_rain_min_frames": 3,
}
_HDR = struct.Struct("<4sI")


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _stop(srv):
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def server():
    srv = _start(serve.make_server(PARAMS, port=0, device="cpu"))
    yield srv.server_address
    _stop(srv)


@pytest.fixture(scope="module")
def audio_server():
    srv = _start(serve.make_server(PARAMS, port=0, emit_audio=True, device="cpu"))
    yield srv.server_address
    _stop(srv)


def _pcm(kinds, seed, seconds=1.5):
    rng = np.random.default_rng(seed)
    x = np.concatenate([synth_clip(k, rng, fs=FS, seconds=seconds) for k in kinds])
    return np.clip(x * 32767.0, -32768, 32767).astype("<i2")


@pytest.fixture(scope="module")
def stream_i16():
    return _pcm(("noise", "rain_heavy"), 7)


def _stream(addr, pcm_i16, packet_samples, wires=("int16",), audio=False):
    """Send ``pcm_i16`` in packets, the wire of each cycling through
    ``wires``; returns (replies, summary, denoised pcm or None)."""
    blobs = []
    with socket.create_connection(addr, timeout=300) as s:
        f = s.makefile("rb")

        def reply():
            r = json.loads(f.readline())
            if audio:
                magic, n = _HDR.unpack(f.read(_HDR.size))
                assert magic == serve.MAGIC_AUDIO, magic
                blobs.append(np.frombuffer(f.read(n), "<i2"))
            return r

        replies = []
        for i, start in enumerate(range(0, len(pcm_i16), packet_samples)):
            chunk = pcm_i16[start : start + packet_samples]
            if wires[i % len(wires)] == "mulaw":
                payload, magic = mulaw_encode(chunk).tobytes(), serve.MAGIC_MULAW
            else:
                payload, magic = chunk.tobytes(), serve.MAGIC_DATA
            s.sendall(_HDR.pack(magic, len(payload)) + payload)
            replies.append(reply())
        s.sendall(_HDR.pack(serve.MAGIC_EOS, 0))
        summary = reply()
    return replies, summary, (np.concatenate(blobs) if audio else None)


def _offline(pcm_i16, audio=False):
    """Frames and rain frames (and y with its drained tail) of one
    fresh-state pass through the port's detector."""
    det = StreamingRainDetector(device="cpu")
    det.setup({**PARAMS, "compute_output_audio": audio})
    x = pcm_i16.astype(np.float32) / 32767.0
    usable = x.size // 128 * 128
    st, out = det.process_chunk(det.init_state(), x[:usable])
    fc = out["frame_class"].numpy()
    y = np.concatenate([out["y"].numpy(), det.drain_audio(st)]) if audio else None
    return int(fc.size), int((fc == int(FrameClass.RAIN)).sum()), y


def test_serve_detects_rain_and_matches_offline(server, stream_i16):
    # 1000 samples a packet: not a hop multiple, so the server buffers
    replies, summary, _ = _stream(server, stream_i16, 1000)
    assert summary["eos"] is True
    frames, rain, _ = _offline(stream_i16)
    assert (summary["frames"], summary["rain_frames"]) == (frames, rain)
    assert summary["rain_frames"] > 0 and summary["stream_is_rain"] is True
    assert any(r.get("event") for r in replies)
    assert summary["dropped_tail_samples"] < 128


def test_serve_replies_equal_the_jax_server(server, stream_i16):
    """The same stream through the JAX package's server: every reply's
    frames and rain frames, and the summary, are equal."""
    jsrv = _start(jserve.make_server(PARAMS, port=0))
    try:
        jr, js, _ = _stream(jsrv.server_address, stream_i16, 4096)
    finally:
        _stop(jsrv)
    pr, ps, _ = _stream(server, stream_i16, 4096)
    assert [(r["frames"], r["rain_frames"]) for r in pr] == [
        (r["frames"], r["rain_frames"]) for r in jr]
    for k in ("frames", "rain_frames", "stream_is_rain", "chunks", "dropped_tail_samples"):
        assert ps[k] == js[k], k


def test_serve_packetization_invariant(server, stream_i16):
    _, small, _ = _stream(server, stream_i16, 700)
    _, large, _ = _stream(server, stream_i16, 50000)
    assert (small["frames"], small["rain_frames"]) == (large["frames"], large["rain_frames"])


def test_serve_connections_are_independent(server, stream_i16):
    quiet = _pcm(("noise",), 11)
    _stream(server, stream_i16, 4096)
    _, summary, _ = _stream(server, quiet, 4096)
    frames, rain, _ = _offline(quiet)
    assert (summary["frames"], summary["rain_frames"]) == (frames, rain)
    assert summary["stream_is_rain"] is False


@pytest.mark.parametrize("header", [b"XXXX" + struct.pack("<I", 4) + b"\0\0\0\0",
                                   _HDR.pack(serve.MAGIC_DATA, serve.MAX_PACKET_BYTES + 1),
                                   _HDR.pack(serve.MAGIC_DATA, 3) + b"\0\0\0"],
                         ids=["bad_magic", "oversized", "odd_length"])
def test_serve_rejects_bad_packets(server, header):
    with socket.create_connection(server, timeout=30) as s:
        s.sendall(header)
        reply = json.loads(s.makefile("rb").readline())
    assert "error" in reply
    if header.endswith(b"\0\0\0") and len(header) == 11:
        assert "odd" in reply["error"]


@pytest.mark.parametrize("wire", ["int16", "mulaw"])
def test_client_streams_a_wav_file(server, tmp_path, wire):
    x = _pcm(("noise", "rain_heavy"), 5, seconds=1.0)
    wav = tmp_path / "clip.wav"
    write_wav(str(wav), x.astype(np.int16), FS)
    host, port = server
    replies = list(serve.stream_file(str(wav), host=host, port=port, packet_samples=4096,
                                     wire=wire))
    assert replies[-1]["eos"] is True and replies[-1]["rain_frames"] > 0
    assert all("chunk" in r for r in replies[:-1])
    with pytest.raises(ValueError):
        next(serve.stream_file(str(wav), host=host, port=port, wire="adpcm"))


def test_serve_mulaw_and_mixed_wire(server, stream_i16):
    """APT2 packets, alone or alternating with APT1 in one stream, see the
    same frames and reach the int16 wire's decision."""
    _, s16, _ = _stream(server, stream_i16, 4096)
    _, smu, _ = _stream(server, stream_i16, 4096, wires=("mulaw",))
    _, smix, _ = _stream(server, stream_i16, 4096, wires=("int16", "mulaw"))
    for s in (smu, smix):
        assert s["frames"] == s16["frames"]
        assert s["stream_is_rain"] == s16["stream_is_rain"] is True
        assert abs(s["rain_frames"] - s16["rain_frames"]) <= max(3, int(0.02 * s16["frames"]))


def test_serve_emit_audio_end_to_end(audio_server, stream_i16):
    """Denoised PCM comes back: consumed samples plus the drained tail, the
    same for any packetization, equal to the offline suppressor."""
    replies, summary, y1 = _stream(audio_server, stream_i16, 1000, audio=True)
    assert summary["audio_samples"] == 128
    usable = len(stream_i16) // 128 * 128
    assert y1.size == usable + 128
    _, _, y2 = _stream(audio_server, stream_i16, 49999, audio=True)
    np.testing.assert_array_equal(y1, y2)
    y = _offline(stream_i16, audio=True)[2]
    np.testing.assert_array_equal(y1, np.clip(y * 32767.0, -32768, 32767).astype("<i2"))
    seg = slice(FS // 2, FS * 3 // 2)  # noise, past the tracker's warm-up
    assert (np.sqrt(np.mean(y1[seg].astype(np.float64) ** 2))
            < 0.9 * np.sqrt(np.mean(stream_i16[seg].astype(np.float64) ** 2)))


def test_client_mode_against_emit_audio_server(audio_server, tmp_path, capsys):
    x = _pcm(("rain_heavy",), 11, seconds=1.0)
    wav = tmp_path / "clip.wav"
    write_wav(str(wav), x.astype(np.int16), FS)
    host, port = audio_server
    assert serve.main(["--client", str(wav), "--host", host, "--port", str(port),
                       "--packet-samples", "4096"]) == 0
    replies = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert replies[-1]["eos"] is True
    data = [r for r in replies if "audio" in r]
    assert data and all(r["audio"]["samples"] == r["audio_samples"] for r in data)


@pytest.mark.parametrize("window_ms, packets", [(30.0, "varied"), (150.0, "equal")],
                         ids=["exact", "batches"])
def test_serve_dynamic_batching(window_ms, packets):
    """Concurrent streams through a batching server: each stream's totals
    equal its own fresh-state run; with equal packets and a generous window
    the requests coalesce into batched calls, and no group is re-run."""
    srv = _start(serve.make_server(PARAMS, port=0, batch_window_ms=window_ms, device="cpu"))
    try:
        clips = [_pcm(("noise", "rain_heavy" if i % 2 == 0 else "noise"), 300 + i, seconds=1.0)
                 for i in range(3)]
        sizes = [4096 + (512 * i if packets == "varied" else 0) for i in range(3)]
        with cf.ThreadPoolExecutor(3) as pool:
            summaries = [f.result()[1] for f in [
                pool.submit(_stream, srv.server_address, c, n) for c, n in zip(clips, sizes)]]
        for i, (clip, summary) in enumerate(zip(clips, summaries)):
            frames, rain, _ = _offline(clip)
            assert (summary["frames"], summary["rain_frames"]) == (frames, rain), f"stream {i}"
        assert summaries[0]["rain_frames"] > 0
        assert srv.batcher.group_reruns == 0
        if packets == "equal":
            assert srv.batcher.batched_calls > 0
            assert srv.batcher.batched_requests >= 2 * srv.batcher.batched_calls
    finally:
        _stop(srv)


def test_batcher_reruns_a_failed_group_one_by_one():
    """A group whose batched call fails is run again request by request, and
    the re-run is counted."""
    class Svc:
        def process_many(self, states, rows):
            raise RuntimeError("poisoned group")

        def process(self, state, row):
            return state + 1, {"frames": int(row.size)}

    batcher = serve._Batcher(Svc(), window_ms=100.0)
    with cf.ThreadPoolExecutor(2) as pool:
        res = [f.result() for f in [pool.submit(batcher.submit, i, np.zeros(128, np.float32))
                                    for i in range(2)]]
    assert sorted(r[0] for r in res) == [1, 2] and all(r[1]["frames"] == 128 for r in res)
    assert batcher.group_reruns == 1 and batcher.batched_calls == 0


def _band_noise_direct(pcm_i16, packet, params, audio=False):
    """The replies a band-noise server owes one stream sent in ``packet``
    samples (a multiple of the frame): ``band_noise_process_chunk`` on each
    packet, threading the state."""
    from audio_processing_tools_tpu_torch.models.band_noise import (
        band_noise_init_state,
        band_noise_process_chunk,
        build_band_noise_config,
    )

    cfg = build_band_noise_config(params)
    state, want = band_noise_init_state(cfg, 1, "cpu"), []
    for start in range(0, len(pcm_i16), packet):
        x = pcm_i16[start : start + packet].astype(np.float32)
        x /= serve.INT16_SCALE
        out, state = band_noise_process_chunk(x[None], cfg, state)
        g = out["G_mag"][0].numpy()
        rain = out["fft_rain_frame"][0].numpy()
        r = {"frames": int(rain.size), "rain_frames": int(rain.sum()),
             "N_E_last": float(out["N_E"][0, -1]), "G_mag_mean": float(np.mean(g))}
        if audio:
            r["audio"] = serve._to_pcm16((x.reshape(g.size, -1) * g[:, None]).reshape(-1))
        want.append(r)
    return want


def test_band_noise_model_waits_for_its_port():
    """``--model band_noise``, which raised until the estimator was ported,
    serves it: three concurrent streams through a batching server get
    replies equal to direct ``band_noise_process_chunk`` results, through
    batched calls with no re-run; an emit-audio server returns each frame
    scaled by its gain."""
    params = {"sample_rate": FS}
    packet = 4096  # 8 frames
    srv = _start(serve.make_server(params, port=0, model="band_noise", batch_window_ms=150.0,
                                   device="cpu"))
    try:
        clips = [_pcm(("noise", "rain_heavy" if i != 1 else "noise"), 400 + i, seconds=1.5)
                 for i in range(3)]
        clips = [c[: len(c) // packet * packet] for c in clips]
        with cf.ThreadPoolExecutor(3) as pool:
            results = [f.result() for f in [pool.submit(_stream, srv.server_address, c, packet)
                                            for c in clips]]
        for clip, (replies, summary, _) in zip(clips, results):
            want = _band_noise_direct(clip, packet, params)
            assert [{k: r[k] for k in w} for r, w in zip(replies, want)] == want
            assert summary["frames"] == sum(w["frames"] for w in want)
        assert results[0][1]["rain_frames"] > 0
        assert srv.batcher.batched_calls > 0 and srv.batcher.group_reruns == 0
    finally:
        _stop(srv)
    srv = _start(serve.make_server(params, port=0, model="band_noise", emit_audio=True,
                                   device="cpu"))
    try:
        replies, summary, y = _stream(srv.server_address, clips[0], packet, audio=True)
    finally:
        _stop(srv)
    want = _band_noise_direct(clips[0], packet, params, audio=True)
    np.testing.assert_array_equal(y, np.concatenate([w["audio"] for w in want]))
    assert summary["audio_samples"] == 0
    with pytest.raises(ValueError, match="unknown model"):
        serve.make_server(params, port=0, model="roe", device="cpu")


def test_band_noise_replies_equal_the_jax_server():
    """The same packets through the JAX package's band-noise server: frames
    and rain frames exact, the noise estimate and the mean gain within 1e-4
    (relative, and absolute for the gain; the port's filters and FFT sum in
    their own order)."""
    params = {"sample_rate": FS}
    pcm = _pcm(("noise", "rain_heavy"), 9)
    jsrv = _start(jserve.make_server(params, port=0, model="band_noise"))
    try:
        jr, js, _ = _stream(jsrv.server_address, pcm, 3000)
    finally:
        _stop(jsrv)
    psrv = _start(serve.make_server(params, port=0, model="band_noise", device="cpu"))
    try:
        pr, ps, _ = _stream(psrv.server_address, pcm, 3000)
    finally:
        _stop(psrv)
    assert len(pr) == len(jr) and ps["rain_frames"] > 0
    for a, b in zip(pr, jr):
        assert (a["frames"], a["rain_frames"]) == (b["frames"], b["rain_frames"])
        if b["frames"]:
            assert abs(a["N_E_last"] - b["N_E_last"]) <= 1e-4 * max(abs(b["N_E_last"]), 1e-9)
            assert abs(a["G_mag_mean"] - b["G_mag_mean"]) <= 1e-4
    for k in ("frames", "rain_frames", "stream_is_rain", "chunks", "dropped_tail_samples"):
        assert ps[k] == js[k], k
