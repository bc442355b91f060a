"""Live detection server: stream PCM in, JSON detections out.

Counterpart of ``audio_processing_tools_tpu/cli/serve.py``: a socket server
that takes length-prefixed PCM packets from live feeds and answers each with
one JSON line of causal detection results, threading the port's
:class:`~audio_processing_tools_tpu_torch.models.streaming.StreamingRainDetector`
state from packet to packet.  It runs on the card unless ``--cpu`` asks for
the CPU.

Wire protocol (one TCP or Unix-domain connection per stream)::

    request  := b"APT1" + uint32le(n_bytes) + n_bytes of int16-LE PCM
    mu-law   := b"APT2" + uint32le(n_bytes) + n_bytes of mu-law int8 codes
    eos      := b"APT0" + uint32le(0)
    response := one JSON line per request (and a summary line for eos)

With ``--emit-audio`` every JSON reply carries ``audio_samples`` and is
followed by ``b"APTA" + uint32le(n_bytes) + int16-LE PCM`` of denoised
audio (the causal suppressor, ``n_fft - hop`` samples late); the eos summary
is followed by the drained tail.  Samples may arrive in any quantity: the
server buffers to the hop and carries the rest, so packetization never
changes the results.

``--batch-window-ms`` turns on dynamic batching: concurrent connections
whose chunks arrive within the window run as one
``process_chunk_batch`` call, per stream the bits of the single-stream
call.  A batch that fails is run again one request at a time, so one bad
member cannot fail its neighbours; each such re-run is counted in
``_Batcher.group_reruns``.

``--model band_noise`` serves the firmware-shaped band-noise estimator
(``models/band_noise.py``) instead: per-frame FFT rain decisions and Wiener
telemetry, one frame (512 samples) of granularity; with ``--emit-audio``
each frame scaled by its band gain ``G_mag`` (no added latency).

Run: ``python -m audio_processing_tools_tpu_torch.cli.serve --port 0
[--cpu] [--emit-audio] [--model band_noise]``; ``--client FILE --port N``
streams a file to a running server.
"""

from __future__ import annotations

import argparse
import json
import queue
import socket
import socketserver
import struct
import sys
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

MAGIC_DATA = b"APT1"
MAGIC_MULAW = b"APT2"
MAGIC_EOS = b"APT0"
MAGIC_AUDIO = b"APTA"
_HDR = struct.Struct("<4sI")
MAX_PACKET_BYTES = 64 << 20

INT16_SCALE = 32767.0


def _to_pcm16(y: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(y, np.float32) * INT16_SCALE, -32768, 32767).astype("<i2")


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        piece = sock.recv(n - len(buf))
        if not piece:
            return None
        buf += piece
    return buf


class _SpectralService:
    """The flagship spectral detector, one state per connection.

    ``block`` is the sample granularity the server buffers to; ``process``
    returns ``(new_state, reply_fields)`` with ``frames`` and
    ``rain_frames`` and the detector's extras.
    """

    def __init__(self, params: Dict[str, Any], emit_audio: bool = False,
                 device: str = "cuda"):
        from audio_processing_tools_tpu_torch.models.streaming import StreamingRainDetector

        p = dict(params)
        if emit_audio:
            p["compute_output_audio"] = True
        self.emit_audio = emit_audio
        self.det = StreamingRainDetector(device=device)
        self.det.setup(p)
        self.block = int(self.det.cfg.hop)
        self.min_event_frames = max(1, int(params.get("clip_rain_min_frames", 3)))
        self.lock = threading.Lock()

    def new_state(self):
        with self.lock:
            return self.det.init_state()

    def drain(self, state) -> np.ndarray:
        """The overlap-add tail at stream end (empty without audio)."""
        if not self.emit_audio:
            return np.zeros(0, "<i2")
        with self.lock:
            return _to_pcm16(self.det.drain_audio(state))

    def process(self, state, samples: np.ndarray):
        with self.lock:
            state, out = self.det.process_chunk(state, samples)
            out = {k: v.cpu().numpy() for k, v in out.items()}
        return state, self._fields(out)

    def _fields(self, out) -> Dict[str, Any]:
        from audio_processing_tools_tpu_torch.models.frame_classifier import FrameClass

        fc = np.asarray(out["frame_class"])
        fields = {
            "frames": int(fc.size),
            "rain_frames": int(np.sum(fc == int(FrameClass.RAIN))),
            "rain_conf_mean": float(np.mean(np.asarray(out["rain_conf"]))),
        }
        if self.emit_audio:
            fields["_audio"] = _to_pcm16(out["y"])
        return fields

    def process_many(self, states, sample_rows):
        """B lockstep requests of one chunk length as one
        ``process_chunk_batch`` call, per stream the bits of ``process``."""
        from audio_processing_tools_tpu_torch.models.streaming import split_state, stack_states

        with self.lock:
            new, out = self.det.process_chunk_batch(stack_states(states), np.stack(sample_rows))
            out = {k: v.cpu().numpy() for k, v in out.items()}
        fields = [self._fields({k: v[i] for k, v in out.items()}) for i in range(len(states))]
        return split_state(new), fields


class _BandNoiseService:
    """The streaming band-noise estimator (``edge/band_noise_estimator.py``
    semantics), one state per connection: per-frame FFT rain decisions and
    Wiener telemetry."""

    def __init__(self, params: Dict[str, Any], emit_audio: bool = False,
                 device: str = "cuda"):
        import torch

        from audio_processing_tools_tpu_torch.models.band_noise import build_band_noise_config

        self.cfg = build_band_noise_config(dict(params))
        self.emit_audio = emit_audio
        self.device = torch.device(device)
        self.block = int(self.cfg.frame_len)
        self.min_event_frames = max(1, int(params.get("clip_rain_min_frames", 3)))
        self.lock = threading.Lock()

    def new_state(self):
        from audio_processing_tools_tpu_torch.models.band_noise import band_noise_init_state

        return band_noise_init_state(self.cfg, 1, self.device)

    def drain(self, _state) -> np.ndarray:
        return np.zeros(0, "<i2")  # a per-frame gain buffers nothing

    def _run(self, state, rows):
        import torch

        from audio_processing_tools_tpu_torch.models.band_noise import band_noise_process_chunk

        x = torch.as_tensor(np.stack([np.asarray(r, np.float32) for r in rows]), device=self.device)
        with self.lock:
            outs, state = band_noise_process_chunk(x, self.cfg, state)
            outs = {k: outs[k].cpu().numpy() for k in ("fft_rain_frame", "N_E", "G_mag")}
        return state, outs

    def process(self, state, samples: np.ndarray):
        state, outs = self._run(state, [samples])
        return state, self._fields({k: v[0] for k, v in outs.items()}, samples)

    def _fields(self, outs, samples=None) -> Dict[str, Any]:
        rain = np.asarray(outs["fft_rain_frame"]).astype(bool)
        fields = {
            "frames": int(rain.size),
            "rain_frames": int(rain.sum()),
            "N_E_last": float(np.asarray(outs["N_E"])[-1]),
            "G_mag_mean": float(np.mean(np.asarray(outs["G_mag"]))),
        }
        if self.emit_audio and samples is not None:
            # the estimator's Wiener gain is one band-magnitude scalar per
            # frame (M_clean = G_mag * M_band); its time-domain rendering
            # applies that gain to the frame, with no added latency
            g = np.asarray(outs["G_mag"], np.float32)
            frames = np.asarray(samples, np.float32).reshape(g.size, -1)
            fields["_audio"] = _to_pcm16((frames * g[:, None]).reshape(-1))
        return fields

    def process_many(self, states, sample_rows):
        """B lockstep requests of one chunk length as one batched
        ``band_noise_process_chunk``, per stream the bits of ``process``."""
        from audio_processing_tools_tpu_torch.models.band_noise import split_state, stack_states

        new, outs = self._run(stack_states(states), sample_rows)
        fields = [self._fields({k: v[i] for k, v in outs.items()}, sample_rows[i])
                  for i in range(len(states))]
        return split_state(new), fields


_SERVICES = {"spectral": _SpectralService, "band_noise": _BandNoiseService}


class _Batcher:
    """Dynamic batching: concurrent requests coalesced into batched calls.

    Handler threads block in :meth:`submit`; a dispatcher thread drains the
    queue for up to ``window_ms`` after the first arrival, groups requests
    by chunk length and runs each group of two or more through the
    service's ``process_many``.  A group that fails is run again one request
    at a time (counted in ``group_reruns``), so one poisoned member cannot
    fail its neighbours.
    """

    def __init__(self, svc, window_ms: float, max_batch: int = 64):
        self.svc = svc
        self.window = float(window_ms) / 1e3
        self.max_batch = int(max_batch)
        self.q: "queue.Queue" = queue.Queue()
        self.batched_calls = 0     # group dispatches through process_many
        self.batched_requests = 0  # requests served by them
        self.group_reruns = 0      # failed groups run again one by one
        threading.Thread(target=self._loop, daemon=True, name="apt-serve-batcher").start()

    def submit(self, state, samples: np.ndarray):
        ev = threading.Event()
        box: Dict[str, Any] = {}
        self.q.put((state, samples, ev, box))
        ev.wait()
        if "err" in box:
            raise box["err"]
        return box["state"], box["fields"]

    def _loop(self) -> None:
        while True:
            batch = [self.q.get()]
            deadline = time.monotonic() + self.window
            while len(batch) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=left))
                except queue.Empty:
                    break
            groups: Dict[int, list] = {}
            for item in batch:
                groups.setdefault(int(item[1].size), []).append(item)
            for items in groups.values():
                self._run_group(items)

    def _run_group(self, items) -> None:
        if len(items) > 1:
            try:
                new_states, fields = self.svc.process_many([it[0] for it in items],
                                                           [it[1] for it in items])
                self.batched_calls += 1
                self.batched_requests += len(items)
                for (_st, _row, ev, box), ns, f in zip(items, new_states, fields):
                    box["state"], box["fields"] = ns, f
                    ev.set()
                return
            except Exception:
                self.group_reruns += 1
        for st, row, ev, box in items:
            try:
                box["state"], box["fields"] = self.svc.process(st, row)
            except Exception as e:
                box["err"] = e
            ev.set()


class _StreamHandler(socketserver.BaseRequestHandler):
    """One live stream per connection."""

    def handle(self) -> None:  # noqa: C901 - linear protocol loop
        from audio_processing_tools_tpu_torch.ops.wire import mulaw_decode_np

        svc = self.server.svc  # type: ignore[attr-defined]
        state = svc.new_state()
        pending = np.zeros(0, np.float32)
        chunk_idx = total_frames = total_rain = 0
        while True:
            hdr = _recv_exact(self.request, _HDR.size)
            if hdr is None:
                return  # the client left mid-stream
            magic, n_bytes = _HDR.unpack(hdr)
            if magic not in (MAGIC_DATA, MAGIC_MULAW, MAGIC_EOS) or n_bytes > MAX_PACKET_BYTES:
                self._send({"error": "bad packet header"})
                return
            if magic == MAGIC_EOS:
                tail = svc.drain(state)
                summary = {
                    "eos": True,
                    "chunks": chunk_idx,
                    "frames": total_frames,
                    "rain_frames": total_rain,
                    "stream_is_rain": total_rain >= svc.min_event_frames,
                    "dropped_tail_samples": int(pending.size),
                }
                if svc.emit_audio:
                    summary["audio_samples"] = int(tail.size)
                    self._send(summary)
                    self._send_audio(tail)
                else:
                    self._send(summary)
                return
            payload = _recv_exact(self.request, n_bytes)
            if payload is None:
                return
            if magic == MAGIC_MULAW:
                # the 1-byte companded wire; x 32768/32767 lands on the int16
                # path's full-scale convention
                pcm = mulaw_decode_np(np.frombuffer(payload, np.int8))
                pcm *= 32768.0 / INT16_SCALE
            else:
                if n_bytes % 2:
                    self._send({"error": "odd payload length (int16 PCM)"})
                    return
                pcm = np.frombuffer(payload, "<i2").astype(np.float32)
                pcm /= INT16_SCALE
            pending = np.concatenate([pending, pcm])

            usable = pending.size // svc.block * svc.block
            if usable == 0:
                empty = {"chunk": chunk_idx, "frames": 0, "rain_frames": 0,
                         "buffered_samples": int(pending.size)}
                if svc.emit_audio:
                    empty["audio_samples"] = 0
                    self._send(empty)
                    self._send_audio(np.zeros(0, "<i2"))
                else:
                    self._send(empty)
                chunk_idx += 1
                continue
            piece, pending = pending[:usable], pending[usable:]
            batcher = getattr(self.server, "batcher", None)
            if batcher is not None:
                state, fields = batcher.submit(state, piece)
            else:
                state, fields = svc.process(state, piece)
            audio = fields.pop("_audio", None)
            total_frames += fields["frames"]
            total_rain += fields["rain_frames"]
            reply = {
                "chunk": chunk_idx,
                **fields,
                "stream_rain_frames": total_rain,
                "event": total_rain >= svc.min_event_frames,
                "buffered_samples": int(pending.size),
            }
            if audio is not None:
                reply["audio_samples"] = int(audio.size)
                self._send(reply)
                self._send_audio(audio)
            else:
                self._send(reply)
            chunk_idx += 1

    def _send(self, obj: Dict[str, Any]) -> None:
        self.request.sendall(json.dumps(obj).encode() + b"\n")

    def _send_audio(self, pcm: np.ndarray) -> None:
        blob = np.ascontiguousarray(pcm).tobytes()
        self.request.sendall(_HDR.pack(MAGIC_AUDIO, len(blob)) + blob)


class _TcpServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class _UnixServer(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True


def make_server(params: Dict[str, Any], *, host: str = "127.0.0.1", port: int = 0,
                unix_path: Optional[str] = None, model: str = "spectral",
                batch_window_ms: float = 0.0, emit_audio: bool = False,
                device: str = "cuda"):
    """Build (not start) a server on ``device``; ``.server_address`` has the
    bound port, ``.batcher`` the dynamic batcher (None without a window).

    ``batch_window_ms`` > 0 coalesces concurrent connections whose chunks
    arrive within the window into one batched call (adds up to one window
    of latency).  ``emit_audio`` streams denoised PCM back after every
    reply.
    """
    if model not in _SERVICES:
        raise ValueError(f"unknown model {model!r}; expected one of {sorted(_SERVICES)}")
    svc = _SERVICES[model](params, emit_audio=emit_audio, device=device)
    srv = _UnixServer(unix_path, _StreamHandler) if unix_path else _TcpServer((host, port),
                                                                              _StreamHandler)
    srv.svc = svc  # type: ignore[attr-defined]
    srv.batcher = _Batcher(svc, batch_window_ms) if batch_window_ms > 0 else None  # type: ignore[attr-defined]
    return srv


def _load_audio_float(path: str) -> np.ndarray:
    """WAV, MARK container or raw ``.f32`` / ``.i16`` -> mono float32 [-1, 1]."""
    low = path.lower()
    if low.endswith(".wav"):
        from audio_processing_tools_tpu_torch.io.audio import load_wav

        y, _sr = load_wav(path)
        return y[0] if y.ndim > 1 else y
    if low.endswith(".f32"):
        return np.fromfile(path, np.float32)
    if low.endswith(".i16"):
        return np.fromfile(path, "<i2").astype(np.float32) / INT16_SCALE
    from audio_processing_tools_tpu_torch.io.mark import parse_mark_audio_file

    with open(path, "rb") as f:
        sig, _meta = parse_mark_audio_file(f.read())
    return np.asarray(sig, np.float32) / 32768.0


def stream_file(path: str, *, host: str = "127.0.0.1", port: int = 8765,
                unix_path: Optional[str] = None, packet_samples: int = 8192,
                sample_rate: int = 11162, wire: str = "int16"):
    """Client: stream an audio file to a running server and yield its JSON
    replies (the last is the stream summary); against an ``--emit-audio``
    server each reply carries its PCM as ``reply["audio"]``.
    ``wire="mulaw"`` sends companded APT2 packets."""
    if wire not in ("int16", "mulaw"):
        raise ValueError(f"unknown wire format: {wire!r}")
    x = _load_audio_float(path)
    pcm = np.clip(np.asarray(x, np.float32) * INT16_SCALE, -32768, 32767).astype("<i2")
    if wire == "mulaw":
        from audio_processing_tools_tpu_torch.ops.wire import mulaw_encode

        pcm = mulaw_encode(pcm)
    magic = MAGIC_MULAW if wire == "mulaw" else MAGIC_DATA
    if unix_path:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.connect(unix_path)
    else:
        sock = socket.create_connection((host, port), timeout=600)
    with sock:
        f = sock.makefile("rb")

        def read_reply():
            reply = json.loads(f.readline())
            if "audio_samples" in reply:
                magic_a, n_bytes = _HDR.unpack(f.read(_HDR.size))
                if magic_a != MAGIC_AUDIO:
                    raise ValueError(f"expected an audio blob, got {magic_a!r}")
                reply["audio"] = np.frombuffer(f.read(n_bytes), "<i2")
            return reply

        for start in range(0, len(pcm), packet_samples):
            chunk = pcm[start : start + packet_samples].tobytes()
            sock.sendall(_HDR.pack(magic, len(chunk)) + chunk)
            yield read_reply()
        sock.sendall(_HDR.pack(MAGIC_EOS, 0))
        yield read_reply()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Live rain-detection server on the card (length-prefixed int16 PCM in, "
                    "JSON lines out)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765,
                    help="TCP port (0 = ephemeral; printed on start)")
    ap.add_argument("--unix", default=None, metavar="PATH",
                    help="serve on a Unix-domain socket instead of TCP")
    ap.add_argument("--sample-rate", type=int, default=11162)
    ap.add_argument("--params", default=None,
                    help="JSON file of engine params (merged over defaults)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the detector on the CPU instead of the card")
    ap.add_argument("--client", default=None, metavar="AUDIO_FILE",
                    help="act as a client: stream this file to the server and print its "
                         "JSON replies")
    ap.add_argument("--packet-samples", type=int, default=8192,
                    help="client mode: samples per packet")
    ap.add_argument("--wire", default="int16", choices=("int16", "mulaw"),
                    help="client mode: uplink encoding (mulaw = companded APT2 packets, "
                         "half the bytes of int16)")
    ap.add_argument("--model", default="spectral", choices=tuple(_SERVICES),
                    help="engine family to serve")
    ap.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="dynamic batching window: concurrent connections coalesce into one "
                         "batched call (0 = off)")
    ap.add_argument("--emit-audio", action="store_true",
                    help="stream denoised PCM back (an APTA blob after each JSON reply)")
    args = ap.parse_args(argv)

    if args.client:
        for reply in stream_file(args.client, host=args.host, port=args.port,
                                 unix_path=args.unix, packet_samples=args.packet_samples,
                                 sample_rate=args.sample_rate, wire=args.wire):
            # keep the printed line JSON: the PCM becomes its sample count
            audio = reply.pop("audio", None)
            if audio is not None:
                reply["audio"] = {"samples": int(len(audio))}
            print(json.dumps(reply), flush=True)
        return 0

    from audio_processing_tools_tpu_torch.config import DEFAULT_MODE_BANDS

    params: Dict[str, Any] = {
        "sample_rate": args.sample_rate,
        "detector": {"mode_bands": [list(b) for b in DEFAULT_MODE_BANDS]},
    }
    if args.params:
        with open(args.params) as f:
            params.update(json.load(f))

    device = "cpu" if args.cpu else "cuda"
    srv = make_server(params, host=args.host, port=args.port, unix_path=args.unix,
                      model=args.model, batch_window_ms=args.batch_window_ms,
                      emit_audio=args.emit_audio, device=device)
    where = args.unix or "%s:%d" % srv.server_address[:2]
    print(f"serving live rain detection on {where} (model={args.model}, "
          f"sample_rate={params['sample_rate']}, device={device})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
