"""In-process ALAC codec: the fast native decoder and the libavcodec shim.

Counterpart of ``audio_processing_tools_tpu/io/alac_native.py``, with its
own copies of the C++ sources in ``native/``:

  * **fast** (``native/alac_decode.cpp``): a dependency-free ALAC bitstream
    decoder for the firmware's subset (mono, 16-bit) that decodes a whole
    BER-framed payload in one C call.
  * **avcodec** (``native/alac_shim.cpp``): libavcodec's ALAC linked
    in-process; the encoder, and the decoder for streams outside the fast
    subset (stereo, more than 16 bits).

Each library is compiled at first use, never at import, with
``g++ -O3 -fPIC -shared -std=c++17`` into
``build/apt_torch_native/<hash of source and flags>/`` under the repository
root (a directory git ignores), as ``_kernels.py`` builds the CUDA kernels,
and loaded with ``ctypes``.  The shim links ``-lavcodec -lavutil``; where
they do not link, every call that needs it raises ``RuntimeError`` naming
libavcodec.

The magic cookie picks the decoder: the fast one for a mono 16-bit cookie
(the firmware's), the shim for any other.  A payload the chosen decoder
cannot decode raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import io as _io
import os
import shutil
import subprocess
from ctypes import CDLL, POINTER, c_int16, c_int32, c_int64, c_uint8
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

ALAC_DEFAULT_FRAMES_PER_PACKET = 128

# Fixed firmware magic cookie (11162 Hz mono 16-bit stream parameters).
FIRMWARE_MAGIC_COOKIE = bytes(
    [0x00, 0x00, 0x00, 0x80, 0x00, 0x10, 0x28, 0x0A, 0x0E, 0x01, 0x00, 0xFF,
     0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x2B, 0x9A]
)

NATIVE = Path(__file__).resolve().parent.parent / "native"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "apt_torch_native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
AVCODEC_LIBS = ("-lavcodec", "-lavutil")

_BUILD_ERRORS: Dict[str, str] = {}


def build_library(source: str, lib_name: str, libs: Tuple[str, ...] = ()) -> Path:
    """Compile ``native/<source>`` (if needed) into a shared library and
    return its path; ``RuntimeError`` with the compiler's output when it
    fails.  A changed source or flag gets a new directory."""
    if source in _BUILD_ERRORS:
        raise RuntimeError(_BUILD_ERRORS[source])
    src = NATIVE / source
    h = hashlib.sha256(" ".join(CXX_FLAGS + libs).encode())
    h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / lib_name
    if lib.exists():
        return lib
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        _BUILD_ERRORS[source] = f"no C++ compiler (g++) to build {src}"
        raise RuntimeError(_BUILD_ERRORS[source])
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{lib_name}.{os.getpid()}.tmp"
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src), *libs],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        _BUILD_ERRORS[source] = (f"building {src} failed with exit code {r.returncode}:\n"
                                 f"{(r.stdout + r.stderr)[-2000:]}")
        raise RuntimeError(_BUILD_ERRORS[source])
    os.replace(tmp, lib)
    return lib


_lib: Optional[CDLL] = None
_lib_checked = False


def load_alac_shim() -> CDLL:
    """Load (building at first use) the libavcodec ALAC shim."""
    try:
        path = build_library("alac_shim.cpp", "libalac_shim.so", AVCODEC_LIBS)
    except RuntimeError as e:
        raise RuntimeError(
            "the libavcodec ALAC codec is unavailable: native/alac_shim.cpp needs the "
            f"libavcodec and libavutil development headers and libraries ({e})"
        ) from None
    lib = CDLL(str(path))
    lib.apt_alac_last_error.restype = ctypes.c_char_p
    lib.apt_alac_version.restype = ctypes.c_uint32
    lib.apt_alac_decode.restype = c_int64
    lib.apt_alac_decode.argtypes = [
        POINTER(c_uint8), c_int32, POINTER(c_uint8), POINTER(c_int32),
        c_int32, POINTER(c_int16), c_int64,
    ]
    lib.apt_alac_encode_frame.restype = c_int64
    lib.apt_alac_encode_frame.argtypes = [
        POINTER(c_int16), c_int32, c_int32, POINTER(c_uint8), c_int64,
        POINTER(c_uint8),
    ]
    return lib


def have_alac_shim() -> bool:
    """True when the libavcodec codec builds, links and loads here."""
    global _lib, _lib_checked
    if not _lib_checked:
        _lib_checked = True
        try:
            _lib = load_alac_shim()
        except (OSError, RuntimeError):
            _lib = None
    return _lib is not None


_fast: Optional[CDLL] = None


def load_alac_fast() -> CDLL:
    """Load (building at first use) the dependency-free fast ALAC decoder."""
    global _fast
    if _fast is None:
        lib = CDLL(str(build_library("alac_decode.cpp", "libalac_fast.so")))
        lib.apt_alac_fast_last_error.restype = ctypes.c_char_p
        lib.apt_alac_fast_version.restype = ctypes.c_uint32
        lib.apt_alac_fast_decode.restype = c_int64
        lib.apt_alac_fast_decode.argtypes = [
            ctypes.c_char_p, c_int32, ctypes.c_char_p, POINTER(c_int32),
            c_int32, POINTER(c_int16), c_int64,
        ]
        lib.apt_alac_fast_decode_payload.restype = c_int64
        lib.apt_alac_fast_decode_payload.argtypes = [
            ctypes.c_char_p, c_int32, ctypes.c_char_p, c_int64,
            POINTER(c_int16), c_int64,
        ]
        _fast = lib
    return _fast


def _fast_supports(cookie: bytes) -> bool:
    """The fast decoder's subset: mono, 16-bit (the firmware's format)."""
    return len(cookie) >= 24 and cookie[5] == 16 and cookie[9] == 1


def _shim() -> CDLL:
    if not have_alac_shim():
        load_alac_shim()  # raises the RuntimeError that names libavcodec
    assert _lib is not None
    return _lib


# ---------------------------------------------------------------------------
# firmware BER packet framing


def read_ber_integer(buf: bytes, max_bytes: int) -> Tuple[int, int]:
    """Decode a BER base-128 integer; returns (value, bytes_consumed)."""
    value = 0
    used = 0
    for b in buf[:max_bytes]:
        value = (value << 7) | (b & 0x7F)
        used += 1
        if used > 5:
            return 0, used
        if (b & 0x80) == 0:
            break
    return value, used


def split_ber_packets(payload: bytes) -> list[bytes]:
    """Split a firmware ALAC stream into raw ALAC packets.

    Each packet is framed as 3 header bytes — a BER size (canonical bytes
    first, padded to 2) plus one byte giving the canonical BER length — then
    the packet payload.  A leading duplicated MARK header (magic + 36 bytes)
    is skipped.
    """
    src = _io.BytesIO(payload)
    head = src.read(4)
    if len(head) < 4:
        return []
    if head == b"\xAD\xFB\xCA\xDE":
        src.seek(36, 1)
    else:
        src.seek(0)
    packets = []
    while True:
        hdr = src.read(3)
        if len(hdr) < 3:
            break
        size, _ = read_ber_integer(hdr, 2)
        body = src.read(size)
        if len(body) < size:
            break
        packets.append(body)
    return packets


def _ber_frame_header(size: int) -> bytes:
    """3-byte firmware packet header for a packet of ``size`` bytes."""
    if size < 0x80:
        ber = bytes([size])
    elif size < 0x4000:
        ber = bytes([0x80 | (size >> 7), size & 0x7F])
    else:
        raise ValueError(f"packet too large for 2-byte BER: {size}")
    return ber.ljust(2, b"\x00") + bytes([len(ber)])


# ---------------------------------------------------------------------------
# codec entry points


def _frame_length(cookie: bytes) -> int:
    """Samples per packet: cookie bytes 0-3, big-endian, or the firmware's."""
    return int.from_bytes(cookie[:4], "big") or ALAC_DEFAULT_FRAMES_PER_PACKET


def _avcodec_decode_packets(packets: list[bytes], cookie: bytes) -> np.ndarray:
    if not packets:
        return np.zeros(0, np.int16)
    lib = _shim()
    data = b"".join(packets)
    sizes = (c_int32 * len(packets))(*[len(p) for p in packets])
    # every packet carries at most frameLength samples or its explicit
    # partial-frame count
    cap = _frame_length(cookie) * len(packets)
    out = np.zeros(cap, np.int16)
    n = lib.apt_alac_decode(
        (c_uint8 * len(cookie)).from_buffer_copy(cookie), len(cookie),
        (c_uint8 * len(data)).from_buffer_copy(data), sizes, len(packets),
        out.ctypes.data_as(POINTER(c_int16)), cap,
    )
    if n < 0:
        raise RuntimeError(f"ALAC decode failed: {lib.apt_alac_last_error().decode()}")
    if n > cap:
        raise RuntimeError(f"ALAC decode overflow: {n} samples > cap {cap}")
    return out[:n]


def _fast_decode_packets(packets: list[bytes], cookie: bytes) -> np.ndarray:
    lib = load_alac_fast()
    data = b"".join(packets)
    sizes = (c_int32 * len(packets))(*[len(p) for p in packets])
    cap = _frame_length(cookie) * len(packets)  # exact bound: <= frame_len samples/packet
    out = np.empty(cap, np.int16)
    n = lib.apt_alac_fast_decode(
        cookie, len(cookie), data, sizes, len(packets),
        out.ctypes.data_as(POINTER(c_int16)), cap,
    )
    if n < 0:
        raise RuntimeError(f"ALAC decode failed: {lib.apt_alac_fast_last_error().decode()}")
    if n > cap:
        raise RuntimeError(f"ALAC decode overflow: {n} samples > cap {cap}")
    return out[:n]


def _fast_decode_payload(payload: bytes, cookie: bytes) -> np.ndarray:
    lib = load_alac_fast()
    # every BER-framed packet occupies >= 4 payload bytes (3-byte header +
    # body); if a degenerate stream still overflows, retry with the exact
    # count the decoder reports (it never writes past out_cap)
    cap = _frame_length(cookie) * (len(payload) // 4 + 1)
    while True:
        out = np.empty(cap, np.int16)
        n = lib.apt_alac_fast_decode_payload(
            cookie, len(cookie), payload, len(payload),
            out.ctypes.data_as(POINTER(c_int16)), cap,
        )
        if n < 0:
            raise RuntimeError(
                f"ALAC decode failed: {lib.apt_alac_fast_last_error().decode()}")
        if n <= cap:
            return out[:n]
        cap = int(n)


def decode_alac_packets(packets: list[bytes],
                        cookie: bytes = FIRMWARE_MAGIC_COOKIE) -> np.ndarray:
    """Decode raw ALAC packets to int16 PCM: the fast decoder for a mono
    16-bit cookie, the libavcodec shim for any other."""
    if not packets:
        return np.zeros(0, np.int16)
    if _fast_supports(cookie):
        return _fast_decode_packets(packets, cookie)
    return _avcodec_decode_packets(packets, cookie)


def decode_alac_payload(payload: bytes,
                        cookie: bytes = FIRMWARE_MAGIC_COOKIE) -> np.ndarray:
    """Decode a BER-framed firmware ALAC payload to int16 PCM.  For a mono
    16-bit cookie the whole payload, BER packet walk included, goes in one
    call into the fast decoder; for any other, the packets split here go to
    the libavcodec shim."""
    if _fast_supports(cookie):
        return _fast_decode_payload(payload, cookie)
    return _avcodec_decode_packets(split_ber_packets(payload), cookie)


def encode_alac_frames(
    pcm: np.ndarray, sample_rate: int = 11162,
    frames_per_packet: int = ALAC_DEFAULT_FRAMES_PER_PACKET,
) -> Tuple[list[bytes], bytes]:
    """Encode int16 mono PCM into ALAC packets of ``frames_per_packet``
    (libavcodec).  Returns ``(packets, cookie)``; each packet comes from a
    fresh encoder (ALAC frames are independent) and carries an explicit
    sample count, so it decodes under the firmware's fixed cookie."""
    lib = _shim()
    pcm = np.ascontiguousarray(np.asarray(pcm, np.int16))
    if pcm.ndim != 1:
        raise ValueError("expected 1-D mono PCM")
    packets = []
    cookie_buf = (c_uint8 * 24)()
    cap = frames_per_packet * 2 + 64
    out = (c_uint8 * cap)()
    for start in range(0, len(pcm), frames_per_packet):
        chunk = pcm[start : start + frames_per_packet]
        n = lib.apt_alac_encode_frame(
            chunk.ctypes.data_as(POINTER(c_int16)), len(chunk),
            int(sample_rate), out, cap, cookie_buf,
        )
        if n < 0:
            raise RuntimeError(f"ALAC encode failed: {lib.apt_alac_last_error().decode()}")
        packets.append(bytes(out[: int(n)]))
    return packets, bytes(cookie_buf)


def encode_alac_payload(pcm: np.ndarray, sample_rate: int = 11162) -> bytes:
    """Encode int16 mono PCM into a firmware-geometry BER-framed payload
    (128-sample packets, each behind its 3-byte BER header), padded to an
    even length: the MARK parser aligns payloads down to whole int16
    samples, and the packet reader ignores a single trailing byte."""
    packets, _cookie = encode_alac_frames(pcm, sample_rate)
    buf = _io.BytesIO()
    for p in packets:
        buf.write(_ber_frame_header(len(p)))
        buf.write(p)
    payload = buf.getvalue()
    if len(payload) % 2:
        payload += b"\x00"
    return payload
