"""MARK binary audio container (Mark-3 sensor format), PCM payloads.

Counterpart of ``audio_processing_tools_tpu/io/mark.py:42-228``.  Layout of
the 40-byte little-endian header:

  offset  size  field
  0       4     magic  AD FB CA DE
  4       4     timestamp          u32 (unix seconds)
  8       4     sample_rate        u32
  12      1     num_channels       u8
  13      1     adc_bitdepth       u8
  14      1     endianness         u8 (0 = LE, 1 = BE)
  15      1     audio_file_version u8 (>= 1 means ALAC payload)
  16      12    latitude, longitude, altitude  f32
  28      10    device_id          UTF-8, NUL padded
  38      2     skipped (firmware quirk)
  40      ...   payload (int16 PCM or BER-framed ALAC)

Pure stdlib + NumPy.  ALAC payloads raise ``NotImplementedError``
(ROADMAP P21).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

MARK_MAGIC = b"\xAD\xFB\xCA\xDE"
HEADER_SIZE = 40
_HEADER_FMT = "<4sIIBBBBfff10s2s"

_ALAC_TODO = "ALAC MARK payloads are not ported yet (ROADMAP P21)"


class MarkHeaderError(ValueError):
    """Raised when the MARK magic does not match."""


def parse_mark_header(data: bytes) -> Dict[str, Any]:
    """Parse the 40-byte header; raises :class:`MarkHeaderError` on bad magic."""
    if len(data) < HEADER_SIZE:
        raise MarkHeaderError(f"file too short for MARK header: {len(data)} bytes")
    (magic, ts, sr, ch, bits, endian, ver, lat, lon, alt, device, _skip) = (
        struct.unpack_from(_HEADER_FMT, data, 0)
    )
    if magic != MARK_MAGIC:
        raise MarkHeaderError(f"bad magic {magic!r}")
    return {
        "device": device.decode("utf-8", errors="replace").rstrip("\x00"),
        "ts": ts,
        "sample_rate": sr,
        "channels": ch,
        "bit_depth": bits,
        "endianness": endian,
        "gps": [lat, lon, alt],
        "audio_file_version": ver,
        "audio": data[HEADER_SIZE:],
    }


def write_mark_audio_file(
    pcm: np.ndarray,
    *,
    sample_rate: int = 11162,
    timestamp: int = 0,
    channels: int = 1,
    bit_depth: int = 16,
    endianness: int = 0,
    file_version: int = 0,
    lat: float = 0.0,
    lon: float = 0.0,
    alt: float = 0.0,
    device_id: str = "TESTDEV",
    payload: Optional[bytes] = None,
) -> bytes:
    """Serialize int16 PCM (or a raw ``payload``) into a MARK container.

    Float input is clipped to [-1, 1] and scaled by 32767.  Encoding PCM to
    an ALAC payload (``file_version >= 1`` with no ``payload``) raises.
    """
    if payload is None:
        arr = np.asarray(pcm)
        if arr.dtype != np.int16:
            if np.issubdtype(arr.dtype, np.floating):
                arr = np.clip(arr, -1.0, 1.0)
                arr = (arr * 32767.0).astype(np.int16)
            else:
                arr = arr.astype(np.int16)
        if file_version >= 1:
            raise NotImplementedError(_ALAC_TODO)
        payload = arr.astype("<i2" if endianness == 0 else ">i2").tobytes()
    header = struct.pack(
        _HEADER_FMT,
        MARK_MAGIC,
        int(timestamp) & 0xFFFFFFFF,
        int(sample_rate),
        int(channels),
        int(bit_depth),
        int(endianness),
        int(file_version),
        float(lat),
        float(lon),
        float(alt),
        device_id.encode("utf-8")[:10].ljust(10, b"\x00"),
        b"\x00\x00",
    )
    return header + payload


def _decode_pcm_payload(audio_data: bytes, bit_depth: int, channels: int,
                        endianness: int) -> np.ndarray:
    if bit_depth != 16:
        raise ValueError(f"Unsupported PCM bit depth: {bit_depth}")
    dtype = "<i2" if endianness == 0 else ">i2"
    return np.frombuffer(audio_data, dtype=dtype).astype(np.int16, copy=False)


def parse_mark_audio_file(
    file_contents: bytes,
    force_file_type: Optional[str] = None,
) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Parse a MARK file into (int16 PCM, metadata).

      * header-parse failure -> raw-PCM defaults (sr 11162, 16-bit mono LE),
      * payload length aligned down to whole samples before decoding,
      * ``file_version >= 1`` (or ``force_file_type='alac'``) -> ALAC, which
        raises ``NotImplementedError`` here.
    """
    try:
        parsed = parse_mark_header(file_contents)
        sample_rate = parsed["sample_rate"]
        channels = parsed["channels"]
        bit_depth = parsed["bit_depth"]
        endianness = parsed["endianness"]
        gps = parsed["gps"]
        audio_data = parsed["audio"]
        device_id = parsed["device"]
        time = parsed["ts"]
        file_version = parsed["audio_file_version"]
    except MarkHeaderError:
        print("WARNING: Could not parse header, assuming raw PCM defaults")
        sample_rate, channels, bit_depth, endianness, file_version = 11162, 1, 16, 0, 0
        gps = (None, None, None)
        device_id = None
        time = None
        audio_data = file_contents

    if bit_depth == 0:
        bit_depth = 16
    if bit_depth % 8 != 0:
        raise ValueError(f"Invalid bit depth {bit_depth}: must be multiple of 8")
    if bit_depth != 16:
        print(f"WARNING: Unsupported bit depth {bit_depth}; assuming 16-bit PCM compatibility")
    bytes_per_sample = bit_depth // 8

    remainder = len(audio_data) % bytes_per_sample
    if remainder != 0:
        audio_data = audio_data[: len(audio_data) - remainder]

    if force_file_type == "alac":
        is_alac = True
    elif force_file_type == "pcm":
        is_alac = False
    else:
        is_alac = file_version >= 1
    if is_alac:
        raise NotImplementedError(_ALAC_TODO)

    sig = _decode_pcm_payload(audio_data, bit_depth, channels, endianness)
    n_per_ch = len(sig) / channels if channels > 0 else len(sig)
    duration = round(n_per_ch / sample_rate, 2)

    metadata = {
        "sample_rate": sample_rate,
        "channels": channels,
        "bit_depth": bit_depth,
        "endianness": endianness,
        "device_id": device_id,
        "time": time,
        "lat": gps[0],
        "long": gps[1],
        "duration": duration,
        "audio_file_version": file_version,
        "format": "pcm",
    }
    return sig, metadata
