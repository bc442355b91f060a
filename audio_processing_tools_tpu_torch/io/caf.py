"""ALAC payload -> CAF re-containerization (host only).

Counterpart of ``audio_processing_tools_tpu/io/caf.py``, byte for byte.
The Mark-3 firmware streams raw BER-framed ALAC packets; decoders such as
ffmpeg need them wrapped in a CAF container with the right ``desc``,
``kuki``, ``pakt`` and ``data`` chunks (the reference's port of Apple's CAF
writer, ``alac_utils.py:306-426``):

  * CAF fields are big-endian,
  * the ALAC magic cookie is the firmware's fixed 24-byte cookie,
  * the packet table is sized from the firmware's fixed 245,760-byte PCM
    buffer (a parameter here),
  * input packets are framed as 3 header bytes (a 2-byte BER packet size
    and 1 byte giving how many of the 3 header bytes belong in the packet
    table) followed by the packet payload,
  * a leading MARK magic (``AD FB CA DE`` + 36 bytes) is skipped.

The port decodes ALAC in-process (``io/alac_native.py``); this container is
what the ffmpeg route of ``io/alac.py`` hands to ffmpeg.
"""

from __future__ import annotations

import io as _io
import struct
from dataclasses import dataclass
from typing import Tuple

from audio_processing_tools_tpu_torch.io.alac_native import (
    ALAC_DEFAULT_FRAMES_PER_PACKET,
    FIRMWARE_MAGIC_COOKIE,
    read_ber_integer,
)

MIN_CAFF_PACKET_TABLE_HEADER_SIZE = 24
ALAC_FORMAT_APPLE_LOSSLESS = 0x616C6163  # 'alac'
ALAC_FORMAT_LINEAR_PCM = 0x6C70636D      # 'lpcm'
ALAC_MAX_ESCAPE_HEADER_BYTES = 16

DEFAULT_SAMPLE_RATE = 11162.0
DEFAULT_PCM_BUFFER_BYTES = 245760  # the firmware's fixed PCM capture size


@dataclass
class AudioFormatDescription:
    """CAF ``desc`` chunk payload (reference ``alac_utils.py:23-35``);
    fields are serialized big-endian."""

    sample_rate: float = DEFAULT_SAMPLE_RATE
    format_id: int = ALAC_FORMAT_APPLE_LOSSLESS
    format_flags: int = 1
    bytes_per_packet: int = 0
    frames_per_packet: int = ALAC_DEFAULT_FRAMES_PER_PACKET
    channels_per_frame: int = 1
    bits_per_channel: int = 0

    def pack(self) -> bytes:
        return struct.pack(
            ">dIIIIII", float(self.sample_rate), self.format_id,
            self.format_flags, self.bytes_per_packet, self.frames_per_packet,
            self.channels_per_frame, self.bits_per_channel,
        )


@dataclass
class CAFPacketTableHeader:
    """CAF ``pakt`` chunk header (reference ``alac_utils.py:37-53``)."""

    number_packets: int = 0
    number_valid_frames: int = 0
    priming_frames: int = 0
    remainder_frames: int = 0

    def pack(self) -> bytes:
        return struct.pack(
            ">QQII", self.number_packets, self.number_valid_frames,
            self.priming_frames, self.remainder_frames,
        )


def build_base_packet_table(
    pcm_bytes: int, bytes_per_frame: int = 2,
    frames_per_packet: int = ALAC_DEFAULT_FRAMES_PER_PACKET,
) -> Tuple[CAFPacketTableHeader, int]:
    """Packet-table geometry from the fixed PCM capture size
    (reference ``alac_utils.py:56-93``); returns (header, max_table_size)."""
    n_valid = pcm_bytes // bytes_per_frame
    n_packets = n_valid // frames_per_packet
    remainder = frames_per_packet - (n_valid - n_packets * frames_per_packet)
    if remainder:
        n_packets += 1
    max_packet = bytes_per_frame * frames_per_packet + ALAC_MAX_ESCAPE_HEADER_BYTES
    entry_bytes = 2 if max_packet < 16384 else 3
    header = CAFPacketTableHeader(
        number_packets=n_packets, number_valid_frames=n_valid,
        priming_frames=0, remainder_frames=remainder,
    )
    return header, entry_bytes * n_packets


def write_caff_fcaff_chunk(out) -> None:
    """``caff`` file header, version 1 (reference ``alac_utils.py:96``)."""
    out.write(b"caff\x00\x01\x00\x00")


def write_caff_desc_chunk(out, desc: AudioFormatDescription) -> None:
    """12-byte chunk header + 32-byte description
    (reference ``alac_utils.py:142``)."""
    out.write(b"desc" + b"\x00" * 7 + bytes([32]))
    out.write(desc.pack())


def write_caff_kuki_chunk(out, cookie: bytes = FIRMWARE_MAGIC_COOKIE) -> None:
    """Magic-cookie chunk (reference ``alac_utils.py:151``)."""
    out.write(b"kuki" + b"\x00" * 7 + bytes([len(cookie) & 0xFF]))
    out.write(cookie)


def write_caff_pakt_chunk_header(out, header: CAFPacketTableHeader,
                                 table_size: int) -> None:
    """``pakt`` chunk header + table header; the caller fills the table
    entries afterwards (reference ``alac_utils.py:218``)."""
    total_chunk = table_size + MIN_CAFF_PACKET_TABLE_HEADER_SIZE
    out.write(b"pakt" + b"\x00\x00\x00\x00" + struct.pack(">I", total_chunk))
    out.write(header.pack())


def write_caff_data_chunk(out) -> None:
    """Open-ended ``data`` chunk marker (reference ``alac_utils.py:230``)."""
    out.write(b"data" + b"\x00" * 11 + b"\x01")


def find_caff_packet_table_start(caf_bytes: bytes) -> int:
    """Offset of the first packet-table entry inside a CAF blob
    (reference ``alac_utils.py:275-303``): scan chunks for ``pakt`` and skip
    its 24-byte table header."""
    pos = 8  # past the caff file header
    n = len(caf_bytes)
    while pos + 12 <= n:
        tag = caf_bytes[pos : pos + 4]
        (size,) = struct.unpack_from(">q", caf_bytes, pos + 4)
        if tag == b"pakt":
            return pos + 12 + MIN_CAFF_PACKET_TABLE_HEADER_SIZE
        pos += 12 + max(size, 0)
    raise ValueError("no 'pakt' chunk found in CAF data")


def rearrange_bytes(
    alac_payload: bytes,
    *,
    sample_rate: float = DEFAULT_SAMPLE_RATE,
    channels: int = 1,
    pcm_buffer_bytes: int = DEFAULT_PCM_BUFFER_BYTES,
) -> bytes:
    """Wrap a firmware ALAC stream into a CAF container; returns the bytes."""
    out = _io.BytesIO()

    write_caff_fcaff_chunk(out)
    write_caff_desc_chunk(out, AudioFormatDescription(
        sample_rate=float(sample_rate), channels_per_frame=int(channels),
    ))
    write_caff_kuki_chunk(out, FIRMWARE_MAGIC_COOKIE)

    table_header, table_size = build_base_packet_table(
        pcm_buffer_bytes, bytes_per_frame=2 * channels
    )
    write_caff_pakt_chunk_header(out, table_header, table_size)
    packet_table_pos = out.tell()
    out.write(bytes(table_size))

    # 'data' chunk (open-ended size marker, as the firmware writer emits)
    write_caff_data_chunk(out)
    data_pos = out.tell()

    # copy the BER-framed packets
    src = _io.BytesIO(alac_payload)
    head = src.read(4)
    if len(head) < 4:
        return out.getvalue()
    if head == b"\xad\xfb\xca\xde":
        src.seek(36, 1)  # embedded MARK header: skip the remaining 36 bytes
    else:
        src.seek(0)

    while True:
        hdr = src.read(3)
        if len(hdr) < 3:
            break
        packet_size, _ = read_ber_integer(hdr, 2)
        table_entry_len = hdr[2]
        out.seek(packet_table_pos)
        out.write(hdr[:table_entry_len])
        packet_table_pos += table_entry_len

        payload = src.read(packet_size)
        if len(payload) < packet_size:
            break
        out.seek(data_pos)
        out.write(payload)
        data_pos += packet_size

    return out.getvalue()


def rearrange(input_file_name: str, output_file_name: str) -> None:
    """File-path API of the reference's ``alac_utils.rearrange``."""
    with open(input_file_name, "rb") as f:
        payload = f.read()
    with open(output_file_name, "wb") as f:
        f.write(rearrange_bytes(payload))


if __name__ == "__main__":  # the reference's CLI, alac_utils.py:428-437
    import argparse

    ap = argparse.ArgumentParser(
        description="Rewrap a firmware ALAC stream into a CAF container"
    )
    ap.add_argument("input_file")
    ap.add_argument("output_file")
    _a = ap.parse_args()
    rearrange(_a.input_file, _a.output_file)
