"""Companded wire formats: the mu-law wire of the live server (G.711
companding at 8 bits) and the block-scaled int4 wire.

Counterpart of ``audio_processing_tools_tpu/ops/wire.py``: the encode
table (``_encode_lut``), :func:`mulaw_encode` (host, a table lookup per
sample), :func:`mulaw_decode_np` (host) and :func:`mulaw_decode` (a tensor
expansion on the device of its input).  A client that compands its PCM
sends half the bytes of int16; the server expands.

The block-scaled int4 wire (``:104-151``, 4.25 bits a sample):
:func:`block4_encode` (host), :func:`block4_decode_np` (host) and
:func:`block4_decode` (the device of its input).  It was measured and
rejected for detection: its ~19 dB SQNR flips 1/24 clip decisions on the
labeled corpus and 7/32 on the hard one (``tests/test_wire.py:136``).  It
stays an opt-in codec for deployments that trade accuracy for bandwidth;
the supported low-rate wire is mu-law.

Both device expansions take their values from tables their host twins
compute (mu-law's 256 codes, block4's scale steps), so every device gives
the host's bits.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_processing_tools_tpu_torch.ops._device import device_constant

MU = 255.0
_LOG1P_MU = float(np.log1p(MU))

_ENC_LUT: np.ndarray | None = None


def _encode_lut() -> np.ndarray:
    """int8 mu-law code for every int16 sample value, indexed by its uint16
    bits."""
    global _ENC_LUT
    if _ENC_LUT is None:
        idx = np.arange(65536, dtype=np.uint16).view(np.int16)
        x = idx.astype(np.float64) / 32768.0
        y = np.sign(x) * np.log1p(MU * np.abs(x)) / _LOG1P_MU
        _ENC_LUT = np.round(y * 127.0).astype(np.int8)
    return _ENC_LUT


def mulaw_encode(pcm_i16: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """int16 PCM -> mu-law int8 codes in [-127, 127] (a table lookup),
    written into ``out`` (int8, the input's shape) when it is given."""
    pcm_i16 = np.ascontiguousarray(pcm_i16, dtype=np.int16)
    codes = pcm_i16.view(np.uint16)
    if out is None:
        return _encode_lut()[codes]
    np.take(_encode_lut(), codes, out=out)
    return out


def mulaw_decode_np(codes_i8: np.ndarray) -> np.ndarray:
    """Host expansion: mu-law int8 codes -> float32 in [-1, 1]."""
    y = codes_i8.astype(np.float32) * (1.0 / 127.0)
    return np.sign(y) * np.expm1(np.abs(y) * _LOG1P_MU) * (1.0 / MU)


def mulaw_decode(codes_i8: torch.Tensor) -> torch.Tensor:
    """Device expansion: mu-law int8 codes -> float32 in [-1, 1], on the
    device of the codes.  There are 256 codes, so the expansion is a lookup
    in :func:`mulaw_decode_np`'s table: every device gives the host's bits
    (the JAX package's device ``expm1`` differs from NumPy's by up to an
    ulp)."""
    table = device_constant(("mulaw_decode",), codes_i8.device,
                            lambda: mulaw_decode_np(np.arange(-128, 128).astype(np.int8)))
    return table[codes_i8.to(torch.int64) + 128]


BLK4 = 64  # samples per scale block -> 4 + 16/64 = 4.25 bits/sample


def block4_encode(pcm_i16: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int16 PCM -> (packed uint8 codes (..., n/2), uint16 scales (..., n/64)).

    Per 64-sample block: scale = max|x| (uint16), codes = round(x/scale * 7)
    in [-7, 7], two codes per byte (low nibble first).  n must be a
    multiple of 64, else ``ValueError``.
    """
    x = np.ascontiguousarray(pcm_i16, dtype=np.int16)
    n = x.shape[-1]
    if n % BLK4:
        raise ValueError(f"length {n} must be a multiple of {BLK4}")
    xb = x.reshape(x.shape[:-1] + (n // BLK4, BLK4)).astype(np.int32)
    scale = np.max(np.abs(xb), axis=-1).astype(np.uint16)  # (..., n/64)
    s = np.maximum(scale, 1).astype(np.float32)[..., None]
    q = np.rint(xb.astype(np.float32) * (7.0 / s)).astype(np.int8)
    qu = (q + 8).astype(np.uint8).reshape(x.shape[:-1] + (n,))
    packed = (qu[..., 0::2] | (qu[..., 1::2] << 4)).astype(np.uint8)
    return packed, scale


def block4_decode_np(packed: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Host expansion: packed int4 codes + block scales -> float32 in [-1, 1]."""
    lo = (packed & 0xF).astype(np.int32) - 8
    hi = (packed >> 4).astype(np.int32) - 8
    q = np.stack([lo, hi], axis=-1).reshape(packed.shape[:-1] + (-1,))
    nb = scales.shape[-1]
    qb = q.reshape(q.shape[:-1] + (nb, BLK4)).astype(np.float32)
    s = scales.astype(np.float32)[..., None] * (1.0 / (7.0 * 32768.0))
    return (qb * s).reshape(q.shape)


def _block4_scale_table() -> np.ndarray:
    """The float32 step of every uint16 block scale, as
    :func:`block4_decode_np` rounds it."""
    return np.arange(65536, dtype=np.uint16).astype(np.float32) * (1.0 / (7.0 * 32768.0))


def block4_decode(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Device expansion: packed int4 codes (uint8, (..., n/2)) + block scales
    (uint16, int16 or int32, (..., n/64); NumPy or tensors) -> float32 (..., n) in [-1, 1], on the
    device of the codes.  The scale's float32 step is a lookup in
    :func:`block4_decode_np`'s table and the code times the step one float32
    product, so every device gives the host's bits."""
    packed = torch.as_tensor(packed)
    table = device_constant(("block4_scale",), packed.device, _block4_scale_table)
    codes = packed.to(torch.int32)
    q = torch.stack([(codes & 0xF) - 8, (codes >> 4) - 8], dim=-1)
    q = q.reshape(packed.shape[:-1] + (-1,))
    nb = scales.shape[-1]
    qb = q.reshape(q.shape[:-1] + (nb, BLK4)).to(torch.float32)
    # widened to int64 indices; an int16 view of the uint16 bits is masked back
    idx = torch.as_tensor(scales, device=packed.device).to(torch.int64) & 0xFFFF
    return (qb * table[idx][..., None]).reshape(q.shape)
