"""The mu-law wire of the live server (G.711 companding at 8 bits).

Counterpart of ``audio_processing_tools_tpu/ops/wire.py:30-90``: the
encode table (``_encode_lut``), :func:`mulaw_encode` (host, a table lookup
per sample), :func:`mulaw_decode_np` (host) and :func:`mulaw_decode` (a
tensor expansion on the device of its input).  A client that companding its
PCM sends half the bytes of int16; the server expands.  The block-scaled
int4 wire (``block4_*``) is not ported: it was rejected on evidence
(``tests/test_wire.py:136``).
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


def mulaw_encode(pcm_i16: np.ndarray) -> np.ndarray:
    """int16 PCM -> mu-law int8 codes in [-127, 127] (a table lookup)."""
    pcm_i16 = np.ascontiguousarray(pcm_i16, dtype=np.int16)
    return _encode_lut()[pcm_i16.view(np.uint16)]


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
