"""Sequence parallelism for very long single recordings.

Counterpart of ``audio_processing_tools_tpu/parallel/sequence.py``: the
*time* axis of one recording is cut into one span per mesh entry (the audio
analogue of context parallelism).  Overlapped framing (``hop < n_fft``)
makes span boundaries need a halo: shard i's frames, anchored at their start
sample, reach ``n_fft - hop`` samples into span i+1, so shard i gets the
head of span i+1 copied to its device (zeros on the last shard), the
``ppermute`` ring of the JAX ``shard_map``.  Each shard's span plus halo
goes through the spectrogram kernel K1 with causal framing
(``ops/spectrogram.py::spectrogram_power(center=False)``); shards on one
device are stacked into one launch.  The per-frame flux features take a
2-frame history halo from the left neighbour the same way.

As in JAX, everything runs in one process: nothing calls these functions
across processes.  Outputs equal the unsharded causal computation (each
frame sees the same samples).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from audio_processing_tools_tpu_torch.ops.spectrogram import spectrogram_power
from audio_processing_tools_tpu_torch.ops.stft import fft_frequencies
from audio_processing_tools_tpu_torch.parallel.mesh import Mesh, _device_groups


def _as_float32(x) -> torch.Tensor:
    x = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    return x.to(torch.float32)


def _with_halos(spans: Sequence[torch.Tensor], devices: Sequence[torch.device],
                overlap: int) -> List[torch.Tensor]:
    """Span i on device i with the first ``overlap`` samples of span i+1
    appended (zeros after the last span): (..., n_loc + overlap) each."""
    out = []
    for i, (span, dev) in enumerate(zip(spans, devices)):
        span = span.to(dev)
        if i + 1 < len(spans):
            halo = spans[i + 1][..., :overlap].to(dev)
        else:
            halo = span.new_zeros(span.shape[:-1] + (overlap,))
        out.append(torch.cat([span, halo], dim=-1))
    return out


def _power_per_shard(shards: Sequence[torch.Tensor], n_fft: int, hop: int
                     ) -> List[torch.Tensor]:
    """K1 with causal framing on every shard (..., n_loc + overlap) ->
    (..., F, n_loc / hop), one launch for the shards on each device."""
    out: List[torch.Tensor] = [None] * len(shards)
    for _, idx in _device_groups(shards):
        lead = shards[idx[0]].shape[:-1]
        stacked = torch.stack([shards[i] for i in idx]).reshape(-1, shards[idx[0]].shape[-1])
        P = spectrogram_power(stacked, n_fft=n_fft, hop=hop, center=False)
        P = P.reshape((len(idx),) + tuple(lead) + tuple(P.shape[-2:]))
        for j, i in enumerate(idx):
            out[i] = P[j]
    return out


def _check_length(n: int, n_dev: int, hop: int, label: str = "n_devices*hop",
                  counts: bool = True) -> None:
    """JAX's length error; its flux function's message leaves out the counts."""
    if n % (n_dev * hop) != 0:
        detail = f" ({n_dev}*{hop})" if counts else ""
        raise ValueError(f"signal length {n} must be a multiple of {label}{detail}")


def sequence_sharded_stft_power(
    x, mesh: Mesh, *, n_fft: int = 256, hop: int = 128, axis: str = "files",
) -> torch.Tensor:
    """Causal |STFT|^2 of one long recording, time-sharded over the mesh.

    ``x`` length must be a multiple of ``n_devices * hop`` (the entries along
    ``axis``).  Returns ``(F, T)`` with ``T = n/hop - (n_fft/hop - 1)``
    frames (causal framing), on the first entry's device.
    """
    x = _as_float32(x)
    devs = mesh.axis_devices(axis)
    n = x.shape[-1]
    _check_length(n, len(devs), hop)
    n_loc = n // len(devs)
    spans = [x[i * n_loc:(i + 1) * n_loc] for i in range(len(devs))]
    P = _power_per_shard(_with_halos(spans, devs, n_fft - hop), n_fft, hop)
    # the last (n_fft/hop - 1) frames spill past the signal end (computed
    # from the zero right-halo on the final shard): drop them
    T = n // hop - (n_fft // hop - 1)
    return torch.cat([p.to(devs[0]) for p in P], dim=-1)[:, :T]


def batch_sequence_sharded_stft_power(
    xb, mesh: Mesh, *, n_fft: int = 256, hop: int = 128,
    files_axis: str = "files", seq_axis: str = "seq",
) -> torch.Tensor:
    """Composite 2-D sharding: clips over ``files`` (DP) x time over ``seq``
    (the CP analogue).

    ``xb`` is (B, n); B must divide the mesh's ``files`` extent and n must be
    a multiple of ``seq_extent * hop``.  The entry at (files i, seq j) holds
    a (B/files, n/seq) tile plus the ``n_fft - hop`` right halo of tile
    (i, j+1) (the ``files`` axis needs none).  Returns (B, F, T) on the
    mesh's first device, equal to the unsharded causal computation.
    """
    xb = _as_float32(xb)
    files_n = mesh.shape[files_axis]
    seq_n = mesh.shape[seq_axis]
    B, n = xb.shape
    if B % files_n != 0:
        raise ValueError(f"batch {B} must divide the '{files_axis}' extent {files_n}")
    _check_length(n, seq_n, hop, "seq_extent*hop")
    grid = np.moveaxis(mesh.devices, (mesh.axis_names.index(files_axis),
                                      mesh.axis_names.index(seq_axis)), (0, 1))
    grid = grid.reshape(files_n, seq_n, -1)[..., 0]
    b_loc, n_loc = B // files_n, n // seq_n
    shards = []
    for i in range(files_n):
        rows = xb[i * b_loc:(i + 1) * b_loc]
        spans = [rows[:, j * n_loc:(j + 1) * n_loc] for j in range(seq_n)]
        shards += _with_halos(spans, list(grid[i]), n_fft - hop)
    P = [p.to(grid[0, 0]) for p in _power_per_shard(shards, n_fft, hop)]
    T = n // hop - (n_fft // hop - 1)
    rows_out = [torch.cat(P[i * seq_n:(i + 1) * seq_n], dim=-1) for i in range(files_n)]
    return torch.cat(rows_out, dim=0)[..., :T]


def sequence_sharded_band_flux(
    x, mesh: Mesh, *, fs: int = 11162, n_fft: int = 256,
    hop: int = 128, mode_bands: Tuple[Tuple[float, float], ...] = (
        (450.0, 650.0), (800.0, 1050.0), (1500.0, 1800.0),
        (2350.0, 2550.0), (3150.0, 3350.0),
    ),
    axis: str = "files",
) -> Dict[str, torch.Tensor]:
    """Time-sharded heavy stage of the detector front-end for one long clip.

    Per shard: halo-exchange framing -> windowed FFT power (K1) -> band rows
    -> t-vs-(t-2) positive flux (a 2-frame halo of band power from the left
    neighbour) -> the mode-band sums (a float32 matrix product).  Returns
    per-frame band power (K, T) and mode flux (n_modes, T) on the mesh's
    first device.
    """
    x = _as_float32(x)
    devs = mesh.axis_devices(axis)
    n_dev = len(devs)
    n = x.shape[-1]
    _check_length(n, n_dev, hop, counts=False)
    freqs = fft_frequencies(fs, n_fft)
    band_rows = np.flatnonzero((freqs >= 400.0) & (freqs <= 3500.0))
    freqs_band = freqs[band_rows]
    masks = np.stack(
        [(freqs_band >= lo) & (freqs_band <= hi) for lo, hi in mode_bands]
    ).astype(np.float32)
    rows = slice(int(band_rows[0]), int(band_rows[-1]) + 1)  # one run of bins

    n_loc = n // n_dev
    T_loc = n_loc // hop
    spans = [x[i * n_loc:(i + 1) * n_loc] for i in range(n_dev)]
    P = _power_per_shard(_with_halos(spans, devs, n_fft - hop), n_fft, hop)
    Pb = [p[rows, :].T for p in P]  # (T_loc, K) per shard
    flux = []
    for i, dev in enumerate(devs):
        # frame halo: the t-2 flux history comes from the left neighbour
        pb_halo = Pb[i - 1][-2:].to(dev) if i else Pb[i].new_zeros((2, Pb[i].shape[1]))
        hist = torch.cat([pb_halo, Pb[i]], dim=0)  # (T_loc + 2, K)
        d2 = torch.clamp_min(Pb[i] - hist[:-2], 0.0)
        # global frames 0 and 1 are warm-up zeros
        gidx = i * T_loc + torch.arange(T_loc, device=dev)
        d2 = torch.where((gidx >= 2)[:, None], d2, 0.0)
        m = torch.as_tensor(masks, device=dev)
        flux.append(torch.matmul(d2, m.T))  # (T_loc, n_modes), float32 (no TF32)
    T = n // hop - (n_fft // hop - 1)
    return {
        "band_power": torch.cat([p.to(devs[0]) for p in Pb], dim=0)[:T].T,
        "mode_flux": torch.cat([f.to(devs[0]) for f in flux], dim=0)[:T].T,
    }
