"""The firmware's per-minute DSD vectors on the card, as tensor math.

Counterpart of ``audio_processing_tools_tpu/host_analysis/dsd_device.py``
(``:40-287``).  The emulator (``dsd_emulator.py``) walks frame by frame in
NumPy; here each minute's 32 + 30 + 38 vector comes from all of its frames
at once, for a batch of recordings:

  * |FFT| of the minute's (T, 512) frames (``torch.fft``);
  * loudness: a count histogram over log-binned rain-band energy;
  * pft: per 2-second slot, the most frequent per-frame peak bin (the
    emulator's running peak histogram resets at each slot boundary, so a
    slot's last written value is the argmax of its own counts; ties take
    the lowest bin, as ``np.argmax`` and ``torch.argmax`` do);
  * fft windows: the peak energy summed per bin, log-scaled.

The counts are integers below 2**24, so a scatter-add gives them exactly in
any order.  The peak-energy sums are floats that are then floored into log
bins, so they are summed in one fixed order with no atomics: each window
bin's one-hot plane over the minute's frames, reduced by
:func:`~audio_processing_tools_tpu_torch.ops.stats.tree_sum` (the card and
the CPU give the same sums).  Against the float64 emulator the fft bins may
differ by one where an FFT's last bits cross a log-bin edge.

The frame -> minute and frame -> slot schedules are the emulator's
timestamp arithmetic on the host.  Duty cycling
(:func:`dsd_minutes_device_duty_cycled`) keeps the emulator's minute chain
on the host and runs each processed segment on the device.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from audio_processing_tools_tpu_torch.host_analysis.dsd_emulator import DsdProcessingEmulator
from audio_processing_tools_tpu_torch.ops._device import f32, f32_recip
from audio_processing_tools_tpu_torch.ops.stats import tree_sum


def _minute_schedule(n_samples: int, fs: int, frame_length: int
                     ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """(frame index, pft slot) arrays per minute at ts = 0, the emulator's
    ``get_frames_to_next_interval`` arithmetic (``dsd_device.py:40-74``); a
    trailing partial minute is processed and emits a vector."""
    emu = DsdProcessingEmulator(fs, frame_length, frame_length, False, 0)
    emu.set_audio_timestamp(0, n_samples)
    hop = frame_length
    minutes_frames, minutes_slots = [], []
    pos_frames = 0
    total_frames = n_samples // hop
    while True:
        t_next = emu.rain_chk_period_seconds - (emu.ts_current % emu.rain_chk_period_seconds)
        if t_next < hop / fs:
            t_next += emu.rain_chk_period_seconds
        frames = int(t_next * fs / hop)
        partial = pos_frames + frames > total_frames
        if partial:
            frames = total_frames - pos_frames
            if frames <= 0:
                break
        idxs = np.arange(pos_frames, pos_frames + frames)
        ts = idxs * hop / fs
        minutes_frames.append(idxs)
        minutes_slots.append(((ts % 60.0) / 2.0).astype(np.int64))
        pos_frames += frames
        emu.frame_count += frames
        emu.ts_current = emu.frame_count * hop / fs
        if partial:
            break
    return minutes_frames, minutes_slots


def _dsd_minute(frames: torch.Tensor, *, fs: int, frame_length: int,
                slots: np.ndarray) -> torch.Tensor:
    """One minute's (B, T, frame_length) frames of B recordings -> the (B,
    100) vectors (``dsd_device.py:77-136``); ``slots`` (T,) is each frame's
    2-second slot."""
    emu = DsdProcessingEmulator(fs, frame_length, frame_length, False, 0)
    B, T, _ = frames.shape
    dev = frames.device
    nb = emu.fft_n_bins
    spec = torch.abs(torch.fft.rfft(frames.to(torch.float32), dim=-1))  # bins 0..nb

    # loudness: log-binned count histogram of rain-band energy
    drop_e = tree_sum(spec[..., emu.rain_low_idx : emu.rain_high_idx + 1])
    thr = f32(emu.rain_energy_threshold, dev)
    above = drop_e > thr
    rain_e = torch.clamp((drop_e - thr) * f32(emu.rain_log_factor, dev), min=0.0)
    hidx = torch.floor(torch.log1p(rain_e) * f32_recip(math.log(emu.rain_log_base), dev))
    hidx = torch.clamp(hidx, 0, emu.loudness_bins - 1).to(torch.int64)
    loudness = torch.zeros((B, emu.loudness_bins), device=dev).scatter_add_(
        1, hidx, above.to(torch.float32))

    # per-frame pft peak
    pk = torch.argmax(spec[..., emu.pft_low_idx : emu.pft_high_idx], dim=-1) + emu.pft_low_idx
    pk_energy = torch.gather(spec, -1, pk[..., None])[..., 0]
    valid = pk_energy != 0

    # pft slots: per-slot peak counts -> argmax; slots without frames keep 0
    slot_t = torch.from_numpy(np.asarray(slots, np.int64)).to(dev)
    counts = torch.zeros((B, emu.pft_bins * nb), device=dev).scatter_add_(
        1, slot_t[None, :] * nb + pk, valid.to(torch.float32))
    pft_vals = torch.argmax(counts.reshape(B, emu.pft_bins, nb), dim=-1).to(torch.float32)
    has_frames = np.bincount(np.asarray(slots, np.int64), minlength=emu.pft_bins) > 0
    pft_vals = torch.where(torch.from_numpy(has_frames[: emu.pft_bins]).to(dev), pft_vals, 0.0)

    # fft windows: accumulated peak energy of the window bins, log-scaled;
    # each bin's sum over the frames in one fixed pairwise order
    half = emu.fft_bins // 2
    lower = np.arange(emu.lwin_start_idx, min(emu.lwin_start_idx + half, nb))
    upper = (np.zeros(0, np.int64) if emu.hwin_start_idx == emu.lwin_end_idx
             else np.arange(emu.hwin_start_idx, min(emu.hwin_start_idx + half, nb)))
    win = torch.from_numpy(np.concatenate([lower, upper]).astype(np.int64)).to(dev)
    energy = torch.where(valid, pk_energy, 0.0)
    freq_hist = tree_sum(torch.where(pk[:, None, :] == win[None, :, None],
                                     energy[:, None, :], 0.0))  # (B, bins)
    j = torch.clamp(torch.floor(torch.log(freq_hist + f32(2.719, dev)) * f32(25.0, dev)),
                    max=255.0)
    parts = [loudness, pft_vals, j]
    if upper.size == 0:
        parts.append(torch.zeros((B, half), device=dev))
    return torch.cat(parts, dim=-1)


def _as_rows(audio, device) -> Tuple[torch.Tensor, bool]:
    x = audio if torch.is_tensor(audio) else torch.from_numpy(np.asarray(audio, np.float32))
    x = x.to(device=torch.device(device), dtype=torch.float32)
    return (x[None, :], True) if x.dim() == 1 else (x, False)


def dsd_minutes_device_duty_cycled(audio, fs: int = 11162, frame_length: int = 512,
                                   ts: float = 0.0, device: str | torch.device = "cuda"):
    """Duty-cycled per-minute DSD vectors, each processed segment on
    ``device`` (``dsd_device.py:139-249``).

    The firmware's default mode: minute m processes its full frames when
    minute m-1 saw rain, else only the last-3 s rain-check window, and
    ``raining`` is decided anew from the emitted loudness bins.  The frame
    alignment depends on that chain too (the check loop has no
    ``t < hop/fs`` boundary push), so the emulator's control flow runs on
    the host and each segment (a minute, or a check window of 65-66
    frames) is one :func:`_dsd_minute` on the device.  Returns a list of
    100-bin vectors for (n,) input, a list of such lists for (B, n).
    """
    x, squeeze = _as_rows(audio, device)
    n = int(x.shape[-1])
    outs = []

    emu0 = DsdProcessingEmulator(fs, frame_length, frame_length, False, 0)
    hop = frame_length
    period = float(emu0.rain_chk_period_seconds)
    duration = float(emu0.rain_chk_duration_seconds)
    L = emu0.loudness_bins

    def segment_vec(row, f0: int, f1: int, fc0: int, ts0: float) -> np.ndarray:
        """Frames [f0, f1) of this recording; the emulator's per-frame slot
        uses the global timestamp ``ts0 + (fc0 + i) * hop / fs``."""
        frame_ts = ts0 + (fc0 + np.arange(f1 - f0)) * hop / fs
        slots = ((frame_ts % period) / 2.0).astype(np.int64)
        frames = x[row, f0 * hop : f1 * hop].reshape(1, f1 - f0, hop)
        return _dsd_minute(frames, fs=fs, frame_length=frame_length, slots=slots)[0].cpu().numpy()

    for b in range(x.shape[0]):
        vectors = []
        # emulator state for ts-aligned recordings (set_audio_timestamp)
        ts_start = ts - (ts % period)
        ts_cur = float(ts)
        fc = int((ts % period) * fs / hop)
        f_pos = 0  # frames consumed from this recording
        raining = True
        num_minutes = math.ceil(n / (fs * period))
        if n < frame_length:
            outs.append(vectors)
            continue
        ok = True
        for _ in range(int(num_minutes)):
            remaining = (n - f_pos * hop) // hop
            if raining:
                t_next = period - (ts_cur % period)
                if t_next < hop / fs:
                    t_next += period
                seg = min(int(t_next * fs / hop), remaining)
                if (n - f_pos * hop) < frame_length:
                    seg = 0
                vec = (segment_vec(b, f_pos, f_pos + seg, fc, ts_start)
                       if seg > 0 else np.zeros(100))
                f_pos += seg
                fc += seg
                ts_cur = ts_start + fc * hop / fs
            else:
                t_next = period - (ts_cur % period)
                if t_next < hop / fs:
                    t_next += period
                rct = ts_cur + t_next - duration
                # skip to the rain-check window
                while ts_cur < rct:
                    f_pos += 1
                    fc += 1
                    ts_cur = ts_start + fc * hop / fs
                    if (n - f_pos * hop) < frame_length:
                        ok = False
                        break
                if not ok:
                    break
                f0 = f_pos
                while ts_cur < rct + duration:
                    if (n - f_pos * hop) >= frame_length:
                        f_pos += 1
                        fc += 1
                        ts_cur = ts_start + fc * hop / fs
                    else:
                        ok = False
                        break
                if not ok:
                    break
                vec = segment_vec(b, f0, f_pos, fc - (f_pos - f0), ts_start).copy()
                # the emulator's check path never calls calculate_fft_energies:
                # the 38 fft-window bins stay zero
                vec[L + emu0.pft_bins :] = 0.0
            vectors.append(vec)
            raining = bool(np.any(vec[:L] != 0))
            if (n - f_pos * hop) < frame_length:
                break
        outs.append(vectors)
    return outs[0] if squeeze else outs


def dsd_minutes_device(audio, fs: int = 11162, frame_length: int = 512,
                       device: str | torch.device = "cuda") -> np.ndarray:
    """Per-minute DSD vectors on ``device``, always raining
    (``dsd_device.py:252-287``).

    ``audio`` is (n,) or (B, n) float in [-1, 1], NumPy or a tensor; returns
    (M, 100) or (B, M, 100) float32 for the M minutes at ts = 0 (the last
    one partial), in one copy to the host.  Integer bins match the emulator;
    fft bins may differ by one at a log-bin edge.
    """
    x, squeeze = _as_rows(audio, device)
    n = x.shape[-1]
    minutes_frames, minutes_slots = _minute_schedule(n, fs, frame_length)
    if not minutes_frames:
        out = np.zeros((x.shape[0], 0, 100))
        return out[0] if squeeze else out
    vecs = []
    for idxs, slots in zip(minutes_frames, minutes_slots):
        lo = int(idxs[0]) * frame_length
        hi = (int(idxs[-1]) + 1) * frame_length
        frames = x[:, lo:hi].reshape(x.shape[0], len(idxs), frame_length)
        vecs.append(_dsd_minute(frames, fs=fs, frame_length=frame_length, slots=slots))
    out = torch.stack(vecs, dim=1).cpu().numpy()  # (B, M, 100)
    return out[0] if squeeze else out
