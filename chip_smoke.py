#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one line each:

  1. card and build: the card's name and power limit (nvidia-smi), then the
     hand-written kernels compiled from ``audio_processing_tools_tpu_torch/csrc``;
  2. K1 (spectrogram) against its plain version at the production batch,
     128 clips x 10 s at 11,162 Hz, at the other geometries it takes, and on
     float64 and strided inputs;
  3. K2 (noise PSD tracker) and K3 (flux baseline) against their plain loops
     at the shapes the main path gives them;
  4. the main path: 128 synthetic clips (half noise, half sharp damped pings)
     written as MARK files, parsed on the host to int16, moved to the card,
     scaled by 1/32767 and run through ``RainDetectorProcessor.run_batch``,
     with the launch count of every kernel read around it;
  5. agreement of the card with the port's plain path on the CPU, 16 clips;
  6. timings with CUDA events: each kernel beside its plain version, and the
     main-path batch.

Then one JSON line with the kernels' numbers, and last the device line
``{"ok": true, "device": {...}}``.  Any failed check, a missing card or a
missing package exits non-zero before the device line.  The script imports
nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

FS = 11162
CLIP_SEC = 10.0
BATCH = 128
N_AGREE = 16
PARAMS = {
    "sample_rate": FS,
    "clip_rain_min_frames": 3,
    "detector": {"mode_bands": [(450.0, 650.0), (800.0, 1050.0), (1500.0, 1800.0),
                                (2350.0, 2550.0), (3150.0, 3350.0)]},
    "classifier_only_mode": True,
}
PING_MODES = ((520.0, 1.0), (900.0, 0.5), (1600.0, 0.35), (2450.0, 0.25))


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def synth_clips(seed: int = 0):
    """Half noise clips, half noise plus sharp damped multi-mode pings
    (decay 40-60 samples), as float32 in [-1, 1]; labels say which."""
    rng = np.random.default_rng(seed)
    n = int(FS * CLIP_SEC)
    k = np.arange(800)
    clips = np.empty((BATCH, n), np.float32)
    labels = np.zeros(BATCH, bool)
    for i in range(BATCH):
        if i % 2 == 0:
            clips[i] = 0.02 * rng.standard_normal(n)
            continue
        x = 0.006 * rng.standard_normal(n)
        decay = rng.uniform(40.0, 60.0)
        ping = np.exp(-k / decay) * sum(a * np.sin(2 * np.pi * f * k / FS) for f, a in PING_MODES)
        for t0 in rng.integers(FS // 4, n - 1000, int(8 * CLIP_SEC)):
            x[t0 : t0 + 800] += rng.uniform(0.3, 0.5) * ping
        clips[i] = np.clip(x, -1.0, 1.0)
        labels[i] = True
    return clips, labels


def cuda_times(fn, iters: int) -> list:
    """Milliseconds of each of ``iters`` back-to-back calls on the card
    (CUDA events around each call), after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, stop in events:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(stop) for start, stop in events]


def in_turns(plain, kernel, iters_plain: int, iters_kernel: int):
    """Plain, kernel, kernel, plain; the median ms of each side's calls."""
    p = cuda_times(plain, iters_plain)
    k = cuda_times(kernel, iters_kernel) + cuda_times(kernel, iters_kernel)
    p += cuda_times(plain, iters_plain)
    return float(np.median(k)), float(np.median(p))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from audio_processing_tools_tpu_torch import _kernels
    from audio_processing_tools_tpu_torch.config import build_noise_config
    from audio_processing_tools_tpu_torch.io.mark import (
        parse_mark_audio_file,
        write_mark_audio_file,
    )
    from audio_processing_tools_tpu_torch.models.frame_classifier import (
        BandGeometry,
        FrameClass,
        _mode_flux,
    )
    from audio_processing_tools_tpu_torch.models.spectral_noise import (
        RainDetectorProcessor,
        SpectralNoiseEngine,
    )
    from audio_processing_tools_tpu_torch.ops import trackers as ttr
    from audio_processing_tools_tpu_torch.ops.spectrogram import spectrogram_power
    from audio_processing_tools_tpu_torch.ops.stft import stft_power

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    # ---- 1. card and build -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    lib = _kernels.build()
    usage = [ln.strip() for ln in lib.build_log.splitlines() if "registers" in ln]
    print(f"phase 1 card+build: {name} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | nvcc build {lib.build_seconds:.1f} s -> {lib.path}")
    for ln in usage:
        print(f"  ptxas: {ln}")

    cfg = build_noise_config(FS, PARAMS)
    geo = BandGeometry(cfg)
    clips, labels = synth_clips()
    t0 = time.perf_counter()
    files = [write_mark_audio_file((c * 32767.0).astype(np.int16), sample_rate=FS,
                                   timestamp=1700000000 + i, device_id=f"DEV{i:05d}")
             for i, c in enumerate(clips)]
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pcm = np.stack([parse_mark_audio_file(f)[0] for f in files])
    decode_s = time.perf_counter() - t0
    check(pcm.dtype == np.int16 and pcm.shape == clips.shape, f"decoded {pcm.dtype} {pcm.shape}")
    pcm_dev = torch.from_numpy(pcm).to(dev)
    x = pcm_dev.to(torch.float32) / 32767.0
    N = x.shape[-1]

    # ---- 2. K1 against its plain version ----------------------------------
    P_kernel = spectrogram_power(x)
    P_plain = stft_power(x)
    torch.cuda.synchronize()
    k1_abs = float((P_kernel - P_plain).abs().max())
    k1_rel = k1_abs / float(P_plain.abs().max())
    check(P_kernel.shape == P_plain.shape == (BATCH, 129, 1 + N // 128),
          f"K1 shape {tuple(P_kernel.shape)}")
    check(k1_rel < 1e-5, f"K1 max|d|/max {k1_rel:.3e} >= 1e-5")
    print(f"phase 2 K1 spectrogram_power {tuple(x.shape)} -> {tuple(P_kernel.shape)}: "
          f"max|d|/max = {k1_rel:.3e} (bound 1e-5), max|d| = {k1_abs:.3e}")
    # other geometries the wrapper accepts: a 1-D clip of odd length, rows
    # of odd length (every other row is not 16-byte aligned), every n_fft
    # from 64 to 1024, a shorter hop, no centering, clips shorter than n_fft,
    # and a batch of 4 work items (fewer than the SMs) whose T = 40 is not a
    # multiple of the frame tile
    flat = x.reshape(-1)
    for shape, n_fft, hop, center in (((FS + 37,), 256, 128, True), ((3, 5001), 512, 128, True),
                                      ((3, 5001), 256, 64, False), ((4, 20001), 1024, 128, True),
                                      ((3, 5001), 64, 32, True), ((3, 5001), 128, 64, False),
                                      ((3, 100), 256, 128, True), ((2, 700), 1024, 256, True),
                                      ((2, 5001), 256, 128, True)):
        xs = flat[: int(np.prod(shape))].reshape(shape)
        got = spectrogram_power(xs, n_fft=n_fft, hop=hop, center=center)
        ref = stft_power(xs, n_fft=n_fft, hop=hop, center=center)
        rel = float((got - ref).abs().max()) / float(ref.abs().max())
        check(got.shape == ref.shape and rel < 1e-5,
              f"K1 at {shape} n_fft={n_fft} hop={hop} center={center}: {rel:.3e}")
        print(f"  K1 {shape} n_fft={n_fft} hop={hop} center={center} -> {tuple(got.shape)}: "
              f"max|d|/max = {rel:.3e}")
    # inputs the wrapper must make float32 and contiguous first
    for label, xs in (("float64 copy", x[:4].double()), ("strided view x[:, ::2]", x[:4, ::2])):
        got = spectrogram_power(xs)
        ref = stft_power(xs)
        rel = float((got - ref).abs().max()) / float(ref.abs().max())
        check(got.shape == ref.shape and rel < 1e-5, f"K1 on a {label}: {rel:.3e}")
        print(f"  K1 {label} {tuple(xs.shape)} {xs.dtype} -> {tuple(got.shape)}: "
              f"max|d|/max = {rel:.3e}")

    # ---- 3. K2 and K3 against their plain loops ----------------------------
    rows = slice(int(geo.band_rows[0]), int(geo.band_rows[-1]) + 1)
    P_band = P_plain[:, rows, :].contiguous()
    B_, K, T = P_band.shape
    psd = ttr.make_psd_params(
        cfg_q=cfg.q, win_sec=cfg.win_sec, frames_per_sec=FS / cfg.hop, ema_up=cfg.ema_up,
        ema_down=cfg.ema_down, eps=cfg.eps, noise_psd_max_ratio=cfg.noise_psd_max_ratio)
    gen = torch.Generator(device=dev).manual_seed(1)
    rain_cases = {"no rain (main path)": torch.zeros((B_, T), dtype=torch.bool, device=dev),
                  "random rain": torch.rand((B_, T), generator=gen, device=dev) < 0.2}
    k2_abs = k2_rel = 0.0
    for label, is_rain in rain_cases.items():
        got = ttr._noise_psd_track_cuda(P_band, is_rain, psd)
        ref = ttr._noise_psd_track_plain(P_band, is_rain, psd)
        torch.cuda.synchronize()
        d = float((got - ref).abs().max())
        r = d / max(float(ref.abs().max()), 1e-30)
        print(f"  K2 {label}: max|d| = {d:.3e}, max|d|/max = {r:.3e}")
        k2_abs, k2_rel = max(k2_abs, d), max(k2_rel, r)
    check(k2_rel <= 1e-6, f"K2 max|d|/max {k2_rel:.3e} > 1e-6")

    eng = SpectralNoiseEngine(cfg, device=dev)
    P_det = eng._detector_input(P_band, FS)
    _, _, flux_modes, by_mode = _mode_flux(P_det, geo.mode_masks, geo.primary_mask, None)
    stacked = torch.cat([flux_modes[:, None, :], by_mode], dim=1).contiguous()
    bc = ttr._baseline_consts(20.0, FS / cfg.hop, 0.5, 0.0, 1.0)
    got = ttr._baseline_cuda(stacked, bc)
    ref = ttr._baseline_plain(stacked, bc)
    torch.cuda.synchronize()
    k3_abs = float((got - ref).abs().max())
    k3_rel = k3_abs / float(ref.abs().max())
    check(k3_rel <= 1e-6, f"K3 max|d|/max {k3_rel:.3e} > 1e-6")
    print(f"phase 3 K2 noise_psd_track {tuple(P_band.shape)}: max|d|/max = {k2_rel:.3e}; "
          f"K3 causal_low_quantile_baseline {tuple(stacked.shape)}: max|d|/max = "
          f"{k3_rel:.3e} (bounds 1e-6)")

    # ---- 4. the main path --------------------------------------------------
    proc = RainDetectorProcessor(device=dev)
    proc.run_batch(x[:2], PARAMS)  # warm the engine cache and the allocator
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    x_main = torch.from_numpy(pcm).to(dev).to(torch.float32) / 32767.0
    pairs = proc.run_batch(x_main, PARAMS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    check(all(v > 0 for v in launches.values()), f"a kernel did not run: {launches}")
    fc = np.stack([s["frame_class"] for _, s in pairs])
    rc = np.stack([s["rain_conf"] for _, s in pairs])
    check(fc.shape == (BATCH, T) and rc.shape == (BATCH, T), f"outputs {fc.shape}")
    check(np.isfinite(rc).all() and set(np.unique(fc)) <= {0, 1, 2}, "non-finite or bad classes")
    counts = np.array([m["rain_frame_count"] for m, _ in pairs])
    decisions = np.array([m["clip_is_rain"] for m, _ in pairs])
    check(np.array_equal(counts, (fc == int(FrameClass.RAIN)).sum(-1)), "rain_frame_count")
    accuracy = float((decisions == labels).mean())
    check(accuracy == 1.0, f"clip decisions agree with the labels on {accuracy:.4f}")
    print(f"phase 4 main path {BATCH} x {CLIP_SEC:.0f} s: launches {launches}; "
          f"rain clips {int(decisions.sum())}/{BATCH} (labels {int(labels.sum())}), "
          f"accuracy {accuracy:.4f}; mean rain_frame_count {counts.mean():.2f}, "
          f"mean rain_conf {rc.mean():.5f}; wall {wall_s * 1e3:.1f} ms incl. host copy; "
          f"MARK write {write_s * 1e3:.0f} ms, decode {decode_s * 1e3:.0f} ms")

    # ---- 5. agreement with the CPU path -------------------------------------
    pick = np.r_[np.arange(0, BATCH, 2)[: N_AGREE // 2], np.arange(1, BATCH, 2)[: N_AGREE // 2]]
    x_cpu = torch.from_numpy(pcm[pick]).to(torch.float32) / 32767.0
    cpu_pairs = RainDetectorProcessor(device="cpu").run_batch(x_cpu, PARAMS)
    fc_cpu = np.stack([s["frame_class"] for _, s in cpu_pairs])
    agree = float((fc_cpu == fc[pick]).mean())
    same_dec = all(cpu_pairs[j][0]["clip_is_rain"] == pairs[i][0]["clip_is_rain"]
                   for j, i in enumerate(pick))
    same_cnt = all(cpu_pairs[j][0]["rain_frame_count"] == pairs[i][0]["rain_frame_count"]
                   for j, i in enumerate(pick))
    print(f"phase 5 agreement with the CPU path on {N_AGREE} clips: frame agreement "
          f"{agree:.6f} ({int((fc_cpu != fc[pick]).sum())} of {fc_cpu.size} frames differ), "
          f"clip decisions identical {same_dec}, rain_frame_count identical {same_cnt}")
    check(same_dec and same_cnt and agree >= 0.9999, "GPU and CPU paths disagree")

    # ---- 6. timings ----------------------------------------------------------
    k1_ms, k1_plain = in_turns(lambda: stft_power(x), lambda: spectrogram_power(x), 20, 20)
    no_rain = rain_cases["no rain (main path)"]
    k2_ms, k2_plain = in_turns(lambda: ttr._noise_psd_track_plain(P_band, no_rain, psd),
                               lambda: ttr._noise_psd_track_cuda(P_band, no_rain, psd), 2, 20)
    k3_ms, k3_plain = in_turns(lambda: ttr._baseline_plain(stacked, bc),
                               lambda: ttr._baseline_cuda(stacked, bc), 2, 20)
    def step():
        return eng.process_batch(pcm_dev.to(torch.float32) / 32767.0)

    steps = cuda_times(step, 30)
    step_ms = float(np.median(steps))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(30):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 30 * 1e3
    audio_s = BATCH * CLIP_SEC
    # K1 reads each sample and writes each power value once
    k1_gbs = 4 * (x.numel() + P_kernel.numel()) / k1_ms / 1e6
    print(f"phase 6 timings on {smi}, medians: K1 {k1_ms:.4f} ms (plain {k1_plain:.4f}, "
          f"n=40/40) = {k1_gbs:.0f} GB/s, {k1_gbs / 3350:.1%} of 3.35 TB/s; K2 {k2_ms:.3f} ms "
          f"(plain {k2_plain:.3f}, n=40/4), K3 {k3_ms:.3f} ms "
          f"(plain {k3_plain:.3f}, n=40/4); main path {step_ms:.3f} ms per {BATCH} x "
          f"{CLIP_SEC:.0f} s batch (min {min(steps):.3f}, max {max(steps):.3f}, n=30) = "
          f"{audio_s / (step_ms / 1e3):.1f} audio-s/s, int16 on the card -> frame classes; "
          f"host clock over 30 back-to-back batches {host_ms:.3f} ms per batch = "
          f"{audio_s / (host_ms / 1e3):.1f} audio-s/s")

    pkg = "audio_processing_tools_tpu_torch/csrc/"
    kernels = [
        {"name": "spectrogram_power", "route": "cuda", "source": pkg + "spectrogram_power.cu",
         "replaces": "audio_processing_tools_tpu/ops/spectrogram.py:77",
         "launches": launches["spectrogram_power"], "max_abs_err": k1_abs,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "noise_psd_track", "route": "cuda", "source": pkg + "trackers.cu",
         "replaces": "audio_processing_tools_tpu/ops/trackers.py:121",
         "launches": launches["noise_psd_track"], "max_abs_err": k2_abs,
         "ms": k2_ms, "plain_ms": k2_plain},
        {"name": "causal_low_quantile_baseline", "route": "cuda", "source": pkg + "trackers.cu",
         "replaces": "audio_processing_tools_tpu/ops/trackers.py:30",
         "launches": launches["causal_low_quantile_baseline"], "max_abs_err": k3_abs,
         "ms": k3_ms, "plain_ms": k3_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
