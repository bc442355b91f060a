#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one line each:

  1. card and build: the card's name and power limit (nvidia-smi), then the
     hand-written kernels compiled from ``audio_processing_tools_tpu_torch/csrc``;
  2. K1 (spectrogram) against its plain version at the production batch,
     128 clips x 10 s at 11,162 Hz, at the other geometries it takes, and on
     float64 and strided inputs;
  3. K2 (noise PSD tracker) and K3 (flux baseline) against their plain loops,
     bit for bit: at the shapes the main path gives them (K2 with no rain,
     random rain and adaptive q, on the engine's band view of the
     spectrogram passed in as it is), and at ragged shapes (lanes not a
     multiple of the block, T not a multiple of the frame tile, T below it,
     T = 1, few rows) and on NaN and inf input;
  4. the main path: 128 synthetic clips (half noise, half sharp damped pings)
     written as MARK files, parsed on the host to int16, moved to the card,
     scaled by 1/32767 and run through ``RainDetectorProcessor.run_batch``,
     with the launch count of every kernel read around it;
  5. agreement of the card with the port's plain path on the CPU, 16 clips;
  6. timings with CUDA events: each kernel's device time per launch (a CUDA
     graph of back-to-back launches) and per host-launched call beside its
     plain version, and the main-path batch;
  7. K5 (gain smoothing) against its plain loop bit for bit, adaptive and
     not, on the gain the suppressor makes from the phase-4 clips at its shape
     (128, 71, 873) with random noise confidences and with the engine's own,
     on gains with inf, -inf and NaN and confidences exactly 0.7, and at
     (3, 71, 873), (2, 5, 1), (5, 7, 65) and (4, 33, 200);
  8. the engine's default configuration (the suppressor, no outputs beyond
     the decisions and noise-floor metrics) through ``run_batch`` on the same
     128 clips, with launch counts, and 16 clips against the CPU path;
  9. the suppressor with audio out (``compute_output_audio``) through
     ``SpectralNoiseEngine.process_batch``, with launch counts, and ``y`` of
     16 clips against the CPU path;
 10. the detector variants (peak gate, comb-filter and band-pass TD input,
     envelope features, clip occupancy, sparse dump) on 16 clips, card
     against CPU;
 11. timings of K5 beside its plain loop and of the two suppressor batches;
 12. the streaming kernels against their plain versions: K7 (the causal
     prefilter with state, ``sosfilt`` with ``zi``) bit for bit at 64 x
     22,272 and 64 x 22,271 (2 sections) and at 64 x 8,191 with 1, 4 and 8
     sections, zi nonzero, and within 1e-5 of scipy in float64 at 64 x
     22,272, K2 and K3 with
     their carries threaded over 1-, 4- and 174-frame chunks bit for bit
     against one call, and K8 (the streaming suppressor) at 64 streams x 174
     frames against its plain loop (gain and carries bit for bit, audio to
     float rounding), in five suppressor configurations (two raise the SNR
     gate to a power), and at n_fft 64 and 1,024; the device ms of K8's two
     launches (the walk, the frame pass) at 64 x 174 frames and at the
     low-latency profile's 16 x 4 and 16 x 8 frames;
 13. the live streaming path, 64 streams x 2 s x 15 chunks from int16 on the
     card through ``StreamingRainDetector.process_chunk_batch``, detector
     only and with denoised audio out, and the low-latency profile of 16
     streams x 512 and x 1,024 samples: kernel launches per chunk, ms per
     chunk (p50, p99) and audio-s/s;
 14. bitwise chunk invariance on the card, 8 streams, detector only and
     audio out: one whole chunk, 2 s chunks and three seeded random
     hop-multiple partitions give the same frame classes, rain confidence
     and audio, and the batched step gives each stream's single-stream bits
     (also with the SNR gate raised to the power 2);
 15. the card against the port's CPU path on those 8 streams: frame classes
     identical, audio within 1e-4 of its maximum;
 16. the live server on the card over loopback TCP with dynamic batching:
     three clients on a detector server (one on the mu-law wire) and one on
     an emit-audio server, every reply equal to direct ``process_chunk``
     results, batched calls made and no batch re-run;
 17. K4 (the cascade filter with the sequential block boundary) against its
     plain version bit for bit: high-pass then band-pass at the path's 128 x
     10 s from the seed states, and at 8 x 10 s from a nonzero state, y and
     the final state, at a whole and a partial last block; 512 x 17-sample
     chunks against one call; 128 x 10 s within 1e-5 of scipy in float64;
     the device ms of each of K4's three launches (drifts, walk, outputs);
 18. K6 (the band-noise estimator's scan) against its plain loop bit for bit
     (outputs and carry) at 128 clips x 218 frames, in five estimator
     configurations (one with a 64-slot ring, a 5-frame TTL and the
     replenish) and in two of them again with NaN, infinite and zero
     subframe energies, which its sorted view leaves to the rank count;
 19. the band-noise batch path: 128 synthetic 10 s clips (noise and 520 Hz
     bursts) through ``BandNoiseEstimatorProcessor.run_batch`` with launch
     counts (K1 1, K4 2, K6 1), 16 clips' FFT rain frames and rain subframes
     against the CPU path (agreement >= 0.999, N_E within 1e-5 of its max),
     K1 with the path's rectangular table against ``stft_power`` within 1e-5
     of max, whole clips against 512 x 17 chunks, single streams and single
     frames bit for bit on the card, and the batch's time; then K4 and K7,
     the two kernels of a cascade with a carried state, each timed at the
     other's shape, K4 within 1e-5 of K7 at the live one;
 20. the band-noise server on the card over loopback TCP with dynamic
     batching: every reply equal to direct ``band_noise_process_chunk``
     results, batched calls made and no batch re-run;
 21. K4 at the legacy RoE classifier's shapes against its plain version bit
     for bit: the order-8 operating band-pass (8 sections) over the 640
     chunk rows of 128 x 10 s (640 x 22,324) and the order-4 pulse
     band-pass over its padded output (640 x 22,580), both within 1e-5 of
     scipy in float64, with the device ms of each of K4's launches; K1 at
     (640, 22,324) against ``stft_power``;
 22. the RoE classifier at full width: 128 synthetic 10 s clips through
     ``roe_detect_batch(x, device="cuda")``, launches K1 1 and K4 2, 16
     clips against the port's CPU path (counts and ``frain_mean``
     identical, per-frame ``raining`` and ``rain_peaks`` agreement >=
     0.999), and the batch's time;
 23. the mel classifier at full width: 128 x 10 s through
     ``MelRainProcessor(device="cuda").run_batch``, launches K1 1, 16 clips
     against the CPU path (``clip_is_rain`` identical, ``frame_is_rain``
     agreement >= 0.999, mel power within 1e-5 of its maximum), and the
     batch's time;
 24. ALAC ingest at full width: 128 ALAC MARK files of 10 s built from the
     packets of ``tests/fixtures/alac_golden.bin`` (clip i rotates its full
     packets by i), decoded on the host by the fast decoder bit for bit
     against the same tiling of ``alac_golden_pcm.npy`` and timed, then the
     classifier-only ``run_batch`` on the card, identical to the same PCM
     read from version-0 MARK files;
 25. the wind and pitch tools once, card against CPU: the same energy-peak
     pulse list and gust times, EAC and pitch within 1e-5;
 26. K9 (the stage-2 confirmer's distance filter over peaks) against its
     plain loop bit for bit: on the confirmer's own rows of one phase-4
     clip (871 windows x 384, d = 45), also with non-finite peaks, and on
     rows of 3 to 1,024 positions with more than 64 maxima, equal heights,
     plateaus and no peak, at d 1, 7, 45 and caps 3, 64, 5,000, some at
     pointers that are not 16-byte aligned; on non-finite and signed-zero
     peaks, caps that fall among -inf and NaN ties, exactly 64 and 65
     peaks, rows of 1, 2 and 33 positions, distances from -5 to 10^6 and
     caps 0, -1 and -100; ``select_peaks_by_distance`` with max_peaks 0
     and -1 gives is_peak; its time from a graph of 20;
 27. the time-domain confirmer (five mode bands, stage 1 from phase 4's
     rain frames) on 16 clips, card against CPU (masks, counts and peak
     indices identical, crest and kurtosis within 1e-5), then the 128
     clips one by one through ``TimeDomainRainDetector.process`` on the
     card: ms per clip, launches (K9 one a clip), CUDA kernels and peak
     memory;
 28. ``dsd_minutes_device`` on 128 x 60 s on the card, 8 clips against the
     port's CPU path and the firmware emulator (bins 0-61 identical, fft
     bins within one and >= 95% equal), and the duty-cycled minutes of four
     200 s recordings bit-equal to the emulator;
 29. the transform ETL's per-minute RoE batch (16 recordings x 2 minutes;
     RoE's default 10 s check duration makes 5 chunk rows a minute, 160 in
     all) on the card, launches K1 1 and K4 2, counts identical to the CPU
     path and ``frain_mean`` within one ulp;
 30. ``NoiseProcessor`` and ``RainProcessor`` (over ``rain_detection_algo``)
     on 4 clips, card against CPU;
 31. the backfill corpus: 128 clips x 10 s from the port's
     ``make_labeled_corpus`` (16 of each of the five base classes, 12 of each
     of the four hard ones) written as MARK files into a temporary directory
     and read back through ``get_input_data``, on the host clock;
 32. the time-sharded K1 (``parallel/sequence.py``) on a mesh of four
     entries of the one card: a 60-minute recording (40,182,784 samples)
     through ``sequence_sharded_stft_power`` and ``sequence_sharded_band_flux``,
     and the corpus cut to 111,616 samples through
     ``batch_sequence_sharded_stft_power`` on a 2 x 2 (files, seq) mesh, each
     held against the unsharded causal K1 (the same bits, or within 1e-5 of
     max) and against the plain ``stft_power`` within 1e-5 of max; the band
     power and mode flux against a plain flux in float64 from the plain
     power (1e-5 and 1e-4 of max); with launches, times, peak memory and the
     sharded call's costliest CUDA kernels (torch.profiler);
 33. ``ShardedRainPipeline.step`` on a one-card mesh over the corpus for the
     spectral, RoE and band-noise models, with launches per step: 16 clips
     against the port's CPU path (spectral frames, counts and decisions
     identical; RoE counts identical, ``frain_mean`` within one ulp; band
     noise FFT rain frames >= 0.999), every per-clip output against the
     model's batched engine called directly (the same bits), ms per step,
     and the corpus's host-to-card copy: its host clock alone and the
     profiler's copy time inside a step;
 34. the orchestrator's pandas-free core ``run_batches`` with
     ``RainDetectorProcessor`` over the corpus directory: one device batch
     of 128 against the per-file path on the card and 16 files on the CPU
     (``rain_frame_count`` identical per file, and equal to phase 33), and
     files/s on the host clock;
 35. the backfill CLI on the card as subprocesses with ``--dsd`` and no
     ``--out``: one process, then two ranks on the one card over gloo; both
     ranks print the one process's aggregates, whose ``total_rain_frames``
     is phase 33's, with each run's wall seconds and audio-h/h;
 36. K10 (the threshold sweep's decision counts) against its plain version
     on phase 37's features: 4,096 combos x 128 clips x 873 frames, counts
     identical, and identical on a copy with a row of NaN frames and
     scattered NaN and inf, on 4,096 combos with every threshold distinct,
     on non-positive and NaN thresholds with support counts -1 to 4, on one
     combo, and at T = 1, 31, 33 and the most frames it takes; its time from
     a graph of 20 (the sweep, every threshold distinct, one combo) beside
     its bound, the work these inputs need;
 37. the spectral sweep end to end (``grid_search_vmapped``) on phase 31's
     corpus from int16 on the card: launches K1/K2/K3/K10 1/1/1/1, the
     features' and the counts' times, the best combo's accuracy; a 64-combo
     subgrid on 16 clips identical to the CPU; the sweep over a 4-entry mesh
     of the one card equal to the unsharded sweep;
 38. the gradient fits on the card, 300 Adam steps from a detuned start, on
     the hard corpus (``make_hard_corpus(seed=17)``) and on the 128 clips'
     features: ms a step, CUDA kernels a step, thresholds within 0.05 of the
     same fit on the CPU and the same accuracy; the tuned profile through
     ``RainDetectorProcessor`` on the hard corpus 28/32, the default 24/32;
 39. the RoE sweep on the corpus, 64 combos, launches K1 1 and K4 2, 4
     combos x 8 clips equal to ``rain_detection_algo``, 16 clips identical to
     the CPU, and the RoE fit from a detuned start;
 40. the native RoE library built by g++ with its version, its booleans
     against the port's RoE on the card on 8 clips, and the two-pass
     ``dsp_integ`` counts card against CPU.

Then one JSON line with the kernels' numbers (each with its bound at this
run's shapes, bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s,
whichever is larger, and for K1 the time of ``stft_power``, cuFFT and the
square, as its library call; no PyTorch call computes K2-K10's
functions), and last the device line ``{"ok": true, "device": {...}}``.
Any failed check, a missing card or a
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
# the engine's default configuration: the suppressor path
DEFAULT_PARAMS = {k: v for k, v in PARAMS.items() if k != "classifier_only_mode"}
# the suppressor with audio out, as the JAX bench measures it
AUDIO_PARAMS = {**DEFAULT_PARAMS, "compute_output_audio": True}
# outputs taken at an argmax, which a near tie may move to a neighbour
PICKS = ("_dominant_freq_hz", "_rolloff_hz", "td_block_peak_width_50",
         "td_block_post_pre_energy_ratio")
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


def graph_ms(fn, launches: int = 20, reps: int = 7) -> float:
    """Device ms of one call of ``fn``: ``launches`` calls captured in one
    CUDA graph, the graph replayed ``reps`` times between CUDA events, the
    median replay divided by ``launches``.  The captured kernels run back to
    back, so the host's work per call, which the card waits for when a
    kernel is shorter than it, is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture needs
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    return float(np.median(times))


def launch_breakdown(fn, calls: int = 20) -> dict:
    """Device ms per launch of each CUDA kernel one call of ``fn`` runs,
    from torch.profiler over ``calls`` calls after a warm-up call, by the
    kernel's name up to its template arguments or parameters."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            name = name.removeprefix("void ")[:60]
            out[name] = round(e.self_device_time_total / 1e3 / e.count, 4)
    return out


def same_bits(got, ref):
    """Whether two float32 tensors hold the same bits wherever either holds a
    number (the sign of zero included) and NaN in the same places, and
    max|got - ref| where both are finite.  NaN payloads are not compared:
    the compiler may canonicalise them."""
    import torch

    if got.shape != ref.shape:
        return False, float("inf")
    nan = torch.isnan(got)
    same = torch.equal(nan, torch.isnan(ref)) and torch.equal(
        got.contiguous().view(torch.int32)[~nan], ref.contiguous().view(torch.int32)[~nan])
    fin = torch.isfinite(got) & torch.isfinite(ref)
    return same, float((got - ref)[fin].abs().max()) if bool(fin.any()) else 0.0


def rel_err(got, ref) -> float:
    """max|got - ref| / max|ref|, on the host in float64."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)) if ref.size else 0.0


def to_host(tree):
    """Tensors of a nested output dict as NumPy arrays."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if hasattr(tree, "detach") else tree


def agreement(fc_card, fc_cpu, pairs_card, pairs_cpu, label: str) -> float:
    """Frame agreement of the card with the CPU path; clip decisions and
    rain_frame_count must be identical and frames agree on >= 0.9999."""
    frac = float((fc_card == fc_cpu).mean())
    same_dec = all(a[0]["clip_is_rain"] == b[0]["clip_is_rain"] for a, b in zip(pairs_card, pairs_cpu))
    same_cnt = all(a[0]["rain_frame_count"] == b[0]["rain_frame_count"]
                   for a, b in zip(pairs_card, pairs_cpu))
    check(same_dec and same_cnt and frac >= 0.9999,
          f"{label}: card and CPU disagree (frames {frac:.6f}, decisions {same_dec}, "
          f"counts {same_cnt})")
    return frac


def in_turns(plain, kernel, iters_plain: int, iters_kernel: int):
    """Plain, kernel, kernel, plain; the median ms of each side's calls."""
    p = cuda_times(plain, iters_plain)
    k = cuda_times(kernel, iters_kernel) + cuda_times(kernel, iters_kernel)
    p += cuda_times(plain, iters_plain)
    return float(np.median(k)), float(np.median(p))


def bound_of(nbytes: float, ops: float):
    """The least time of a kernel on the card, ``(ms, "bytes" or
    "operations")``: its bytes over 3.35 TB/s or its float32 operations over
    67 TFLOP/s, whichever is larger."""
    by_bytes, by_ops = nbytes / 3.35e12 * 1e3, ops / 67e12 * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def k4_work(xs, n_sections: int):
    """The work of the filter K4 computes over rows ``xs``, whatever its
    algorithm: x read and y written once; per sample and section the
    transposed direct form's 5 products and 4 sums."""
    return 4 * 2 * xs.numel(), xs.numel() * 9 * n_sections


def k4_tables(sos, n: int, dev):
    """K4's flat table and its plain version's tables for rows of ``n``
    samples, on ``dev``."""
    import torch

    from audio_processing_tools_tpu_torch.ops import filters as tfl

    P = n - (-(-n // 128) - 1) * 128
    flat = torch.as_tensor(tfl._k4_flat_tables(sos, P).astype(np.float32), device=dev)
    tabs = tuple(torch.as_tensor(np.asarray(t, np.float32), device=dev)
                 for t in tfl.cascade_scan_tables(sos, 128, P))
    return flat, tabs


def k4_pair(sos, xs, zi):
    """K4 and its plain version on the same rows: ``((y, zf), (y, zf))``."""
    import torch

    from audio_processing_tools_tpu_torch.ops import filters as tfl

    flat, tabs = k4_tables(sos, xs.shape[-1], xs.device)
    k = tfl._cascade_sosfilt_cuda(flat, xs, zi, sos.shape[0])
    p = tfl._cascade_sosfilt_plain(tabs, xs, zi)
    torch.cuda.synchronize()
    return k, p


STREAMS = 64  # live streams of the serving profile (the JAX bench's)
CHUNK = FS * 2 // 128 * 128  # 2 s lockstep chunks: 22,272 samples, 174 hops
CHUNKS = 15
LOWLAT = (16, (512, 1024))  # the low-latency profile: streams, chunk samples
STREAM_PARAMS = {"sample_rate": FS, "clip_rain_min_frames": 3,
                 "detector": PARAMS["detector"]}
STREAM_AUDIO = {**STREAM_PARAMS, "compute_output_audio": True}
# the suppressor's SNR gate raised to a power other than 1
STREAM_SNR_POW = {**STREAM_AUDIO, "snr_gating_enable": True, "snr_gating_power": 2.0}


def synth_streams(n_streams: int, seconds: float, seed: int = 5):
    """Live streams as int16: even ones noise, odd ones noise with sharp
    damped pings, as :func:`synth_clips` makes them; labels say which."""
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    k = np.arange(800)
    out = np.empty((n_streams, n), np.int16)
    labels = np.arange(n_streams) % 2 == 1
    for i in range(n_streams):
        x = (0.02 if i % 2 == 0 else 0.006) * rng.standard_normal(n)
        if labels[i]:
            decay = rng.uniform(40.0, 60.0)
            ping = np.exp(-k / decay) * sum(a * np.sin(2 * np.pi * f * k / FS) for f, a in PING_MODES)
            for t0 in rng.integers(FS // 4, n - 1000, int(8 * seconds)):
                x[t0 : t0 + 800] += rng.uniform(0.3, 0.5) * ping
        out[i] = (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)
    return out, labels


def run_stream(det, x, sizes, state=None):
    """Streams ``x`` (B, n) through chunks of ``sizes`` samples (cycled) with
    ``process_chunk_batch``; returns the outputs concatenated over time, on
    the host, and the final state."""
    import torch

    state = det.init_state_batch(x.shape[0]) if state is None else state
    outs, i, k = [], 0, 0
    while i < x.shape[1]:
        n = min(sizes[k % len(sizes)], x.shape[1] - i)
        state, out = det.process_chunk_batch(state, x[:, i : i + n])
        outs.append({key: out[key].cpu() for key in ("frame_class", "rain_conf", "y") if key in out})
        i += n
        k += 1
    return {key: torch.cat([o[key] for o in outs], dim=-1) for key in outs[0]}, state


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
    # every case must give the plain loop's bits
    rows = slice(int(geo.band_rows[0]), int(geo.band_rows[-1]) + 1)
    P_view = P_plain[:, rows, :]  # the engine's band view, read in place by K2
    P_band = P_view.contiguous()
    B_, K, T = P_band.shape
    psd_kw = dict(cfg_q=cfg.q, win_sec=cfg.win_sec, frames_per_sec=FS / cfg.hop,
                  ema_up=cfg.ema_up, ema_down=cfg.ema_down, eps=cfg.eps,
                  noise_psd_max_ratio=cfg.noise_psd_max_ratio)
    psd = ttr.make_psd_params(**psd_kw)
    psd_aq = ttr.make_psd_params(**psd_kw, adaptive_q_enable=True,
                                 adaptive_q_min=cfg.adaptive_q_min,
                                 adaptive_q_alpha=cfg.adaptive_q_alpha)
    gen = torch.Generator(device=dev).manual_seed(1)

    def rand_rain(n, t):
        return torch.rand((n, t), generator=gen, device=dev) < 0.2

    no_rain = torch.zeros((B_, T), dtype=torch.bool, device=dev)
    main_rain = rand_rain(B_, T)
    P_nonfinite = P_band[:4].clone()
    P_nonfinite[0, 3, 100], P_nonfinite[1, 0, 0] = float("nan"), float("nan")
    P_nonfinite[2, 5, 17], P_nonfinite[3, K - 1, T - 1] = float("inf"), float("inf")
    k2_cases = [
        ("main, no rain, band view (main path)", P_view, no_rain, psd),
        ("main, no rain, contiguous", P_band, no_rain, psd),
        ("main, random rain, band view", P_view, main_rain, psd),
        ("main, random rain, adaptive q, band view", P_view, main_rain, psd_aq),
        # an EMA rate above 1 can make the EMA negative, for the clamp at 0
        ("main, random rain, EMA rate 1.1", P_view, main_rain, psd._replace(ema_up=1.1)),
    ]
    # ragged: lanes not a multiple of the block, T not a multiple of the
    # tile, T < tile, T = 1, one lane per clip (a rain row per lane)
    for label, Pc in (("127 clips x 71, T 100 (lanes % 32 = 25)", P_plain[:127, rows, :100]),
                      ("7 clips x 71 (497 lanes, 2 a block)", P_view[:7]),
                      ("3 clips x 5 bins (15 lanes)", P_view[:3, :5]),
                      ("T 128 (two whole tiles)", P_view[..., :128]),
                      ("T 50 < tile", P_view[..., :50]),
                      ("T 1", P_view[..., :1]),
                      ("9088 clips x 1 bin", P_band.reshape(-1, 1, T)),
                      ("NaN and inf", P_nonfinite)):
        rain = rand_rain(Pc.shape[0], Pc.shape[-1])
        k2_cases += [(label, Pc, rain, psd), (label + ", adaptive q", Pc, rain, psd_aq)]
    k2_abs = 0.0
    for label, Pc, is_rain, params in k2_cases:
        plan = ttr.tracker_launch_plan("noise_psd_track", Pc.shape[0] * Pc.shape[1], Pc.shape[-1])
        got = ttr._noise_psd_track_cuda(Pc, is_rain, params)
        ref = ttr._noise_psd_track_plain(Pc, is_rain, params)
        torch.cuda.synchronize()
        same, d = same_bits(got, ref)
        check(same, f"K2 {label}: not the plain loop's bits (max|d| = {d:.3e})")
        print(f"  K2 {label} {tuple(Pc.shape)} strides {Pc.stride()}, {plan.lanes_per_block} "
              f"lanes x {plan.grid} blocks: same bits, max|d| = {d:.3e}")
        k2_abs = max(k2_abs, d)

    eng = SpectralNoiseEngine(cfg, device=dev)
    P_det, _ = eng._detector_input(P_view, FS)
    _, _, flux_modes, by_mode = _mode_flux(P_det, geo.mode_masks, geo.primary_mask, None)
    stacked = torch.cat([flux_modes[:, None, :], by_mode], dim=1).contiguous()
    bc = ttr._baseline_consts(20.0, FS / cfg.hop, 0.5, 0.0, 1.0)
    flat = stacked.reshape(-1, T)
    bad = flat[:16].clone()
    bad[0, 40], bad[3, 7], bad[5, 0] = float("nan"), float("inf"), float("nan")
    k3_abs = 0.0
    for label, xr in (("main (main path)", stacked), ("7 rows", flat[:7]),
                      ("768 rows x T 100", flat[:, :100].contiguous()),
                      ("765 rows (765 % 4 = 1)", flat[:765]),
                      ("T 50 < tile", flat[:, :50].contiguous()),
                      ("T 1", flat[:, :1].contiguous()), ("NaN and inf", bad)):
        plan = ttr.tracker_launch_plan("causal_low_quantile_baseline",
                                       xr.numel() // xr.shape[-1], xr.shape[-1])
        got = ttr._baseline_cuda(xr, bc)
        ref = ttr._baseline_plain(xr, bc)
        torch.cuda.synchronize()
        same, d = same_bits(got, ref)
        check(same, f"K3 {label}: not the plain loop's bits (max|d| = {d:.3e})")
        print(f"  K3 {label} {tuple(xr.shape)}, {plan.lanes_per_block} rows x {plan.grid} "
              f"blocks: same bits, max|d| = {d:.3e}")
        k3_abs = max(k3_abs, d)
    print(f"phase 3 K2 noise_psd_track {tuple(P_view.shape)}: {len(k2_cases)} cases, the plain "
          f"loop's bits, max|d| = {k2_abs:.3e}; K3 causal_low_quantile_baseline "
          f"{tuple(stacked.shape)}: 7 cases, the plain loop's bits, max|d| = {k3_abs:.3e}")

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
    check(launches == {**launches, "spectrogram_power": 1, "noise_psd_track": 1,
                       "causal_low_quantile_baseline": 1, "gain_time_smooth": 0,
                       "sosfilt_zi": 0, "streaming_suppressor": 0, "cascade_sosfilt": 0,
                       "band_noise_scan": 0},
          f"classifier-only launches {launches}")
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
    # each kernel's device time from a graph of back-to-back launches, and
    # per host-launched call (as PRs 1-3 timed them) in turns with its plain
    # version, whose loops of small launches are timed per call only
    k1_call, k1_plain = in_turns(lambda: stft_power(x), lambda: spectrogram_power(x), 20, 20)
    k2_call, k2_plain = in_turns(lambda: ttr._noise_psd_track_plain(P_view, no_rain, psd),
                                 lambda: ttr._noise_psd_track_cuda(P_view, no_rain, psd), 2, 20)
    k3_call, k3_plain = in_turns(lambda: ttr._baseline_plain(stacked, bc),
                                 lambda: ttr._baseline_cuda(stacked, bc), 2, 20)
    k1_ms = graph_ms(lambda: spectrogram_power(x))
    # K1's library call: cuFFT on the framed, windowed clips, then the square
    k1_lib = graph_ms(lambda: stft_power(x))
    k2_ms = graph_ms(lambda: ttr._noise_psd_track_cuda(P_view, no_rain, psd))
    k3_ms = graph_ms(lambda: ttr._baseline_cuda(stacked, bc))
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
    print(f"phase 6 timings on {smi}, medians, device ms per launch from a graph of 20 "
          f"(per host-launched call, n=40; plain per call): K1 {k1_ms:.4f} ms ({k1_call:.4f}; "
          f"plain {k1_plain:.4f}, n=40) = {k1_gbs:.0f} GB/s, {k1_gbs / 3350:.1%} of 3.35 TB/s; "
          f"library stft_power {k1_lib:.4f} ms in a graph of 20; "
          f"K2 {k2_ms:.4f} ms ({k2_call:.4f}; plain {k2_plain:.3f}, n=4), K3 {k3_ms:.4f} ms "
          f"({k3_call:.4f}; plain {k3_plain:.3f}, n=4); main path {step_ms:.3f} ms per {BATCH} x "
          f"{CLIP_SEC:.0f} s batch (min {min(steps):.3f}, max {max(steps):.3f}, n=30) = "
          f"{audio_s / (step_ms / 1e3):.1f} audio-s/s, int16 on the card -> frame classes; "
          f"host clock over 30 back-to-back batches {host_ms:.3f} ms per batch = "
          f"{audio_s / (host_ms / 1e3):.1f} audio-s/s")

    # ---- 7. K5 against its plain loop ----------------------------------------
    from audio_processing_tools_tpu_torch.models import spectral_noise as tsn

    cfg_sup = build_noise_config(FS, DEFAULT_PARAMS)
    dbg = SpectralNoiseEngine(build_noise_config(FS, {**DEFAULT_PARAMS, "return_debug": True}),
                              device=dev).process_batch(x)
    G_freq = tsn.gain_freq_stage(
        cfg_sup, dbg["debug"]["P_band_all"],
        torch.minimum(dbg["debug"]["N_band_all"], dbg["debug"]["P_band_all"]),
        dbg["noise_conf"]).contiguous()
    nc_rand = torch.rand((BATCH, T), generator=gen, device=dev)
    nc_eng = torch.clamp(dbg["noise_conf"], 0.0, 1.0).contiguous()  # as compute_gain clips it
    del dbg
    cfg_fixed = build_noise_config(FS, {**DEFAULT_PARAMS, "adaptive_gain_enable": False})
    # non-finite gains, and noise confidences exactly at the 0.7 threshold
    G_odd = G_freq[:8].clone()
    G_odd[0, 3, 100:110], G_odd[1, 0, 0] = float("inf"), float("nan")
    G_odd[2, 5, 17:19], G_odd[3, K - 1, T - 1] = float("-inf"), float("nan")
    G_odd[4, 7, ::50] = float("inf")
    nc_odd = nc_rand[:8].clone()
    nc_odd[:, ::3] = 0.7
    nc_odd[5, :] = 0.7
    k5_cases = [
        ("main, random noise_conf", G_freq, nc_rand),
        ("main, the engine's noise_conf", G_freq, nc_eng),
        ("8 clips, inf/-inf/NaN gains, noise_conf 0.7", G_odd, nc_odd),
        ("3 clips x 71 x 873", G_freq[:3].contiguous(), nc_rand[:3].contiguous()),
        ("2 clips x 5 x 1", G_freq[:2, :5, :1].contiguous(), nc_rand[:2, :1].contiguous()),
        ("5 clips x 7 x 65 (one tile + 1)", G_freq[:5, :7, :65].contiguous(),
         nc_rand[:5, :65].contiguous()),
        ("4 clips x 33 x 200", G_freq[:4, :33, :200].contiguous(), nc_eng[:4, :200].contiguous()),
    ]
    k5_abs = 0.0
    for label, G_c, nc_c in k5_cases:
        for mode, c in (("adaptive", cfg_sup), ("non-adaptive", cfg_fixed)):
            got = tsn._gain_time_smooth_cuda(G_c, nc_c, c)
            ref = tsn._gain_time_smooth_plain(G_c, nc_c, c)
            torch.cuda.synchronize()
            same, d = same_bits(got, ref)
            check(same, f"K5 {label}, {mode}: not the plain loop's bits (max|d| {d:.3e})")
            k5_abs = max(k5_abs, d)
        print(f"  K5 {label} {tuple(G_c.shape)}: adaptive and non-adaptive the plain loop's bits")
    print(f"phase 7 K5 gain_time_smooth {tuple(G_freq.shape)} and {len(k5_cases) - 1} other "
          f"cases: the plain loop's bits where values are numbers, NaN in the same places")

    # ---- 8. default configuration: the suppressor ---------------------------
    proc.run_batch(x[:2], DEFAULT_PARAMS)  # warm the engine cache
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    pairs_def = proc.run_batch(torch.from_numpy(pcm).to(dev).to(torch.float32) / 32767.0,
                               DEFAULT_PARAMS)
    torch.cuda.synchronize()
    wall_def = time.perf_counter() - t0
    launches_def = dict(_kernels.LAUNCHES)
    check(launches_def == {**launches_def, "spectrogram_power": 1, "noise_psd_track": 2,
                           "causal_low_quantile_baseline": 1, "gain_time_smooth": 0,
                           "sosfilt_zi": 0, "streaming_suppressor": 0, "cascade_sosfilt": 0,
                       "band_noise_scan": 0},
          f"default-configuration launches {launches_def}")
    fc_def = np.stack([st["frame_class"] for _, st in pairs_def])
    floors = np.array([[m["mean_noise_floor_db"], m["median_noise_floor_db"]] for m, _ in pairs_def])
    check(fc_def.shape == (BATCH, T) and np.isfinite(floors).all(), "default-configuration outputs")
    dec_def = np.array([m["clip_is_rain"] for m, _ in pairs_def])
    check(float((dec_def == labels).mean()) == 1.0, "default-configuration clip decisions")
    cpu_def = RainDetectorProcessor(device="cpu").run_batch(x_cpu, DEFAULT_PARAMS)
    frac_def = agreement(fc_def[pick], np.stack([st["frame_class"] for _, st in cpu_def]),
                     [pairs_def[i] for i in pick], cpu_def, "default configuration")
    floor_rel = max(abs(pairs_def[i][0][k] - cpu_def[j][0][k]) / abs(cpu_def[j][0][k])
                    for j, i in enumerate(pick)
                    for k in ("mean_noise_floor_db", "median_noise_floor_db"))
    check(floor_rel <= 1e-5, f"noise-floor metrics differ by {floor_rel:.3e} relative")
    print(f"phase 8 default configuration {BATCH} x {CLIP_SEC:.0f} s via run_batch: launches "
          f"{launches_def}; rain clips {int(dec_def.sum())}/{BATCH}; mean noise floor "
          f"{floors[:, 0].mean():.3f} dB, median {floors[:, 1].mean():.3f} dB; wall "
          f"{wall_def * 1e3:.1f} ms; against the CPU path on {N_AGREE} clips: frame agreement "
          f"{frac_def:.6f}, decisions and counts identical, noise floors within "
          f"{floor_rel:.3e} relative (bound 1e-5)")

    # ---- 9. the suppressor with audio out ------------------------------------
    eng_audio = SpectralNoiseEngine(build_noise_config(FS, AUDIO_PARAMS), device=dev)
    eng_audio.process_batch(x[:2])  # warm
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    out_audio = eng_audio.process_batch(torch.from_numpy(pcm).to(dev).to(torch.float32) / 32767.0)
    y_rms = torch.sqrt(torch.mean(out_audio["y"] ** 2, dim=-1)).cpu().numpy()
    wall_audio = time.perf_counter() - t0
    launches_audio = dict(_kernels.LAUNCHES)
    check(launches_audio == {**launches_audio, "spectrogram_power": 0, "noise_psd_track": 2,
                             "causal_low_quantile_baseline": 1, "gain_time_smooth": 1,
                             "sosfilt_zi": 0, "streaming_suppressor": 0, "cascade_sosfilt": 0,
                       "band_noise_scan": 0},
          f"audio-out launches {launches_audio}")
    y_card = out_audio["y"]
    check(tuple(y_card.shape) == (BATCH, N) and bool(torch.isfinite(y_card).all()), "y")
    fc_audio = out_audio["frame_class"].cpu().numpy()
    # the complex STFT's power takes K1's place here: frames may differ in ulps
    frac_paths = float((fc_audio == fc_def).mean())
    check(frac_paths >= 0.9999, f"audio-out and default frame classes agree on {frac_paths:.6f}")
    cpu_audio = SpectralNoiseEngine(build_noise_config(FS, AUDIO_PARAMS),
                                    device="cpu").process_batch(x_cpu)
    y_rel = rel_err(y_card[pick].cpu().numpy(), cpu_audio["y"].numpy())
    frac_audio = float((fc_audio[pick] == cpu_audio["frame_class"].numpy()).mean())
    check(y_rel <= 1e-4 and frac_audio >= 0.9999,
          f"audio out: y max|d|/max {y_rel:.3e} (bound 1e-4), frames {frac_audio:.6f}")
    x_rms = torch.sqrt(torch.mean(out_audio["x_filt"] ** 2, dim=-1)).cpu().numpy()
    del out_audio, y_card
    print(f"phase 9 suppressor with audio out {BATCH} x {CLIP_SEC:.0f} s via process_batch: "
          f"launches {launches_audio}; y_rms noise clips {y_rms[~labels].mean():.6f} "
          f"(x_filt {x_rms[~labels].mean():.6f}), ping clips {y_rms[labels].mean():.6f} "
          f"(x_filt {x_rms[labels].mean():.6f}); frames agree with phase 8 on {frac_paths:.6f}; "
          f"wall {wall_audio * 1e3:.1f} ms; against the "
          f"CPU path on {N_AGREE} clips: y max|d|/max {y_rel:.3e} (bound 1e-4), frame "
          f"agreement {frac_audio:.6f}")

    # ---- 10. detector variants, card against CPU ------------------------------
    det = PARAMS["detector"]
    variants = {
        "peak gate": ({"return_detector_debug": True, "detector": {**det, "peak_features_enable": True}},
                      ("det_debug/peak_",)),
        "comb_filter TD input": ({"return_detector_debug": True,
                                  "detector": {**det, "td_input_mode": "comb_filter"}},
                                 ("det_debug/td_crest", "det_debug/td_kurt", "det_debug/td_block")),
        "bandpass TD input": ({"return_detector_debug": True,
                               "detector": {**det, "td_input_mode": "bandpass"}},
                              ("det_debug/td_crest", "det_debug/td_kurt", "det_debug/td_block")),
        "envelope features": ({"return_detector_debug": True,
                               "detector": {**det, "td_envelope_features_enable": True}},
                              ("det_debug/td_rise", "det_debug/td_fall", "det_debug/td_energy",
                               "det_debug/td_peak")),
        "clip occupancy": ({"return_detector_debug": True, "dump_features": True,
                            "detector": {**det, "clip_spectral_occupancy_enable": True,
                                         "feature_dump_level": 1,
                                         "feature_dump_clip_summary_enable": True}},
                           ("det_debug/clip_spectral_occupancy", "features/clip_spectral_occupancy")),
        "sparse dump top": ({"dump_features": True,
                             "detector": {**det, "feature_dump_level": 1,
                                          "feature_dump_sparse_enable": True,
                                          "feature_dump_sparse_select": "top"}},
                            ("features/sparse_",)),
        "sparse dump first": ({"dump_features": True,
                               "detector": {**det, "feature_dump_level": 1,
                                            "feature_dump_sparse_enable": True}},
                              ("features/sparse_",)),
    }
    x16 = x[torch.as_tensor(pick, device=dev)]
    for label, (extra, prefixes) in variants.items():
        params = {**PARAMS, **extra}
        card = to_host(SpectralNoiseEngine(build_noise_config(FS, params), device=dev)
                       .process_batch(x16))
        cpu = to_host(SpectralNoiseEngine(build_noise_config(FS, params), device="cpu")
                      .process_batch(x_cpu))
        check(np.array_equal(card["frame_class"], cpu["frame_class"]), f"{label}: frame classes")
        worst, n_keys, picks = 0.0, 0, []

        def walk(a, b, path):
            nonlocal worst, n_keys
            if isinstance(b, dict):
                for k in b:
                    walk(a[k], b[k], f"{path}/{k}" if path else k)
                return
            if not path.startswith(prefixes):
                return
            n_keys += 1
            a, b = np.asarray(a), np.asarray(b)
            check(a.shape == b.shape, f"{label}: {path} shape {a.shape} != {b.shape}")
            if b.dtype.kind in "biu":
                check(np.array_equal(a, b), f"{label}: {path} differs")
                return
            bound = 1e-4 if any(t in path for t in ("/td_", "flux", "cepstrum")) else 1e-5
            if path.endswith(PICKS):
                # a value at an argmax over bins or blocks: where two are
                # within rounding of each other the card and the CPU may pick
                # neighbours, so each value is held to the bound and all but
                # one in a thousand must meet it
                ok = float((np.abs(a - b) <= bound * max(np.abs(b).max(), 1e-30)).mean())
                check(ok >= 0.999, f"{label}: {path} within {bound:.0e} on {ok:.6f} < 0.999")
                picks.append(f"{path.rsplit('/', 1)[-1]} {ok:.6f}")
                return
            r = rel_err(a, b)
            check(r <= bound, f"{label}: {path} max|d|/max {r:.3e} > {bound:.0e}")
            worst = max(worst, r)

        walk(card, cpu, "")
        check(n_keys > 0, f"{label}: no outputs compared")
        print(f"  {label}: frame classes identical, {n_keys} outputs compared, integers "
              f"identical, floats max|d|/max {worst:.3e}"
              + (f"; argmax picks within bound on {', '.join(picks)}" if picks else ""))
    print(f"phase 10 detector variants on {N_AGREE} clips: card and CPU agree")

    # ---- 11. K5 and suppressor timings ----------------------------------------
    k5_call, k5_plain = in_turns(lambda: tsn._gain_time_smooth_plain(G_freq, nc_rand, cfg_sup),
                                 lambda: tsn._gain_time_smooth_cuda(G_freq, nc_rand, cfg_sup), 2, 20)
    k5_ms = graph_ms(lambda: tsn._gain_time_smooth_cuda(G_freq, nc_rand, cfg_sup))
    eng_def = proc._engine({**DEFAULT_PARAMS, **{k: False for k in (
        "compute_output_audio", "return_filtered_audio", "return_spectra", "return_debug",
        "return_detector_debug", "return_noise_psd")}})
    batch_times = {}
    for label, e in (("default configuration", eng_def), ("audio out", eng_audio)):
        def batch(e=e):
            return e.process_batch(pcm_dev.to(torch.float32) / 32767.0)

        times = cuda_times(batch, 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            batch()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / 20 * 1e3
        med = float(np.median(times))
        batch_times[label] = (med, min(times), max(times), host)
    print(f"phase 11 timings on {smi}, medians: K5 {k5_ms:.4f} ms per launch in a graph "
          f"({k5_call:.4f} per host-launched call, n=40; plain {k5_plain:.3f}, n=4); "
          + "; ".join(
              f"{label} {med:.3f} ms per {BATCH} x {CLIP_SEC:.0f} s batch (min {lo:.3f}, max "
              f"{hi:.3f}, n=20) = {audio_s / (med / 1e3):.1f} audio-s/s, host clock {host:.3f} "
              f"ms per batch = {audio_s / (host / 1e3):.1f} audio-s/s"
              for label, (med, lo, hi, host) in batch_times.items()))

    stream = streaming_phases(smi)
    band = band_noise_phases(smi)
    more = roe_mel_alac_phases(smi)
    td = confirmer_dsd_etl_phases(smi, pcm, fc == int(FrameClass.RAIN))
    fleet = backfill_phases(smi)
    tune = tuning_phases(smi, fleet["corpus"], fleet["truth"])

    paths = {**more["launches"], **td["launches"], **fleet["launches"], **tune["launches"]}
    launches_all = {k: launches[k] + launches_def[k] + launches_audio[k] + stream["launches"][k]
                    + band["launches"][k] + sum(v[k] for v in paths.values())
                    for k in launches}
    print(f"launches per driven path: classifier-only {launches}, default {launches_def}, "
          f"audio out {launches_audio}, streaming (all chunks of phase 13) {stream['launches']}, "
          f"band noise (phase 19) {band['launches']}, "
          + ", ".join(f"{path} {v}" for path, v in paths.items()))
    pkg = "audio_processing_tools_tpu_torch/csrc/"
    # bounds at this run's shapes: bytes read once and written once over
    # 3.35 TB/s, operations over the 67 TFLOP/s of float32 outside the
    # tensor cores; the larger binds.  Operations per item: K1 per frame the
    # window (n_fft), the half-length FFT (5 M log2 M, M = n_fft/2) and the
    # split and power (13 per bin); K2 20, K3 12, K5 8 per lane and frame;
    # K10 per clip one compare a distinct threshold and frame and one word
    # operation a combo and 32 frames, each counted as 2 (phase 36).
    M = 128
    work = {
        "spectrogram_power": (4 * (x.numel() + P_kernel.numel()),
                              BATCH * T * (2 * M + 5 * M * np.log2(M) + 13 * (M + 1))),
        "noise_psd_track": (8 * P_band.numel() + B_ * T, 20 * P_band.numel()),
        "causal_low_quantile_baseline": (8 * stacked.numel(), 12 * stacked.numel()),
        "gain_time_smooth": (8 * G_freq.numel() + 4 * nc_rand.numel(), 8 * G_freq.numel()),
        "sosfilt_zi": stream["work"]["sosfilt_zi"],
        "streaming_suppressor": stream["work"]["streaming_suppressor"],
        "cascade_sosfilt": band["work"]["cascade_sosfilt"],
        "band_noise_scan": band["work"]["band_noise_scan"],
        "select_peaks_by_distance": td["k9"]["work"],
        "decision_sweep": tune["k10"]["work"],
    }

    def bound(kernel, library_ms=None):
        ms, by = bound_of(*work[kernel])
        # one PyTorch call computes K1's function (stft_power); none computes
        # any of the others
        return {"bound_ms": ms, "bound_by": by, "library_ms": library_ms}

    kernels = [
        {"name": "spectrogram_power", "route": "cuda", "source": pkg + "spectrogram_power.cu",
         "replaces": "audio_processing_tools_tpu/ops/spectrogram.py:77",
         "launches": launches_all["spectrogram_power"], "max_abs_err": k1_abs,
         "ms": k1_ms, "plain_ms": k1_plain, **bound("spectrogram_power", k1_lib)},
        {"name": "noise_psd_track", "route": "cuda", "source": pkg + "trackers.cu",
         "replaces": "audio_processing_tools_tpu/ops/trackers.py:121",
         "launches": launches_all["noise_psd_track"], "max_abs_err": k2_abs,
         "ms": k2_ms, "plain_ms": k2_plain, **bound("noise_psd_track")},
        {"name": "causal_low_quantile_baseline", "route": "cuda", "source": pkg + "trackers.cu",
         "replaces": "audio_processing_tools_tpu/ops/trackers.py:30",
         "launches": launches_all["causal_low_quantile_baseline"], "max_abs_err": k3_abs,
         "ms": k3_ms, "plain_ms": k3_plain, **bound("causal_low_quantile_baseline")},
        {"name": "gain_time_smooth", "route": "cuda", "source": pkg + "gain.cu",
         "replaces": "audio_processing_tools_tpu/models/spectral_noise.py:127",
         "launches": launches_all["gain_time_smooth"], "max_abs_err": k5_abs,
         "ms": k5_ms, "plain_ms": k5_plain, **bound("gain_time_smooth")},
        {"name": "sosfilt_zi", "route": "cuda", "source": pkg + "filters.cu",
         "replaces": "audio_processing_tools_tpu/ops/filters.py:290",
         "launches": launches_all["sosfilt_zi"], "max_abs_err": stream["err"]["sosfilt_zi"],
         "ms": stream["ms"]["sosfilt_zi"], "plain_ms": stream["plain_ms"]["sosfilt_zi"],
         **bound("sosfilt_zi")},
        {"name": "streaming_suppressor", "route": "cuda", "source": pkg + "streaming.cu",
         "replaces": "audio_processing_tools_tpu/models/streaming.py:373",
         "launches": launches_all["streaming_suppressor"],
         "max_abs_err": stream["err"]["streaming_suppressor"],
         "ms": stream["ms"]["streaming_suppressor"],
         "plain_ms": stream["plain_ms"]["streaming_suppressor"], **bound("streaming_suppressor"),
         # the walk's and the frame pass's device ms, and K8 at the
         # low-latency profile's chunks
         "launches_ms": stream["k8_launches_ms"], "low_latency_ms": stream["k8_low_latency_ms"]},
        {"name": "cascade_sosfilt", "route": "cuda", "source": pkg + "cascade.cu",
         "replaces": "audio_processing_tools_tpu/ops/filters.py:518",
         "launches": launches_all["cascade_sosfilt"],
         "max_abs_err": max(band["err"]["cascade_sosfilt"], more["k4_err"]),
         "ms": band["ms"]["cascade_sosfilt"], "plain_ms": band["plain_ms"]["cascade_sosfilt"],
         **bound("cascade_sosfilt"),
         # K4's time at each path's shapes (the entry's own ms is band noise's)
         "shapes": more["k4_shapes"], "launches_ms": band["k4_launches_ms"]},
        {"name": "band_noise_scan", "route": "cuda", "source": pkg + "band_noise.cu",
         "replaces": "audio_processing_tools_tpu/models/band_noise.py:358",
         "launches": launches_all["band_noise_scan"], "max_abs_err": band["err"]["band_noise_scan"],
         "ms": band["ms"]["band_noise_scan"], "plain_ms": band["plain_ms"]["band_noise_scan"],
         **bound("band_noise_scan")},
        # a mask: phase 26 holds every position to the plain version's bit
        {"name": "select_peaks_by_distance", "route": "cuda", "source": pkg + "peaks.cu",
         "replaces": "audio_processing_tools_tpu/ops/peaks.py:185",
         "launches": launches_all["select_peaks_by_distance"], "max_abs_err": 0.0,
         "ms": td["k9"]["ms"], "plain_ms": td["k9"]["plain_ms"],
         **bound("select_peaks_by_distance")},
        # integer counts: phase 36 holds every count to the plain version's
        {"name": "decision_sweep", "route": "cuda", "source": pkg + "sweep.cu",
         "replaces": "audio_processing_tools_tpu/tuning/grid_search.py:231",
         "launches": launches_all["decision_sweep"], "max_abs_err": 0.0,
         "ms": tune["k10"]["ms"], "plain_ms": tune["k10"]["plain_ms"],
         **bound("decision_sweep"),
         # K10 on 4,096 combos with every threshold distinct, and on one combo
         "distinct_ms": tune["k10"]["distinct_ms"], "one_combo_ms": tune["k10"]["one_combo_ms"]},
    ]
    for k in kernels:
        print(f"  {k['name']}: {k['ms']:.4f} ms, bound {k['bound_ms']:.4f} ms by {k['bound_by']} "
              f"({k['bound_ms'] / k['ms']:.1%} of it)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


def streaming_phases(smi: str) -> dict:
    """Phases 12-16: the live streaming path (K7, K8 and the carry forms of
    K2 and K3 beside K1) and its server.  Returns the launches of phase 13,
    and each new kernel's error, times and work for the kernels line."""
    import socket
    import threading

    import scipy.signal as ss
    import torch

    from audio_processing_tools_tpu_torch import _kernels
    from audio_processing_tools_tpu_torch.cli import serve
    from audio_processing_tools_tpu_torch.models import streaming as tsm
    from audio_processing_tools_tpu_torch.ops import filters as tfl
    from audio_processing_tools_tpu_torch.ops import trackers as ttr
    from audio_processing_tools_tpu_torch.ops.spectrogram import spectrogram_power
    from audio_processing_tools_tpu_torch.ops.wire import mulaw_decode_np, mulaw_encode

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(12)
    pcm, labels = synth_streams(STREAMS, CHUNK * CHUNKS / FS)
    pcm_dev = torch.from_numpy(pcm).to(dev)

    def detector(params, device=dev):
        det = tsm.StreamingRainDetector(device=device)
        det.setup(dict(params))
        return det

    def chunk(c, rows=STREAMS, length=CHUNK):
        return pcm_dev[:rows, c * length : (c + 1) * length].to(torch.float32) / 32767.0

    # ---- 12. K7, K2/K3 carries and K8 against their plain versions ----------
    det = detector(STREAM_AUDIO)
    st = det._static()
    x0 = chunk(0)
    S = st.td_sos.shape[0]
    coef = torch.from_numpy(tfl._sos_coefficients(st.td_sos)).to(dev)
    zi = 0.01 * torch.randn((STREAMS, S, 2), generator=gen, device=dev)
    # the plain loop's bits at the live shape, at a length that is neither a
    # multiple of 4 nor of a tile, and at 1, 4 and 8 sections (a high-pass of
    # twice the order) over 8,191 samples, zi nonzero throughout
    k7_cases = [(coef, x0, zi), (coef, x0[:, : CHUNK - 1].contiguous(), zi)]
    for n_sec in (1, 4, 8):
        c = torch.from_numpy(tfl._sos_coefficients(
            tfl.butter_sos(2 * n_sec, 350.0 / (0.5 * FS), "highpass"))).to(dev)
        k7_cases.append((c, x0[:, :8191].contiguous(),
                         0.01 * torch.randn((STREAMS, n_sec, 2), generator=gen, device=dev)))
    k7_abs = 0.0
    for c, xs, z in k7_cases:
        y_k, zf_k = tfl._sosfilt_zi_cuda(c, xs, z)
        y_p, zf_p = tfl._sosfilt_zi_plain(c, xs, z)
        torch.cuda.synchronize()
        (same_y, d), (same_z, dz) = same_bits(y_k, y_p), same_bits(zf_k, zf_p)
        check(same_y and same_z, f"K7 at {tuple(xs.shape)}, {c.shape[0]} sections: not the plain "
                                 f"loop's bits (y {d:.3e}, zf {dz:.3e})")
        k7_abs = max(k7_abs, d, dz)
    y_k, zf_k = tfl._sosfilt_zi_cuda(coef, x0, zi)
    y_sp, zf_sp = ss.sosfilt(st.td_sos, x0.double().cpu().numpy(), axis=-1,
                             zi=zi.double().cpu().numpy().transpose(1, 0, 2))
    k7_rel = rel_err(y_k.cpu().numpy(), y_sp)
    k7_zrel = rel_err(zf_k.cpu().numpy(), zf_sp.transpose(1, 0, 2))
    check(k7_rel <= 1e-5 and k7_zrel <= 1e-5,
          f"K7 at {tuple(x0.shape)} against scipy float64: y {k7_rel:.3e}, zf {k7_zrel:.3e}")
    print(f"  K7 sosfilt_zi: the plain loop's bits (y and zf) at {tuple(x0.shape)} and "
          f"{(STREAMS, CHUNK - 1)} ({S} sections) and at {(STREAMS, 8191)} with 1, 4 and 8 "
          f"sections, zi nonzero; {tuple(x0.shape)} against scipy in float64: y max|d|/max "
          f"{k7_rel:.3e}, zf {k7_zrel:.3e} (bound 1e-5)")

    xa0 = torch.cat([torch.zeros((STREAMS, st.n_fft - st.hop), device=dev), x0], dim=1)
    P0 = spectrogram_power(xa0, center=False)
    P_band = P0[:, st.rows, :]
    T = P_band.shape[-1]
    cuts = {"1-frame": [1] * T, "4-frame": [4] * (T // 4) + [T % 4] * bool(T % 4), "174-frame": [T]}
    rain = torch.rand((STREAMS, T), generator=gen, device=dev) < 0.2
    for params in (st.psd_params, st.psd_params._replace(adaptive_q_enable=True)):
        one = ttr._noise_psd_track_cuda(P_band, rain, params)
        _, carry_plain = ttr._noise_psd_track_chunk_plain(
            P_band, rain, ttr.psd_carry_init(P_band[..., 0], params), params)
        for label, sizes in cuts.items():
            carry, parts, t0 = ttr.psd_carry_init(P_band[..., 0], params), [], 0
            for n in sizes:
                N, carry = ttr._noise_psd_track_cuda(P_band[..., t0 : t0 + n], rain[:, t0 : t0 + n],
                                                     params, carry)
                parts.append(N)
                t0 += n
            same, d = same_bits(torch.cat(parts, dim=-1), one)
            check(same, f"K2 with a carry over {label} chunks: not one call's bits ({d:.3e})")
            for a, b in zip(carry[:5], carry_plain[:5]):
                check(same_bits(a.float(), b.float())[0], f"K2 carry over {label} chunks")
    flux = (3.0 * torch.rand((STREAMS, 6, T), generator=gen, device=dev)) ** 2
    bc = ttr._baseline_consts(20.0, FS / 128, 0.5, 0.0, 1.0)
    one = ttr._baseline_cuda(flux, bc)
    _, carry_plain = ttr._baseline_plain(flux, bc, ttr.baseline_carry_init(flux[..., 0], 1.0))
    for label, sizes in cuts.items():
        carry, parts, t0 = ttr.baseline_carry_init(flux[..., 0], 1.0), [], 0
        for n in sizes:
            b, carry = ttr._baseline_cuda(flux[..., t0 : t0 + n].contiguous(), bc, carry)
            parts.append(b)
            t0 += n
        check(same_bits(torch.cat(parts, dim=-1), one)[0],
              f"K3 with a carry over {label} chunks: not one call's bits")
        for a, b in zip(carry, carry_plain):
            check(same_bits(a, b)[0], f"K3 carry over {label} chunks")
    print(f"  K2 ({tuple(P_band.shape)}, fixed and adaptive q) and K3 ({tuple(flux.shape)}) with "
          f"their carries over 1-, 4- and {T}-frame chunks: one call's bits, and the plain "
          f"loop's carry")

    # the library FFT the audio path does not use: does cuFFT give a frame
    # the same bits at another batch shape?  (K8 computes its own DFT.)
    frames = x0.unfold(-1, st.n_fft, st.hop).contiguous()  # (64, 173, 256)
    ref = torch.fft.rfft(frames, dim=-1)
    same_fft = {f"{tuple(frames[sl].shape[:2])}": torch.equal(
        torch.fft.rfft(frames[sl].contiguous(), dim=-1), ref[sl])
        for sl in (np.s_[:8], np.s_[:8, :4], np.s_[:1])}
    print(f"  cuFFT rfft of the same frames at other batch shapes than {tuple(frames.shape[:2])} "
          f"gives the same bits: {same_fft}")

    def k8_args(dv, state, x):
        """K8's arguments for chunk ``x`` of the audio-out detector ``dv`` from
        ``state``, with the detector's own step: ``(args, new_state, out)``."""
        st_ = dv._static()
        xa = torch.cat([state["raw_tail"], x], dim=1)
        P = spectrogram_power(xa, n_fft=st_.n_fft, hop=st_.hop, center=False)
        carry = (tsm._seed_psd(state["sup_psd"], P[:, st_.rows, 0], dv.cfg.eps),
                 state["gain_prev"], state["ola_tail"])
        new, out = dv.process_chunk_batch(state, x)
        return (dv.suppressor(), xa, P, out["frame_class"], out["noise_conf"],
                state["frame_idx"], carry), new, out

    def k8_against_plain(label, args, y_det=None):
        """K8 against its plain loop on ``args``: the gain and the carries
        bit for bit, y and the overlap-add tail within 1e-4 of max."""
        y_k, c_k, g_k = tsm._suppressor_cuda(*args, want_gain=True)
        y_p, c_p, g_p = tsm._suppressor_plain(*args)
        torch.cuda.synchronize()
        if y_det is not None:
            check(torch.equal(y_k, y_det), f"K8 {label}: the detector's y is not K8's")
        same_g, _ = same_bits(g_k, g_p)
        same_c = all(same_bits(a.float(), b.float())[0] for a, b in zip(c_k[0][:5], c_p[0][:5]))
        same_c = same_c and same_bits(c_k[1], c_p[1])[0]
        d = float((y_k - y_p).abs().max())
        r = d / float(y_p.abs().max())
        r_ola = rel_err(c_k[2].cpu().numpy(), c_p[2].cpu().numpy())
        check(same_g and same_c and r <= 1e-4 and r_ola <= 1e-4,
              f"K8 {label}: gain bits {same_g}, carry bits {same_c}, y max|d|/max {r:.3e}, "
              f"overlap-add tail {r_ola:.3e} (bound 1e-4)")
        return d, r

    k8_abs = k8_rel = 0.0
    k8_case = None
    variants = (("default", {}), ("SNR gate", {"snr_gating_enable": True}),
                ("SNR gate, power 2", {"snr_gating_enable": True, "snr_gating_power": 2.0}),
                ("SNR gate, power 0.5", {"snr_gating_enable": True, "snr_gating_power": 0.5}),
                ("Wiener, lagged N, fixed gain", {"gain_mode": "wiener", "use_lagged_noise_psd": True,
                                                  "adaptive_gain_enable": False,
                                                  "gain_freq_smooth_enable": False}))
    for label, extra in variants:
        dv = detector({**STREAM_AUDIO, **extra})
        state = dv.init_state_batch(STREAMS)
        for c in range(2):  # the stream's first chunk, then a carried one
            args, new, out = k8_args(dv, state, chunk(c))
            d, r = k8_against_plain(f"{label}, chunk {c}", args, out["y"])
            print(f"  K8 {label}, chunk {c} ({STREAMS} streams x {T} frames): gain and carries the "
                  f"plain loop's bits, y max|d| {d:.3e}, max|d|/max {r:.3e} (bound 1e-4)")
            k8_abs, k8_rel = max(k8_abs, d), max(k8_rel, r)
            if label == "default" and c == 1:
                k8_case = args
            state = new
    # the two ends of K8's transform sizes (K1's plan in the detector takes
    # 64 to 1,024; at 1,024 the band has 285 bins), the default variant
    for n_fft in (64, 1024):
        dv = detector({**STREAM_AUDIO, "n_fft": n_fft, "hop": n_fft // 2})
        L = CHUNK // n_fft * n_fft
        state = dv.init_state_batch(STREAMS)
        for c in range(2):
            args, state, out = k8_args(dv, state, chunk(c, length=L))
            d, r = k8_against_plain(f"n_fft {n_fft}, chunk {c}", args, out["y"])
            k8_abs, k8_rel = max(k8_abs, d), max(k8_rel, r)
        print(f"  K8 at n_fft {n_fft} ({STREAMS} streams x {args[3].shape[1]} frames, "
              f"{args[0].K} band bins): gain and carries the plain loop's bits, y max|d|/max "
              f"{r:.3e} (bound 1e-4)")
    # the low-latency profile's shapes, where the launches themselves dominate
    k8_lowlat = {}
    for L in LOWLAT[1]:
        dv = detector(STREAM_AUDIO)
        args, _, _ = k8_args(dv, dv.init_state_batch(LOWLAT[0]), chunk(0, LOWLAT[0], L))
        k8_against_plain(f"{LOWLAT[0]} x {L}", args)
        k8_lowlat[L] = (graph_ms(lambda: tsm._suppressor_cuda(*args)),
                        launch_breakdown(lambda: tsm._suppressor_cuda(*args)))
    k8_parts = launch_breakdown(lambda: tsm._suppressor_cuda(*k8_case))
    print(f"phase 12 streaming kernels on the card: K7 and K2/K3 carries bit for bit, K8 y within "
          f"{k8_rel:.3e} of its maximum, gain and carries bit for bit (n_fft 64, 256, 1,024); K8 "
          f"device ms per launch at {STREAMS} x {T} frames {k8_parts}, at "
          + ", ".join(f"{LOWLAT[0]} x {L // st.hop} frames {parts}"
                      for L, (_, parts) in k8_lowlat.items()))

    # ---- 13. the live streaming path -----------------------------------------
    def drive(params, B, L, n_chunks):
        dd = detector(params)
        dd.process_chunk_batch(dd.init_state_batch(B), chunk(0, B, L))  # warm
        torch.cuda.synchronize()
        state = dd.init_state_batch(B)
        _kernels.reset_launches()
        times, fcs, ys = [], [], 0
        for c in range(n_chunks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, out = dd.process_chunk_batch(state, chunk(c, B, L))
            fc = out["frame_class"].cpu()
            _ = out["rain_conf"].cpu()
            if "y" in out:
                y = out["y"].cpu()
                check(bool(torch.isfinite(y).all()) and y.shape == (B, L), "streaming y")
                ys += 1
            times.append((time.perf_counter() - t0) * 1e3)
            fcs.append(fc)
        counts = dict(_kernels.LAUNCHES)
        fc = torch.cat(fcs, dim=-1).numpy()
        check(fc.shape == (B, n_chunks * L // 128) and set(np.unique(fc)) <= {0, 1, 2},
              "streaming frame classes")
        want = {k: 0 for k in counts}
        want.update({k: n_chunks for k in ("spectrogram_power", "noise_psd_track",
                                           "causal_low_quantile_baseline", "sosfilt_zi")})
        want.update(streaming_suppressor=n_chunks if params.get("compute_output_audio") else 0)
        check(counts == want, f"streaming launches {counts}, expected {want}")
        return counts, np.asarray(times), fc

    totals = {k: 0 for k in _kernels.LAUNCHES}
    profiles = {}
    for label, params, B, L, n in (("detector", STREAM_PARAMS, STREAMS, CHUNK, CHUNKS),
                                   ("audio out", STREAM_AUDIO, STREAMS, CHUNK, CHUNKS),
                                   ("low latency 512", STREAM_PARAMS, LOWLAT[0], LOWLAT[1][0], 60),
                                   ("low latency 1024", STREAM_PARAMS, LOWLAT[0], LOWLAT[1][1], 30)):
        counts, times, fc = drive(params, B, L, n)
        for k, v in counts.items():
            totals[k] += v
        rain = (fc == 2).sum(-1)  # FrameClass.RAIN
        p50, p99 = float(np.percentile(times, 50)), float(np.percentile(times, 99))
        profiles[label] = (p50, p99)
        lab = labels[:B]
        if L == CHUNK:
            check(rain[lab].min() > rain[~lab].max(),
                  f"{label}: ping streams' rain frames {rain[lab].min()} not above noise streams' "
                  f"{rain[~lab].max()}")
        print(f"  {label}: {B} streams x {L} samples x {n} chunks: launches per chunk "
              f"{ {k: v / n for k, v in counts.items() if v} }; ms per chunk p50 {p50:.3f}, p99 "
              f"{p99:.3f} (host clock, int16 on the card to results on the host) = "
              f"{B * L / FS / (p50 / 1e3):.1f} audio-s/s; rain frames per stream: ping "
              f"{rain[lab].mean():.1f} (min {rain[lab].min()}), noise {rain[~lab].mean():.2f} "
              f"(max {rain[~lab].max()})")
    print(f"phase 13 streaming path on {smi}: launches over the four runs {totals}")

    # ---- 14. chunk invariance on the card; 15. the card against the CPU ----
    x8 = pcm_dev[:8, : 3 * CHUNK].to(torch.float32) / 32767.0
    splits = [[CHUNK]] + [[int(r) * 128 for r in np.random.default_rng(100 + s).integers(1, 40, 400)]
                          for s in range(3)]
    for label, params in (("detector", STREAM_PARAMS), ("audio out", STREAM_AUDIO),
                          ("audio out, SNR gate power 2", STREAM_SNR_POW)):
        dd = detector(params)
        one, _ = run_stream(dd, x8, [x8.shape[1]])
        for sizes in splits:
            got, _ = run_stream(dd, x8, sizes)
            for k in one:
                check(torch.equal(got[k], one[k]), f"{label}: {k} at chunks {sizes[:3]} differs")
        for i in range(8):
            got, _ = run_stream(dd, x8[i : i + 1], [CHUNK])
            for k in one:
                check(torch.equal(got[k][0], one[k][i]), f"{label}: stream {i} alone differs in {k}")
        cpu, _ = run_stream(detector(params, "cpu"), x8.cpu(), [CHUNK])
        check(torch.equal(cpu["frame_class"], one["frame_class"].cpu()),
              f"{label}: card and CPU frame classes differ")
        y_rel = rel_err(one["y"].cpu().numpy(), cpu["y"].numpy()) if "y" in one else 0.0
        check(y_rel <= 1e-4, f"{label}: y card against CPU {y_rel:.3e}")
        print(f"  {label}: one chunk, 2 s chunks and 3 random partitions give the same "
              f"{sorted(one)} bits; 8 single streams equal the batch; CPU frame classes "
              f"identical" + (f", y max|d|/max {y_rel:.3e} (bound 1e-4)" if "y" in one else ""))
    print("phase 14-15 chunk invariance and batched equality on the card, card against the CPU: "
          "all equal")

    # ---- 16. the live server on the card -------------------------------------
    packet, n_packets = 4096, 11
    servers = [serve.make_server(STREAM_PARAMS, port=0, batch_window_ms=50.0, device="cuda"),
               serve.make_server(STREAM_PARAMS, port=0, batch_window_ms=50.0, emit_audio=True,
                                 device="cuda")]
    threads = [threading.Thread(target=srv.serve_forever, daemon=True) for srv in servers]
    for t in threads:
        t.start()
    clients = [(0, 0, "int16"), (1, 0, "int16"), (2, 0, "mulaw"), (3, 1, "int16")]
    go = threading.Barrier(len(clients))
    results = [None] * len(clients)

    def client(j, stream_i, srv_i, wire):
        addr = servers[srv_i].server_address
        audio = srv_i == 1
        data = pcm[stream_i, : packet * n_packets]
        replies = []
        with socket.create_connection(addr, timeout=300) as sock:
            f = sock.makefile("rb")
            go.wait()
            for q in range(n_packets):
                piece = data[q * packet : (q + 1) * packet]
                if wire == "mulaw":
                    payload, magic = mulaw_encode(piece).tobytes(), serve.MAGIC_MULAW
                else:
                    payload, magic = piece.astype("<i2").tobytes(), serve.MAGIC_DATA
                sock.sendall(serve._HDR.pack(magic, len(payload)) + payload)
                r = json.loads(f.readline())
                if audio:
                    _, nb = serve._HDR.unpack(f.read(serve._HDR.size))
                    r["audio"] = np.frombuffer(f.read(nb), "<i2")
                replies.append(r)
            sock.sendall(serve._HDR.pack(serve.MAGIC_EOS, 0))
            summary = json.loads(f.readline())
            if audio:
                _, nb = serve._HDR.unpack(f.read(serve._HDR.size))
                summary["audio"] = np.frombuffer(f.read(nb), "<i2")
        results[j] = (replies, summary)

    workers = [threading.Thread(target=client, args=(j, *c)) for j, c in enumerate(clients)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    batched = servers[0].batcher.batched_calls
    reruns = [srv.batcher.group_reruns for srv in servers]
    for srv in servers:
        srv.shutdown()
        srv.server_close()
    for j, (stream_i, srv_i, wire) in enumerate(clients):
        replies, summary = results[j]
        dd = detector(STREAM_AUDIO if srv_i == 1 else STREAM_PARAMS)
        state = dd.init_state()
        data = pcm[stream_i, : packet * n_packets]
        for q, r in enumerate(replies):
            piece = data[q * packet : (q + 1) * packet]
            if wire == "mulaw":
                xq = mulaw_decode_np(mulaw_encode(piece))
                xq *= 32768.0 / serve.INT16_SCALE
            else:
                xq = piece.astype(np.float32)
                xq /= serve.INT16_SCALE
            state, out = dd.process_chunk(state, xq)
            fc = out["frame_class"].cpu().numpy()
            want = {"frames": int(fc.size), "rain_frames": int((fc == 2).sum()),
                    "rain_conf_mean": float(np.mean(out["rain_conf"].cpu().numpy()))}
            check(all(r[k] == v for k, v in want.items()),
                  f"server client {j} packet {q}: {r} against direct {want}")
            if srv_i == 1:
                check(np.array_equal(r["audio"], serve._to_pcm16(out["y"].cpu().numpy())),
                      f"server client {j} packet {q}: audio differs from direct")
        if srv_i == 1:
            check(np.array_equal(summary["audio"], serve._to_pcm16(dd.drain_audio(state))),
                  f"server client {j}: drained tail differs")
    check(batched > 0 and reruns == [0, 0],
          f"server: batched calls {batched}, group re-runs {reruns}")
    print(f"phase 16 server on the card: {len(clients)} clients x {n_packets} packets of {packet} "
          f"samples (one on the mu-law wire, one with audio out), every reply equal to direct "
          f"process_chunk results; batched calls {batched}, group re-runs {reruns}")

    # ---- timings of the new kernels at the live shapes -------------------------
    k7_ms = graph_ms(lambda: tfl._sosfilt_zi_cuda(coef, x0, zi))
    k7_plain = float(np.median(cuda_times(lambda: tfl._sosfilt_zi_plain(coef, x0, zi), 1)))
    k8_ms = graph_ms(lambda: tsm._suppressor_cuda(*k8_case))
    k8_plain = float(np.median(cuda_times(lambda: tsm._suppressor_plain(*k8_case), 2)))
    print(f"  timings on {smi}: K7 {k7_ms:.4f} ms per launch at {tuple(x0.shape)} (plain loop "
          f"{k7_plain:.1f} ms, n=1); K8 {k8_ms:.4f} ms per call at {STREAMS} x {T} frames "
          f"(plain loop {k8_plain:.1f} ms, n=2); at the low-latency profile's "
          + ", ".join(f"{LOWLAT[0]} x {L // st.hop} frames {ms:.4f} ms"
                      for L, (ms, _) in k8_lowlat.items()))
    # bounds: K7 reads x and zi and writes y and zf, 9 float operations per
    # sample and section; K8 reads the carried samples and the chunk, the
    # band power, the classes and confidences and writes the audio, and does
    # a forward and an inverse real FFT per frame (2.5 N log2 N each) and
    # ~40 operations per band bin
    sup = k8_case[0]
    B8, T8 = k8_case[3].shape
    n_fft = sup.st.n_fft
    return {
        "launches": totals,
        "err": {"sosfilt_zi": k7_abs, "streaming_suppressor": k8_abs},
        "ms": {"sosfilt_zi": k7_ms, "streaming_suppressor": k8_ms},
        "plain_ms": {"sosfilt_zi": k7_plain, "streaming_suppressor": k8_plain},
        "k8_launches_ms": k8_parts,
        "k8_low_latency_ms": {f"{LOWLAT[0]} x {L}": ms for L, (ms, _) in k8_lowlat.items()},
        "work": {
            "sosfilt_zi": (4 * (2 * x0.numel() + 2 * zi.numel()), 9 * S * x0.numel()),
            "streaming_suppressor": (
                4 * (k8_case[1].numel() + B8 * sup.K * T8 + B8 * T8 + B8 * T8 * sup.st.hop)
                + B8 * T8,
                B8 * T8 * (2 * 2.5 * n_fft * np.log2(n_fft) + 40 * sup.K)),
        },
    }


BN_SEED = 17
BN_CHUNK = 512 * 17  # odd chunking of the band-noise streams, 17 frames
BN_CONFIGS = {  # tests/test_band_noise.py:235-239, both detector triggers, K6's widest ring
    "default": {},
    "smooth N_E": {"smooth_N_E": True},
    "replenish, TTL 20": {"noise_replenish_from_all_subframes": True,
                          "noise_buffer_ttl_frames": 20},
    "D and dE triggers": {"det.use_D_trigger": True, "det.use_dE_over_Ehpf": True},
    "W 64, replenish, TTL 5": {"W": 64, "noise_replenish_from_all_subframes": True,
                               "noise_buffer_ttl_frames": 5},
}


def with_nonfinite_energies(inputs):
    """K6's per-frame inputs with NaN, +inf, -inf and zero subframe energies
    (and a NaN high-passed energy and band energy) in eight lanes, so that
    its ring holds values its sorted view does not order."""
    subE, subEhpf, *rest = (t.clone() for t in inputs)
    nan, inf = float("nan"), float("inf")
    subE[0, 50, 1] = nan
    subE[1, 60, 2] = inf
    subE[2, 70:75, 0] = nan
    subE[3, 80, 3] = -inf
    subE[4, 90:120, :] = inf
    subE[5, 100, :] = 0.0
    subEhpf[6, 40, 0] = nan
    rest[2][7, 30] = nan  # Eb
    return (subE, subEhpf, *rest)


def k6_mismatches(got, ref) -> tuple:
    """K6's outputs or carry (dicts of tensors) against the plain loop's:
    the keys whose values differ (floats by ``same_bits``, the rest exactly)
    and max|d| where both are finite."""
    import torch

    bad, err = [], 0.0
    for key in ref:
        if ref[key].dtype.is_floating_point:
            same, d = same_bits(got[key], ref[key])
            err = max(err, d)
        else:
            same = torch.equal(got[key], ref[key])
        if not same:
            bad.append(key)
    return bad, err


def band_noise_clips(n_clips: int, seed: int = BN_SEED):
    """Noise with loud 520 Hz bursts at random times, about one a second
    (``tests/test_band_noise.py:225-232``), float32 (B, 10 s)."""
    rng = np.random.default_rng(seed)
    n = int(FS * CLIP_SEC)
    k = np.arange(2500)
    burst = 0.5 * np.exp(-k / 400.0) * np.sin(2 * np.pi * 520 * k / FS)
    x = 0.01 * rng.standard_normal((n_clips, n))
    for i in range(n_clips):
        for t0 in rng.integers(FS // 2, n - 3000, int(CLIP_SEC)):
            x[i, t0 : t0 + 2500] += rng.uniform(0.5, 1.5) * burst
    return x.astype(np.float32)


def band_noise_phases(smi: str) -> dict:
    """Phases 17-20: the band-noise estimator (K4 and K6 beside K1) on the
    card and its server.  Returns the batch's launches, and each new
    kernel's error, times and work for the kernels line."""
    import socket
    import threading

    import scipy.signal as ss
    import torch

    from audio_processing_tools_tpu_torch import _kernels
    from audio_processing_tools_tpu_torch.cli import serve
    from audio_processing_tools_tpu_torch.models import band_noise as tbn
    from audio_processing_tools_tpu_torch.models.band_noise_streaming import BandNoiseEstimator
    from audio_processing_tools_tpu_torch.models import streaming as tsm
    from audio_processing_tools_tpu_torch.ops import filters as tfl
    from audio_processing_tools_tpu_torch.ops.spectrogram import spectrogram_power
    from audio_processing_tools_tpu_torch.ops.stft import stft_power

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(17)
    clips = band_noise_clips(BATCH)
    x = torch.from_numpy(clips).to(dev)
    cfg = tbn.build_band_noise_config({"sample_rate": FS})
    N = cfg.frame_len
    T = x.shape[1] // N
    xT = x[:, : T * N].contiguous()
    hpf, bpf = tbn._design_filters(cfg)

    # ---- 17. K4 against its plain version --------------------------------------
    # the path's shapes: the high-pass over the clips from their seed states,
    # then the band-pass over its output; the kernels line's error is these
    k4_abs = 0.0
    k4_parts = {}  # device ms of each of K4's launches at the path's shapes
    xs = xT
    for label, sos in (("high-pass", hpf), ("band-pass", bpf)):
        zi = tbn._seed(sos, xT[:, 0]).reshape(BATCH, -1).contiguous()
        (y_k, z_k), (y_p, z_p) = k4_pair(sos, xs, zi)
        (same_y, d), (same_z, dz) = same_bits(y_k, y_p), same_bits(z_k, z_p)
        check(same_y and same_z, f"K4 {label} at {tuple(xs.shape)}: not the plain version's "
                                 f"bits (y {d:.3e}, zf {dz:.3e})")
        k4_abs = max(k4_abs, d, dz)
        flat, _ = k4_tables(sos, xs.shape[-1], dev)
        k4_parts[label] = launch_breakdown(
            lambda: tfl._cascade_sosfilt_cuda(flat, xs, zi, sos.shape[0]))
        xs = y_k
    x8 = xT[:8]
    for label, sos in (("high-pass", hpf), ("band-pass", bpf)):
        zi = 0.01 * torch.randn((8, 2 * sos.shape[0]), generator=gen, device=dev)
        for xs in (x8, x8[:, : T * N - 77].contiguous()):
            (y_k, z_k), (y_p, z_p) = k4_pair(sos, xs, zi)
            (same_y, d), (same_z, dz) = same_bits(y_k, y_p), same_bits(z_k, z_p)
            check(same_y and same_z, f"K4 {label} at {tuple(xs.shape)}: not the plain version's "
                                     f"bits (y {d:.3e}, zf {dz:.3e})")
        # chunks of 512 x 17 samples with the state carried give one call's bits
        zi = zi.reshape(8, sos.shape[0], 2)
        y1, z1 = tfl.cascade_sosfilt(sos, x8, zi)
        ys, z = [], zi
        for a in range(0, x8.shape[1], BN_CHUNK):
            y, z = tfl.cascade_sosfilt(sos, x8[:, a : a + BN_CHUNK], z)
            ys.append(y)
        check(torch.equal(torch.cat(ys, dim=-1), y1) and torch.equal(z, z1),
              f"K4 {label}: 512 x 17 chunks do not give one call's bits")
        # the whole batch against scipy in float64
        zi_b = 0.01 * torch.randn((BATCH, sos.shape[0], 2), generator=gen, device=dev)
        y_k, zf_k = tfl.cascade_sosfilt(sos, x, zi_b)
        y_sp, zf_sp = ss.sosfilt(sos, clips.astype(np.float64), axis=-1,
                                 zi=zi_b.double().cpu().numpy().transpose(1, 0, 2))
        r_y = rel_err(y_k.cpu().numpy(), y_sp)
        r_z = rel_err(zf_k.cpu().numpy(), zf_sp.transpose(1, 0, 2))
        check(r_y <= 1e-5 and r_z <= 1e-5, f"K4 {label} against scipy float64: y {r_y:.3e}, "
                                           f"zf {r_z:.3e}")
        print(f"  K4 {label} ({sos.shape[0]} sections): the plain version's bits at "
              f"{tuple(xT.shape)} from the seed state (the path's shape), at {tuple(x8.shape)} and "
              f"with a partial last block, zi nonzero, y and zf; 512 x 17 "
              f"chunks give one call's bits; {tuple(x.shape)} against scipy in float64: y "
              f"max|d|/max {r_y:.3e}, zf {r_z:.3e} (bound 1e-5)")
    print("phase 17 K4 cascade_sosfilt on the card: the plain version's bits, chunk invariant, "
          f"within 1e-5 of scipy; device ms per launch at {tuple(xT.shape)}: {k4_parts}")

    # ---- 18. K6 against its plain loop -------------------------------------------
    k6_abs = 0.0
    k6_case = None
    for label, extra in BN_CONFIGS.items():
        c = tbn.build_band_noise_config({"sample_rate": FS, **extra})
        h, b = tbn._design_filters(c)
        x0 = xT[:, 0]
        x_h, x_bp, _, _ = tbn._filters(c, xT, tbn._seed(h, x0), tbn._seed(b, x0))
        inputs = tbn._per_frame_inputs(x_h, x_bp, c, T)
        carry = tbn._scan_carry_init(c, BATCH, dev)
        runs = [("", inputs)]
        if label in ("default", "W 64, replenish, TTL 5"):
            runs.append((", non-finite subframe energies", with_nonfinite_energies(inputs)))
        for what, ins in runs:
            out_k, carry_k = tbn._band_scan_cuda(c, carry, ins)
            out_p, carry_p = tbn._band_scan_plain(c, carry, ins)
            torch.cuda.synchronize()
            (bad, d), (bad_c, dc) = k6_mismatches(out_k, out_p), k6_mismatches(carry_k, carry_p)
            check(not bad and not bad_c, f"K6 {label}{what}: not the plain loop's {bad}, carry "
                                         f"{bad_c}")
            k6_abs = max(k6_abs, d, dc)
            rain = float(out_k["fft_rain_frame"].float().mean())
            print(f"  K6 {label}{what} ({BATCH} lanes x {T} frames, W {c.W}): outputs and carry "
                  f"the plain loop's bits; fft_rain_frame on {rain:.3f} of frames")
        if label == "default":
            k6_case = (c, carry, inputs)
    print(f"phase 18 K6 band_noise_scan: {len(BN_CONFIGS)} configurations and 2 with non-finite "
          "subframe energies, the plain loop's bits")

    # ---- 19. the band-noise batch path -------------------------------------------
    params = {"sample_rate": FS}
    proc = tbn.BandNoiseEstimatorProcessor(device=dev)
    proc.run_batch(x[:2], params)  # warm the allocator and the constants
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    pairs = proc.run_batch(x, params)
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    want = {k: 0 for k in launches}
    want.update(spectrogram_power=1, cascade_sosfilt=2, band_noise_scan=1)
    check(launches == want, f"band-noise batch launches {launches}, expected {want}")
    check(len(pairs) == BATCH and all(m["n_frames"] == T for m, _ in pairs), "band-noise pairs")
    for key in ("N_E", "G_mag", "E_band", "M_clean"):
        check(all(np.isfinite(s[key]).all() for _, s in pairs), f"band-noise {key} not finite")
    fft_frac = np.array([m["fft_rain_frac"] for m, _ in pairs])
    sub_frac = np.array([m["rain_submask_frac"] for m, _ in pairs])
    check(fft_frac.min() > 0, "a band-noise clip has no FFT rain frame")
    # the card against the port's CPU path on 16 clips
    cpu_pairs = tbn.BandNoiseEstimatorProcessor(device="cpu").run_batch(clips[:N_AGREE], params)
    fr_card = np.stack([s["fft_rain_frame"] for _, s in pairs[:N_AGREE]])
    fr_cpu = np.stack([s["fft_rain_frame"] for _, s in cpu_pairs])
    sm_card = np.stack([s["rain_submask"] for _, s in pairs[:N_AGREE]])
    sm_cpu = np.stack([s["rain_submask"] for _, s in cpu_pairs])
    agree_fr = float((fr_card == fr_cpu).mean())
    agree_sm = float((sm_card == sm_cpu).mean())
    ne_rel = rel_err(np.stack([s["N_E"] for _, s in pairs[:N_AGREE]]),
                     np.stack([s["N_E"] for _, s in cpu_pairs]))
    check(agree_fr >= 0.999 and agree_sm >= 0.999 and ne_rel <= 1e-5,
          f"band noise, card against CPU: fft_rain_frame {agree_fr:.6f}, rain_submask "
          f"{agree_sm:.6f} (bound 0.999), N_E max|d|/max {ne_rel:.3e} (bound 1e-5)")
    # K1 with the path's rectangular table, on the path's high-passed frames
    x_h = tfl.cascade_sosfilt(hpf, xT, tbn._seed(hpf, xT[:, 0]))[0]
    P_k = spectrogram_power(x_h, n_fft=N, hop=N, center=False, window="rect")
    P_p = stft_power(x_h, n_fft=N, hop=N, center=False, window="rect")
    k1_rect = float((P_k - P_p).abs().max()) / float(P_p.abs().max())
    check(P_k.shape == (BATCH, N // 2 + 1, T) and k1_rect < 1e-5,
          f"K1 rect at {tuple(x_h.shape)} -> {tuple(P_k.shape)}: max|d|/max {k1_rect:.3e}")
    # bitwise: whole = 512 x 17 chunks = single frames, batch = single streams
    full = tbn.band_noise_process(x[:8], cfg)
    state, parts = tbn.band_noise_init_state(cfg, 8, dev), []
    for a in range(0, T * N, BN_CHUNK):
        out, state = tbn.band_noise_process_chunk(x[:8, a : min(a + BN_CHUNK, T * N)], cfg, state)
        parts.append(out)
    for key in full:
        check(torch.equal(torch.cat([p[key] for p in parts], dim=1), full[key]),
              f"band noise on the card: {key} in 512 x 17 chunks differs from one call")
    for i in range(8):
        one = tbn.band_noise_process(x[i : i + 1], cfg)
        for key in full:
            check(torch.equal(one[key][0], full[key][i]), f"band noise stream {i} alone: {key}")
    for i in range(2):
        est = BandNoiseEstimator(cfg, device=dev)
        frames = list(est.process_stream(clips[i, : T * N]))
        for key in ("N_E", "G_mag", "M_clean", "E_band", "noise_effective_q"):
            got = np.float32([getattr(f, key) for f in frames])
            check(np.array_equal(got, full[key][i].cpu().numpy()),
                  f"band noise stream {i} frame by frame: {key}")
        check(np.array_equal(np.stack([f.rain_submask for f in frames]),
                             full["rain_submask"][i].cpu().numpy()), "frame by frame: rain_submask")
    # timings: the batched call (results on the card) with CUDA events, then
    # run_batch on the host clock with the copy and the per-clip summaries
    def batch():
        return tbn.band_noise_process(x, cfg)

    times = cuda_times(batch, 20)
    med = float(np.median(times))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        proc.run_batch(x, params)
    host = (time.perf_counter() - t0) / 5 * 1e3
    audio_s = BATCH * CLIP_SEC
    print(f"phase 19 band-noise batch {BATCH} x {CLIP_SEC:.0f} s ({T} frames) via run_batch: "
          f"launches { {k: v for k, v in launches.items() if v} }; FFT rain frames "
          f"{fft_frac.mean():.4f} of frames (min {fft_frac.min():.4f}), rain subframes "
          f"{sub_frac.mean():.4f}; wall {wall * 1e3:.1f} ms incl. copy and summaries; card "
          f"against the CPU path on {N_AGREE} clips: fft_rain_frame {agree_fr:.6f}, rain_submask "
          f"{agree_sm:.6f} (bound 0.999), N_E max|d|/max {ne_rel:.3e} (bound 1e-5); K1 with the "
          f"rectangular table {tuple(x_h.shape)} -> {tuple(P_k.shape)} against stft_power: max|d|/max "
          f"{k1_rect:.3e} (bound 1e-5); whole = 512 x 17 chunks = "
          f"8 single streams, bit for bit, and 2 streams frame by frame; on {smi}: "
          f"band_noise_process {med:.3f} ms per batch (min {min(times):.3f}, max "
          f"{max(times):.3f}, n=20) = {audio_s / (med / 1e3):.1f} audio-s/s; run_batch host "
          f"clock {host:.3f} ms per batch = {audio_s / (host / 1e3):.1f} audio-s/s")

    # ---- 20. the band-noise server on the card -------------------------------
    packet = 4096
    n_packets = min(11, clips.shape[1] // packet)
    pcm = (np.clip(clips[:4, : packet * n_packets], -1.0, 1.0) * 32767.0).astype("<i2")
    servers = [serve.make_server(params, port=0, model="band_noise", batch_window_ms=50.0,
                                 device="cuda"),
               serve.make_server(params, port=0, model="band_noise", emit_audio=True,
                                 device="cuda")]
    threads = [threading.Thread(target=srv.serve_forever, daemon=True) for srv in servers]
    for t in threads:
        t.start()
    clients = [(0, 0), (1, 0), (2, 0), (3, 1)]
    go = threading.Barrier(len(clients))
    results = [None] * len(clients)

    def client(j, stream_i, srv_i):
        audio = srv_i == 1
        replies = []
        with socket.create_connection(servers[srv_i].server_address, timeout=300) as sock:
            f = sock.makefile("rb")
            go.wait()
            for q in range(n_packets):
                payload = pcm[stream_i, q * packet : (q + 1) * packet].tobytes()
                sock.sendall(serve._HDR.pack(serve.MAGIC_DATA, len(payload)) + payload)
                r = json.loads(f.readline())
                if audio:
                    _, nb = serve._HDR.unpack(f.read(serve._HDR.size))
                    r["audio"] = np.frombuffer(f.read(nb), "<i2")
                replies.append(r)
            sock.sendall(serve._HDR.pack(serve.MAGIC_EOS, 0))
            summary = json.loads(f.readline())
            if audio:
                f.read(serve._HDR.size)
        results[j] = (replies, summary)

    workers = [threading.Thread(target=client, args=(j, *c)) for j, c in enumerate(clients)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    batched = servers[0].batcher.batched_calls
    reruns = [srv.batcher.group_reruns if srv.batcher else 0 for srv in servers]
    for srv in servers:
        srv.shutdown()
        srv.server_close()
    for j, (stream_i, srv_i) in enumerate(clients):
        replies, _ = results[j]
        state = tbn.band_noise_init_state(cfg, 1, dev)
        for q, r in enumerate(replies):
            xq = pcm[stream_i, q * packet : (q + 1) * packet].astype(np.float32)
            xq /= serve.INT16_SCALE
            out, state = tbn.band_noise_process_chunk(torch.from_numpy(xq)[None].to(dev), cfg,
                                                      state)
            g = out["G_mag"][0].cpu().numpy()
            rain = out["fft_rain_frame"][0].cpu().numpy()
            direct = {"frames": int(rain.size), "rain_frames": int(rain.sum()),
                      "N_E_last": float(out["N_E"][0, -1]), "G_mag_mean": float(np.mean(g))}
            check(all(r[k] == v for k, v in direct.items()),
                  f"band-noise server client {j} packet {q}: {r} against direct {direct}")
            if srv_i == 1:
                y = serve._to_pcm16((xq.reshape(g.size, -1) * g[:, None]).reshape(-1))
                check(np.array_equal(r["audio"], y), f"band-noise server client {j}: audio")
    check(batched > 0 and reruns == [0, 0],
          f"band-noise server: batched calls {batched}, group re-runs {reruns}")
    print(f"phase 20 band-noise server on the card: {len(clients)} clients x {n_packets} packets "
          f"of {packet} samples (one with audio out), every reply equal to direct "
          f"band_noise_process_chunk results; batched calls {batched}, group re-runs {reruns}")

    # ---- timings of K4 and K6 at the batch's shapes --------------------------
    k4 = {}
    for label, sos, xs in (("high-pass", hpf, xT), ("band-pass", bpf, x_h)):
        zi = tbn._seed(sos, xT[:, 0]).reshape(BATCH, -1).contiguous()
        flat, tabs = k4_tables(sos, xs.shape[-1], dev)
        k_ms = graph_ms(lambda: tfl._cascade_sosfilt_cuda(flat, xs, zi, sos.shape[0]))
        p_ms = float(np.median(cuda_times(lambda: tfl._cascade_sosfilt_plain(tabs, xs, zi), 2)))
        k4[label] = (k_ms, p_ms, k4_work(xs, sos.shape[0]))
    c6, carry6, inputs6 = k6_case
    k6_ms = graph_ms(lambda: tbn._band_scan_cuda(c6, carry6, inputs6))
    k6_plain = float(np.median(cuda_times(lambda: tbn._band_scan_plain(c6, carry6, inputs6), 1)))
    print(f"  timings on {smi}: K4 " + ", ".join(
        f"{label} {ms:.4f} ms per call (plain {pm:.1f} ms, n=2)"
        for label, (ms, pm, _) in k4.items())
          + f" at {tuple(xT.shape)}; K6 {k6_ms:.4f} ms per launch at {BATCH} x {T} frames (plain "
            f"loop {k6_plain:.1f} ms, n=1)")
    # K4 and K7 compute the same filter with a carried state: each at the
    # other's shape (K7's live prefilter at 64 x 2 s with its sections, K4's
    # two filters at the batch's), K4 held to K7 within 1e-5 of max
    det = tsm.StreamingRainDetector(device=dev)
    det.setup(dict(STREAM_PARAMS))
    td = det._static().td_sos
    xl = xT[:STREAMS, :CHUNK].contiguous()
    zl = tbn._seed(td, xl[:, 0]).reshape(STREAMS, -1).contiguous()
    flat_l, _ = k4_tables(td, CHUNK, dev)
    coef_l = torch.from_numpy(tfl._sos_coefficients(td)).to(dev)
    y4, _ = tfl._cascade_sosfilt_cuda(flat_l, xl, zl, td.shape[0])
    y7, _ = tfl._sosfilt_zi_cuda(coef_l, xl, zl.reshape(STREAMS, -1, 2))
    r47 = rel_err(y4.cpu().numpy(), y7.cpu().numpy())
    check(r47 <= 1e-5, f"K4 against K7 at {tuple(xl.shape)}: max|d|/max {r47:.3e}")
    k4_live = graph_ms(lambda: tfl._cascade_sosfilt_cuda(flat_l, xl, zl, td.shape[0]))
    k7_live = graph_ms(lambda: tfl._sosfilt_zi_cuda(coef_l, xl, zl.reshape(STREAMS, -1, 2)))
    k7_band = []
    for label, sos, xs in (("high-pass", hpf, xT), ("band-pass", bpf, x_h)):
        coef = torch.from_numpy(tfl._sos_coefficients(sos)).to(dev)
        zi = tbn._seed(sos, xT[:, 0]).contiguous()
        k7_band.append(f"{label} {graph_ms(lambda: tfl._sosfilt_zi_cuda(coef, xs, zi)):.4f} ms")
    print(f"  K4 against K7 on {smi}: at the live shape {tuple(xl.shape)}, {td.shape[0]} sections, "
          f"K4 {k4_live:.4f} ms, K7 {k7_live:.4f} ms per launch (K4 within {r47:.3e} of K7's max); "
          f"at the band-noise shape {tuple(xT.shape)}, K7 " + ", ".join(k7_band) + " per launch")
    S = tbn.n_subframes(cfg)
    n_lf = BATCH * T
    return {
        "launches": launches,
        "err": {"cascade_sosfilt": k4_abs, "band_noise_scan": k6_abs},
        "k4_launches_ms": k4_parts,
        # K4: per launch, the mean of the batch's two launches
        "ms": {"cascade_sosfilt": float(np.mean([v[0] for v in k4.values()])),
               "band_noise_scan": k6_ms},
        "plain_ms": {"cascade_sosfilt": float(np.mean([v[1] for v in k4.values()])),
                     "band_noise_scan": k6_plain},
        "work": {
            "cascade_sosfilt": tuple(float(np.mean([v[2][i] for v in k4.values()]))
                                     for i in range(2)),
            # K6 reads 2 S + 4 values and writes 9 + 10 values and S flags a
            # lane and frame; the rank count makes 2 W^2 comparisons and adds
            "band_noise_scan": (n_lf * (4 * (2 * S + 4 + 19) + S), n_lf * 2 * cfg.W ** 2),
        },
    }


ALAC_TILES = 20  # golden payloads per ALAC clip: 20 x 5,581 samples = 111,620 = 10 s


def alac_clip_payloads(n_clips: int):
    """ALAC payloads of ``n_clips`` 10 s clips made from the packets of
    ``tests/fixtures/alac_golden.bin`` (43 full 128-sample packets and one of
    77; ALAC packets decode independently): clip i is 20 tiles of the full
    packets rotated by i, each tile closed by the short packet.  Returns the
    payloads and the int16 PCM each must decode to, (n_clips, 111,620)."""
    from audio_processing_tools_tpu_torch.io.alac_native import _ber_frame_header, split_ber_packets

    fixtures = REPO / "tests" / "fixtures"
    pcm = np.load(fixtures / "alac_golden_pcm.npy")
    packets = split_ber_packets((fixtures / "alac_golden.bin").read_bytes()[40:])
    n_full = len(packets) - 1
    framed = [_ber_frame_header(len(p)) + p for p in packets]
    blocks = pcm[: 128 * n_full].reshape(n_full, 128)
    payloads = []
    expected = np.empty((n_clips, ALAC_TILES * pcm.size), np.int16)
    for i in range(n_clips):
        order = np.roll(np.arange(n_full), -i)
        payloads.append((b"".join(framed[j] for j in order) + framed[-1]) * ALAC_TILES)
        expected[i] = np.tile(np.concatenate([blocks[order].ravel(), pcm[128 * n_full :]]),
                              ALAC_TILES)
    return payloads, expected


def roe_mel_alac_phases(smi: str) -> dict:
    """Phases 21-25: the legacy RoE classifier (K4 at 8 and 4 sections, K1),
    the mel classifier (K1), ALAC ingest into the classifier-only path, and
    the wind and pitch tools.  Returns each path's launches, K4's error and
    its times at the RoE shapes for the kernels line."""
    import scipy.signal as ss
    import torch
    import torch.nn.functional as tnf

    from audio_processing_tools_tpu_torch import _kernels
    from audio_processing_tools_tpu_torch.io.mark import parse_mark_audio_file, write_mark_audio_file
    from audio_processing_tools_tpu_torch.models import mel_classifier, pitch, roe, wind
    from audio_processing_tools_tpu_torch.models.spectral_noise import RainDetectorProcessor
    from audio_processing_tools_tpu_torch.ops import filters as tfl
    from audio_processing_tools_tpu_torch.ops.mel import mel_spectrogram
    from audio_processing_tools_tpu_torch.ops.spectrogram import spectrogram_power
    from audio_processing_tools_tpu_torch.ops.stft import stft, stft_power

    dev = torch.device("cuda", 0)
    clips, labels = synth_clips()
    x = torch.from_numpy(clips).to(dev)
    cfg = roe.build_roe_config(return_spectra=False)
    pick = np.r_[np.arange(0, BATCH, 2)[: N_AGREE // 2], np.arange(1, BATCH, 2)[: N_AGREE // 2]]
    audio_s = BATCH * CLIP_SEC
    zeros = {k: 0 for k in _kernels.LAUNCHES}

    # ---- 21. K4 and K1 at the RoE shapes ----------------------------------------
    plan = roe._chunk_plan(cfg, x.shape[-1])
    rows = torch.cat([x[:, o : o + t] for o, t in plan], dim=0).contiguous()
    nyq = 0.5 * FS
    sos8 = tfl.butter_sos(8, [cfg.op_freq_range[0] / nyq, cfg.op_freq_range[1] / nyq], "bandpass")
    sos4 = tfl.butter_sos(4, [400.0 / nyq, 900.0 / nyq], "bandpass")
    k4_err, k4_shapes, y8 = 0.0, [], None
    for label, sos in (("RoE operating band-pass", sos8), ("RoE pulse band-pass", sos4)):
        xs = rows if y8 is None else tnf.pad(y8, (cfg.hop_length, cfg.hop_length)).contiguous()
        zi = torch.zeros((xs.shape[0], 2 * sos.shape[0]), device=dev)
        (y_k, z_k), (y_p, z_p) = k4_pair(sos, xs, zi)
        (same_y, d), (same_z, dz) = same_bits(y_k, y_p), same_bits(z_k, z_p)
        check(same_y and same_z, f"K4 {label} at {tuple(xs.shape)}: not the plain version's "
                                 f"bits (y {d:.3e}, zf {dz:.3e})")
        r_sp = rel_err(y_k.cpu().numpy(), ss.sosfilt(sos, xs.double().cpu().numpy(), axis=-1))
        check(r_sp <= 1e-5, f"K4 {label} against scipy float64: {r_sp:.3e}")
        k4_err = max(k4_err, d, dz)
        flat, tabs = k4_tables(sos, xs.shape[-1], dev)
        ms = graph_ms(lambda: tfl._cascade_sosfilt_cuda(flat, xs, zi, sos.shape[0]))
        parts = launch_breakdown(lambda: tfl._cascade_sosfilt_cuda(flat, xs, zi, sos.shape[0]))
        plain = float(np.median(cuda_times(lambda: tfl._cascade_sosfilt_plain(tabs, xs, zi), 2)))
        b_ms, b_by = bound_of(*k4_work(xs, sos.shape[0]))
        k4_shapes.append({"path": label, "rows": xs.shape[0], "samples": xs.shape[1],
                          "sections": sos.shape[0], "ms": ms, "plain_ms": plain,
                          "bound_ms": b_ms, "bound_by": b_by, "launches_ms": parts})
        print(f"  K4 {label}, {sos.shape[0]} sections, {tuple(xs.shape)}: the plain version's "
              f"bits (y and zf), within {r_sp:.3e} of scipy float64 (bound 1e-5); {ms:.4f} ms "
              f"per call in a graph of 20, per launch {parts} (bound {b_ms:.4f} by {b_by}; plain "
              f"{plain:.1f} ms, n=2)")
        if y8 is None:
            y8 = y_k
    P_k = spectrogram_power(y8, n_fft=cfg.frame_length, hop=cfg.hop_length)
    P_p = stft_power(y8, n_fft=cfg.frame_length, hop=cfg.hop_length)
    k1_rel = rel_err(P_k.cpu().numpy(), P_p.cpu().numpy())
    check(k1_rel < 1e-5, f"K1 at {tuple(y8.shape)}: max|d|/max {k1_rel:.3e}")
    print(f"phase 21 K4 at the RoE shapes on {smi}: 8 and 4 sections, the plain version's bits, "
          f"within 1e-5 of scipy, device ms per launch "
          f"{ {sh['sections']: sh['launches_ms'] for sh in k4_shapes} }; K1 {tuple(y8.shape)} -> "
          f"{tuple(P_k.shape)} within {k1_rel:.3e} of stft_power's max (bound 1e-5)")
    del P_k, P_p
    del rows, y8

    # ---- 22. RoE at full width -----------------------------------------------------
    roe.roe_detect_batch(x[:2], device=dev)  # warm the allocator and the constants
    out, l_roe, wall = launches_of(lambda: roe.roe_detect_batch(x, device=dev))
    check(l_roe == {**zeros, "spectrogram_power": 1, "cascade_sosfilt": 2},
          f"RoE launches {l_roe}, expected K1 1, K4 2")
    T_all = sum(2 + t // cfg.hop_length for _, t in plan)  # T + 1 frames a chunk
    check(out["raining"].shape == (BATCH, T_all) and out["nov"].shape == (BATCH, 6, T_all),
          f"RoE outputs {out['raining'].shape}")
    check(all(np.isfinite(out[k]).all() for k in ("nov", "kurtosis", "crest_factor",
                                                 "diff_energy", "frain_mean")), "RoE not finite")
    cpu = roe.roe_detect_batch(clips[pick], device="cpu")
    for key in ("rain_drop_count", "rain_drop_count_mod", "rain_peaks_count", "frain_mean"):
        check(np.array_equal(out[key][pick], cpu[key]),
              f"RoE {key}: card {out[key][pick]} against CPU {cpu[key]}")
    agree = {k: float((out[k][pick] == cpu[k]).mean()) for k in ("raining", "rain_peaks")}
    check(min(agree.values()) >= 0.999, f"RoE per-frame agreement {agree}")
    times = cuda_times(lambda: roe._roe_batch(x, cfg), 20)
    med = float(np.median(times))
    rainy = out["rain_drop_count_mod"] > 0
    print(f"phase 22 RoE {BATCH} x {CLIP_SEC:.0f} s via roe_detect_batch on the card: launches "
          f"{ {k: v for k, v in l_roe.items() if v} }; raining clips {int(rainy.sum())} (of them "
          f"ping clips {int((rainy & labels).sum())}), mean rain_drop_count_mod "
          f"{out['rain_drop_count_mod'].mean():.2f}, mean rain_peaks_count "
          f"{out['rain_peaks_count'].mean():.2f}; wall {wall * 1e3:.1f} ms incl. the host copy; "
          f"against the CPU path on {N_AGREE} clips: counts and frain_mean identical, raining "
          f"{agree['raining']:.6f}, rain_peaks {agree['rain_peaks']:.6f} (bound 0.999); on {smi}: "
          f"{med:.3f} ms per batch (min {min(times):.3f}, max {max(times):.3f}, n=20) = "
          f"{audio_s / (med / 1e3):.1f} audio-s/s")
    del out, cpu

    # ---- 23. mel at full width -------------------------------------------------------
    params = {"sample_rate": FS}
    mproc = mel_classifier.MelRainProcessor(device=dev)
    mproc.run_batch(x[:2], params)
    pairs, l_mel, wall = launches_of(lambda: mproc.run_batch(x, params))
    check(l_mel == {**zeros, "spectrogram_power": 1}, f"mel launches {l_mel}, expected K1 1")
    cpu_pairs = mel_classifier.MelRainProcessor(device="cpu").run_batch(clips[pick], params)
    same_dec = all(pairs[i][0]["clip_is_rain"] == cpu_pairs[j][0]["clip_is_rain"]
                   for j, i in enumerate(pick))
    frames_agree = float(np.mean([(pairs[i][1]["frame_is_rain"] == cpu_pairs[j][1]["frame_is_rain"])
                                  .mean() for j, i in enumerate(pick)]))
    M_rel = rel_err(mel_spectrogram(x[torch.as_tensor(pick, device=dev)]).cpu().numpy(),
                    mel_spectrogram(torch.from_numpy(clips[pick])).numpy())
    check(same_dec and frames_agree >= 0.999 and M_rel <= 1e-5,
          f"mel, card against CPU: decisions {same_dec}, frames {frames_agree:.6f}, "
          f"mel power {M_rel:.3e}")
    clf = mproc._engine(params)
    times = cuda_times(lambda: clf.process_batch(x), 20)
    med = float(np.median(times))
    dec = np.array([m["clip_is_rain"] for m, _ in pairs])
    print(f"phase 23 mel {BATCH} x {CLIP_SEC:.0f} s via MelRainProcessor.run_batch on the card: "
          f"launches { {k: v for k, v in l_mel.items() if v} }; rain clips {int(dec.sum())}, "
          f"agreement with the labels {float((dec == labels).mean()):.4f}; wall {wall * 1e3:.1f} "
          f"ms incl. the host copy; against the CPU path on {N_AGREE} clips: clip_is_rain "
          f"identical, frame_is_rain {frames_agree:.6f} (bound 0.999), mel power max|d|/max "
          f"{M_rel:.3e} (bound 1e-5); on {smi}: process_batch {med:.3f} ms per batch (min "
          f"{min(times):.3f}, max {max(times):.3f}, n=20) = {audio_s / (med / 1e3):.1f} audio-s/s")
    del pairs, cpu_pairs

    # ---- 24. ALAC ingest at full width -----------------------------------------------
    payloads, expected = alac_clip_payloads(BATCH)
    files = [write_mark_audio_file(None, sample_rate=FS, timestamp=1700000000 + i,
                                   device_id=f"ALAC{i:05d}", file_version=1, payload=p)
             for i, p in enumerate(payloads)]
    decode_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        decoded = [parse_mark_audio_file(f) for f in files]
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    check(all(m["format"] == "alac" for _, m in decoded), "ALAC files not read as ALAC")
    pcm = np.stack([s for s, _ in decoded])
    check(np.array_equal(pcm, expected), "ALAC decode is not the golden PCM's tiling")
    # the same PCM as version-0 files reads back to the same samples, so the
    # main path gets the same input either way
    pcm0 = np.stack([parse_mark_audio_file(write_mark_audio_file(e, sample_rate=FS))[0]
                     for e in expected])
    check(np.array_equal(pcm0, pcm), "version-0 files of the ALAC clips' PCM read back differently")
    proc = RainDetectorProcessor(device=dev)
    proc.run_batch(torch.from_numpy(pcm[:2]).to(dev).to(torch.float32) / 32767.0, PARAMS)
    got, l_alac, wall = launches_of(lambda: proc.run_batch(
        torch.from_numpy(pcm).to(dev).to(torch.float32) / 32767.0, PARAMS))
    check(l_alac == {**zeros, "spectrogram_power": 1, "noise_psd_track": 1,
                     "causal_low_quantile_baseline": 1}, f"ALAC clips' launches {l_alac}")
    check(len(got) == BATCH and len({g[1]["frame_class"].shape for g in got}) == 1,
          "ALAC clips through the main path: results of the wrong shape")
    med_dec = float(np.median(decode_ms))
    print(f"phase 24 ALAC ingest: {BATCH} ALAC MARK files of {CLIP_SEC:.0f} s ("
          f"{sum(map(len, payloads)) / BATCH / 1e3:.1f} kB each against {2 * expected.shape[1] / 1e3:.1f}"
          f" kB of PCM) decoded by the fast decoder bit for bit, host {med_dec:.1f} ms per "
          f"{BATCH}-file batch (min {min(decode_ms):.1f}, n=3) = {BATCH / (med_dec / 1e3):.0f} "
          f"files/s; classifier-only run_batch on the card, launches "
          f"{ {k: v for k, v in l_alac.items() if v} } (input identical to the same PCM read "
          f"from version-0 files); rain clips "
          f"{sum(m['clip_is_rain'] for m, _ in got)}")

    # ---- 25. wind and pitch, card against CPU ------------------------------------------
    # noise and three sharp 500 Hz pulses, as tests/test_wind_chain.py:50-59
    # (this seed's noise lets the pulse walk keep one)
    xw = 0.02 * np.random.default_rng(21).uniform(-1.0, 1.0, 2 * FS)
    k = np.arange(150)
    for t0 in (5000, 12000, 17000):
        xw[t0 : t0 + 150] += 1.5 * np.exp(-k / 12.0) * np.sin(2 * np.pi * 500 * k / FS)
    (pulses, energy, _), l_wind, _ = launches_of(lambda: wind.analyze_energy_peaks(xw, FS, device=dev))
    pulses_cpu, energy_cpu, _ = wind.analyze_energy_peaks(xw, FS, device="cpu")
    check(l_wind == {**zeros, "cascade_sosfilt": 1}, f"wind launches {l_wind}")
    check(pulses == pulses_cpu and np.array_equal(energy, energy_cpu) and len(pulses) > 0,
          f"energy-peak pulses: card {len(pulses)}, CPU {len(pulses_cpu)}")
    t = np.arange(4 * FS) / FS
    gusty = (0.02 * np.random.default_rng(25).standard_normal(t.size)
             + 0.3 * (1 + np.sin(2 * np.pi * 0.4 * t)) ** 2 * np.sin(2 * np.pi * 250 * t))
    mag = torch.abs(stft(torch.from_numpy(gusty.astype(np.float32)))).numpy()
    g_card, g_cpu = (wind.detect_gusts(mag, FS, device=d) for d in (dev, "cpu"))
    check(np.array_equal(g_card[0], g_cpu[0]) and g_card[0].size > 0,
          f"gust times: card {g_card[0].size}, CPU {g_cpu[0].size}")
    nov_rel = max(rel_err(a, b) for a, b in zip(g_card[1:], g_cpu[1:]))
    kf = np.arange(1024)
    frames = np.stack([sum((1.0 / h) * np.sin(2 * np.pi * 220 * h * (kf + 17 * i) / FS)
                           for h in range(1, 5)) for i in range(6)]).astype(np.float32)
    e_card = pitch.compute_eac_for_frames(frames, device=dev)
    e_cpu = pitch.compute_eac_for_frames(frames, device="cpu")
    eac_rel = rel_err(e_card.cpu().numpy(), e_cpu.numpy())
    f_card = pitch.estimate_pitch_from_eac(e_card, FS, device=dev).cpu().numpy()
    f_cpu = pitch.estimate_pitch_from_eac(e_cpu, FS, device="cpu").numpy()
    f_rel = rel_err(f_card, f_cpu)
    check(eac_rel <= 1e-5 and f_rel <= 1e-5, f"EAC {eac_rel:.3e}, pitch {f_rel:.3e}")
    print(f"phase 25 wind and pitch, card against CPU: {len(pulses)} energy-peak pulses identical "
          f"(K4 launches {l_wind['cascade_sosfilt']}), {g_card[0].size} gust times identical, "
          f"novelties max|d|/max {nov_rel:.3e}; EAC {tuple(frames.shape)} max|d|/max "
          f"{eac_rel:.3e}, pitch {f_rel:.3e} (bound 1e-5), {float(np.median(f_card)):.1f} Hz")
    return {"launches": {"roe (phase 22)": l_roe, "mel (phase 23)": l_mel,
                         "ALAC classifier-only (phase 24)": l_alac, "wind (phase 25)": l_wind},
            "k4_err": k4_err, "k4_shapes": k4_shapes}


def cuda_events(fn) -> list:
    """torch.profiler's CUDA events (kernels and memory copies) of one call
    of ``fn``, one entry per name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]


def device_kernels(fn):
    """The CUDA kernels one call of ``fn`` runs, from torch.profiler:
    ``(count, device ms, the three costliest as "name ms xlaunches")``."""
    cuda = cuda_events(fn)
    top = sorted(cuda, key=lambda e: -e.self_device_time_total)[:3]
    return (sum(e.count for e in cuda), sum(e.self_device_time_total for e in cuda) / 1e3,
            "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                      for e in top))


def device_copies(fn):
    """The memory copies one call of ``fn`` makes, from torch.profiler:
    ``(count, device ms)``."""
    copies = [e for e in cuda_events(fn) if e.key.startswith("Memcpy")]
    return sum(e.count for e in copies), sum(e.self_device_time_total for e in copies) / 1e3


def k9_rows(seed: int, n: int):
    """Rows that stress the distance filter: uniform noise (more than 64
    maxima), few levels (equal heights everywhere), plateaus, rows of zeros
    (no peak) and a single peak, and a mask of 5% of the positions, which
    the caller flips in the rows' local maxima."""
    rng = np.random.default_rng(seed)
    one = np.zeros(n)
    one[n // 3] = 1.0
    rows = np.stack([rng.random(n), np.round(rng.random(n) * 4), np.repeat(rng.random(n), 8)[:n],
                     np.zeros(n), one]).astype(np.float32)
    return np.tile(rows, (40, 1)), rng.random((5 * 40, n)) < 0.05


def k9_confirmer_rows(clip: np.ndarray, dev):
    """K9's inputs in the confirmer, captured from one clip without a mask:
    ``(x, is_peak, distance)``; 871 windows of 384 samples and d = 45 for a
    10 s clip."""
    from audio_processing_tools_tpu_torch.models import time_domain as ttd

    captured = []
    real_select = ttd.select_peaks_by_distance

    def capture(x, is_peak, distance, max_peaks=64):
        captured.append((x.clone(), is_peak.clone(), distance))
        return real_select(x, is_peak, distance, max_peaks)

    ttd.select_peaks_by_distance = capture
    try:
        ttd.TimeDomainRainDetector(ttd.build_time_domain_config(PARAMS), device=dev).process(clip)
    finally:
        ttd.select_peaks_by_distance = real_select
    return captured[0]


def with_nonfinite_peaks(x: np.ndarray, is_peak: np.ndarray, seed: int) -> np.ndarray:
    """A copy of rows ``x`` whose peaks are -inf (10% of them), NaN of either
    sign (5%) or a zero of either sign (20%, so that -0 and +0 peaks tie)."""
    u = np.where(is_peak, np.random.default_rng(seed).random(x.shape), 1.0)
    x = x.astype(np.float32).copy()
    x[u < 0.10] = -np.inf
    x[(u >= 0.10) & (u < 0.13)] = np.nan
    x[(u >= 0.13) & (u < 0.15)] = -np.nan
    x[(u >= 0.15) & (u < 0.25)] = 0.0
    x[(u >= 0.25) & (u < 0.35)] = -0.0
    return x


def k9_edge_cases(seed: int = 26) -> list:
    """Rows and settings that reach each path of K9, ``(label, x, is_peak,
    distance, max_peaks)`` on the host: non-finite and signed-zero peaks;
    caps that fall among the -inf ties, where non-peaks use up steps, and
    among NaN peaks; exactly 64 and 65 peaks; rows of 1, 2 and 33
    positions; distances below 2, at and past the row's length, and
    negative."""
    rng = np.random.default_rng(seed)
    out = []
    x = rng.random((40, 384)).astype(np.float32)
    pk = rng.random(x.shape) < 0.25
    x = with_nonfinite_peaks(x, pk, seed)
    out += [("non-finite and signed-zero peaks", x, pk, d, cap)
            for d in (1, 7, 45) for cap in (64, 200, 5000)]
    # rows of -inf with f finite peaks, m peaks at -inf, 4 NaN peaks and 4
    # NaN non-peaks (non-peaks count as -inf): fewer peaks than one pass of
    # ranks (64), then more
    for n, f, m in ((256, 12, 30), (384, 20, 100)):
        x = np.full((8, n), -np.inf, np.float32)
        pk = np.zeros((8, n), bool)
        for r in range(8):
            pos = rng.permutation(n)
            x[r, pos[:f]] = rng.random(f)
            pk[r, pos[: f + m + 4]] = True
            x[r, pos[f + m : f + m + 8]] = np.nan
        out += [(f"caps among -inf and NaN ties, {f + m + 4} peaks", x, pk, d, cap)
                for d in (3, 20)
                for cap in (f, f + 1, f + 8, f + 28, f + m + 3, n - 4, n - 2, n)]
    for peaks in (64, 65):
        x = rng.random((16, 384)).astype(np.float32)
        pk = np.zeros(x.shape, bool)
        for r in range(16):
            pk[r, rng.choice(384, peaks, replace=False)] = True
        out += [(f"exactly {peaks} peaks", x, pk, d, cap)
                for d in (3, 45) for cap in (63, 64, 65, 66)]
    for n in (1, 2, 33):
        x = rng.random((24, n)).astype(np.float32)
        x[::2] = np.round(x[::2] * 2)  # ties
        pk = rng.random(x.shape) < 0.5
        out += [(f"rows of {n}", x, pk, d, cap) for d in (0, 1, 2, 45) for cap in (1, 64)]
    for n in (384, 1024):
        x = rng.random((16, n)).astype(np.float32)
        pk = rng.random(x.shape) < 0.3
        out += [(f"distance {d} at n {n}", x, pk, d, cap)
                for d in (-5, 0, 1, n - 1, n, n + 7, 10**6) for cap in (64, 5000)]
    return out


def rain_minutes(n_clips: int, seconds: float, seed: int):
    """Noise and loud 520 Hz drops, 40 a minute (``tests/test_dsd_transform.py:24-30``),
    float32 in [-1, 1]."""
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    k = np.arange(600)
    drop = 1.5 * np.exp(-k / 100.0) * np.sin(2 * np.pi * 520 * k / FS)
    x = 0.01 * rng.standard_normal((n_clips, n), dtype=np.float32)
    for i in range(n_clips):
        for t0 in rng.integers(0, n - 700, int(40 * seconds / 60)):
            x[i, t0 : t0 + 600] += drop
    return np.clip(x, -1.0, 1.0)


def duty_scenarios(seed: int = 1234):
    """The four 200 s recordings of ``tests/test_dsd_transform.py:284-301``,
    from its seed: rain then dry, rain again in a check window, silence, a
    mid-minute start.  (The float32 FFT can move a quiet frame's peak bin
    against the float64 emulator: seeds 2 and 29 move pft bin 61 of a check
    window in the JAX package and in the port alike.)"""
    rng = np.random.default_rng(seed)
    k = np.arange(800)
    ping = np.exp(-k / 60.0) * sum(a * np.sin(2 * np.pi * f * k / FS) for f, a in [(520, 1.0), (900, 0.5)])
    n = FS * 200

    def build(windows):
        x = 0.0005 * rng.standard_normal(n)
        for lo_s, hi_s, m in windows:
            for t0 in rng.integers(int(FS * lo_s), int(FS * hi_s), m):
                x[t0 : t0 + 800] += 0.5 * ping
        return np.clip(x, -1, 1)

    return {"rain_then_dry": (build([(0.25, 50, 25)]), 0.0),
            "re_engage": (build([(0.25, 50, 25), (177.2, 179.5, 8), (181, 198, 12)]), 0.0),
            "all_silent": (np.zeros(n), 0.0),
            "ts_offset": (build([(0.25, 50, 25)])[: FS * 150], 23.0)}


def roe_recordings(n_rec: int, minutes: int, seed: int = 31):
    """int16 recordings of harmonic-ping rain, the RoE classifier's kind,
    ``minutes`` complete minutes each (``tests/test_dsd_transform.py:123-132``)."""
    rng = np.random.default_rng(seed)
    n = 60 * FS * minutes
    k = np.arange(1000)
    ping = sum((1.0 / h) * np.sin(2 * np.pi * 500.0 * h * k / FS) for h in range(1, 6))
    ping = 0.6 * np.exp(-k / 80.0) * ping
    out = np.empty((n_rec, n), np.int16)
    for i in range(n_rec):
        x = 0.003 * rng.standard_normal(n)
        for t0 in rng.integers(0, n - 1200, 30 * (1 + i % 4) * minutes):  # 30-120 a minute
            x[t0 : t0 + 1000] += ping
        out[i] = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    return out


def confirmer_dsd_etl_phases(smi: str, pcm: np.ndarray, stage1: np.ndarray) -> dict:
    """Phases 26-30: the stage-2 time-domain confirmer with K9, the DSD
    minute vectors, the transform ETL's per-minute RoE batch and the
    framework processors.  ``pcm`` holds phase 4's int16 clips and
    ``stage1`` their classifier-only rain frames.  Returns each path's
    launches and K9's numbers for the kernels line."""
    import functools

    import torch

    from audio_processing_tools_tpu_torch import _kernels, transform
    from audio_processing_tools_tpu_torch.framework import NoiseProcessor, RainProcessor
    from audio_processing_tools_tpu_torch.host_analysis import (
        DsdProcessingEmulator,
        dsd_minutes_device,
        dsd_minutes_device_duty_cycled,
    )
    from audio_processing_tools_tpu_torch.models import roe
    from audio_processing_tools_tpu_torch.models import time_domain as ttd
    from audio_processing_tools_tpu_torch.ops import peaks as tpk

    dev = torch.device("cuda", 0)
    zeros = {k: 0 for k in _kernels.LAUNCHES}
    clips = pcm.astype(np.float32) / np.float32(32767.0)
    pick = np.r_[np.arange(0, BATCH, 2)[: N_AGREE // 2], np.arange(1, BATCH, 2)[: N_AGREE // 2]]
    td_cfg = ttd.build_time_domain_config(PARAMS)

    # ---- 26. K9 against its plain version -------------------------------------------
    # the confirmer's own rows: K9's inputs captured from one clip without a
    # mask (871 windows of 384 samples, d = 45)
    env, is_max, dist = k9_confirmer_rows(clips[1], dev)
    check(tuple(env.shape) == (871, 384) and dist == 45, f"K9's rows {tuple(env.shape)}, d {dist}")
    cases = [("the confirmer's rows", env, is_max, dist, 64),
             ("the confirmer's rows, non-finite peaks",
              torch.from_numpy(with_nonfinite_peaks(env.cpu().numpy(), is_max.cpu().numpy(), 26))
              .to(dev), is_max, dist, 64)]
    for n in (384, 1024, 3, 100):
        xr, flip = k9_rows(n, n)
        xr = torch.from_numpy(xr).to(dev)
        pk = tpk.local_maxima(xr) ^ torch.from_numpy(flip).to(dev)
        cases += [(f"adversarial rows of {n}", xr, pk, d, cap)
                  for d in (1, 7, 45) for cap in (64, 3, 5000)]
        if n in (384, 100):  # the same rows at a pointer 4 (x) and 1 (is_peak) bytes off
            xu = torch.empty(xr.numel() + 1, device=dev)[1:].view(xr.shape).copy_(xr)
            pku = torch.empty(pk.numel() + 1, dtype=torch.bool, device=dev)[1:].view(pk.shape)
            pku.copy_(pk)
            cases += [(f"unaligned rows of {n}", xu, pku, d, cap) for d in (7, 45)
                      for cap in (64, 5000)]
            cases += [(f"rows of {n}, only x unaligned", xu, pk, 45, 64)]
    cases += [(label, torch.from_numpy(x).to(dev), torch.from_numpy(pk).to(dev), d, cap)
              for label, x, pk, d, cap in k9_edge_cases()]
    # caps of 0 and below run no step (the loop's range is empty): is_peak
    cases += [(f"cap {cap}", env, is_max, dist, cap) for cap in (0, -1, -100)]
    k9_ok = 0
    for label, xr, pk, d, cap in cases:
        got = tpk._select_peaks_by_distance_cuda(xr, pk, d, cap)
        ref = tpk._select_peaks_by_distance_plain(xr, pk, d, cap)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"K9, {label}, at {tuple(xr.shape)}, d {d}, cap {cap}: "
                                     f"{int((got != ref).sum())} positions differ")
        k9_ok += 1
    for cap in (0, -1):
        check(torch.equal(tpk.select_peaks_by_distance(env, is_max, dist, cap), is_max),
              f"select_peaks_by_distance on the card with max_peaks {cap}: not is_peak")
    k9_ms = graph_ms(lambda: tpk._select_peaks_by_distance_cuda(env, is_max, dist, 64))
    k9_plain = float(np.median(cuda_times(
        lambda: tpk._select_peaks_by_distance_plain(env, is_max, dist, 64), 3)))
    # K9's work: x and the mask read once and the mask written (6 bytes a
    # position); a row of P peaks ranks them against each other (P^2
    # compares) and walks its candidates, up to the 64-step cap, with about
    # ten integer operations on each lane's word of 32 positions a step
    peaks = is_max.sum(-1).to(torch.float64)
    k9_work = (6 * env.numel(), (peaks**2 + 10 * 32 * torch.clamp(peaks, max=64)).sum().item())
    k9_bound, k9_by = bound_of(*k9_work)
    print(f"phase 26 K9 select_peaks_by_distance on {smi}: {k9_ok} cases the plain version's bits "
          f"(the confirmer's {tuple(env.shape)}, d = {dist}, also with non-finite peaks; "
          f"adversarial rows of 3-1,024 positions, d 1/7/45, caps 3/64/5000, some at unaligned "
          f"pointers; non-finite and signed-zero peaks, caps among -inf and NaN ties, exactly "
          f"64 and 65 peaks, rows of 1, 2 and 33, d -5 to 10^6, caps 0, -1 and -100; and "
          f"max_peaks 0 and -1 through select_peaks_by_distance); "
          f"{k9_ms:.4f} ms per launch in a graph of 20, "
          f"bound {k9_bound:.5f} by {k9_by}; plain {k9_plain:.3f} ms (n=3)")

    # ---- 27. the confirmer, card against CPU, then 128 clips on the card --------
    det = ttd.TimeDomainRainDetector(td_cfg, device=dev)
    det_cpu = ttd.TimeDomainRainDetector(td_cfg, device="cpu")
    worst = {"crest_factor": 0.0, "kurtosis": 0.0}
    confirmed_frames = 0
    for i in pick:
        a = det.process(clips[i], stage1_is_rain=stage1[i])
        b = det_cpu.process(clips[i], stage1_is_rain=stage1[i])
        for key in ("confirmed_mask", "confirmed_counts", "candidate_peaks"):
            check(np.array_equal(a[key], b[key]), f"confirmer clip {i}: {key} card != CPU")
        check(len(a["details"]) == len(b["details"]) and all(
            np.array_equal(u["peak_indices_local"], v["peak_indices_local"])
            for u, v in zip(a["details"], b["details"])), f"confirmer clip {i}: peak indices")
        for key in worst:
            den = np.maximum(np.abs(b[key]), 1e-30)
            worst[key] = max(worst[key], float((np.abs(a[key] - b[key]) / den).max()))
        confirmed_frames += int(a["confirmed_mask"].sum())
    check(max(worst.values()) <= 1e-5, f"confirmer crest/kurtosis card vs CPU {worst}")
    check(confirmed_frames > 0, "the confirmer confirmed no frame on the ping clips")
    det.process(clips[0], stage1_is_rain=stage1[0])  # warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    per_clip, confirmed = [], np.zeros(BATCH, int)
    _kernels.reset_launches()
    for i in range(BATCH):
        t0 = time.perf_counter()
        out = det.process(clips[i], stage1_is_rain=stage1[i])  # ends in a copy to the host
        per_clip.append((time.perf_counter() - t0) * 1e3)
        confirmed[i] = int(out["confirmed_counts"].sum())
    l_td = dict(_kernels.LAUNCHES)
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    check(l_td == {**zeros, "select_peaks_by_distance": BATCH},
          f"confirmer launches over {BATCH} clips {l_td}, expected K9 {BATCH}")
    n_kern, busy, top_td = device_kernels(lambda: det.process(clips[1], stage1_is_rain=stage1[1]))
    print(f"phase 27 confirmer ({len(td_cfg.mode_bands)} mode bands, stage 1 from phase 4): "
          f"{N_AGREE} clips card against CPU, masks, counts and peak indices identical, crest "
          f"max|d|/|ref| {worst['crest_factor']:.3e}, kurtosis {worst['kurtosis']:.3e} (bound "
          f"1e-5); {BATCH} x {CLIP_SEC:.0f} s clips through process on {smi}: "
          f"{float(np.median(per_clip)):.3f} ms per clip (min {min(per_clip):.3f}, max "
          f"{max(per_clip):.3f}, host clock incl. the results' copy), hand-kernel launches "
          f"{ {k: v for k, v in l_td.items() if v} } ({l_td['select_peaks_by_distance'] / BATCH:.0f} "
          f"K9 a clip), {n_kern} CUDA kernels a clip ({busy:.3f} ms device busy, profiler; "
          f"costliest {top_td}), "
          f"peak memory {peak_mb:.1f} MiB; confirmed drops on rain clips "
          f"{int(confirmed[1::2].sum())}, on noise clips {int(confirmed[0::2].sum())}")

    # ---- 28. DSD minutes on the card ----------------------------------------------
    minutes = rain_minutes(BATCH, 60.0, seed=28)
    x_dev = torch.from_numpy(minutes).to(dev)  # 128 x 669,720 float32 = 343 MB
    dsd_minutes_device(x_dev[:2], device=dev)  # warm
    got, l_dsd, _ = launches_of(lambda: dsd_minutes_device(x_dev, device=dev))
    check(got.shape == (BATCH, 1, 100) and l_dsd == zeros, f"DSD {got.shape}, launches {l_dsd}")
    cpu = dsd_minutes_device(minutes[:8], device="cpu")
    emu = np.stack([np.asarray(DsdProcessingEmulator(FS, 512, 512, False, 0)
                               .process_audio_data(m.astype(np.float64), ts=0)) for m in minutes[:8]])
    for label, ref in (("CPU", cpu), ("emulator", emu)):
        same = float((got[:8, :, 62:] == ref[:, :, 62:]).mean())
        check(np.array_equal(got[:8, :, :62], ref[:, :, :62]) and same >= 0.95
              and np.abs(got[:8, :, 62:] - ref[:, :, 62:]).max() <= 1,
              f"DSD card against the {label}: bins 0-61 or fft bins (equal {same:.4f})")
    fft_equal = float((got[:8, :, 62:] == emu[:, :, 62:]).mean())
    dsd_times = cuda_times(lambda: dsd_minutes_device(x_dev, device=dev), 10)
    n_dsd, busy_dsd, top_dsd = device_kernels(lambda: dsd_minutes_device(x_dev, device=dev))
    del x_dev
    duty_ms, duty_minutes = [], 0
    for name, (x, ts) in duty_scenarios().items():
        ref = DsdProcessingEmulator(FS, 512, 512, False, 0).process_audio_data(x, ts)
        t0 = time.perf_counter()
        vecs = dsd_minutes_device_duty_cycled(x.astype(np.float32), FS, 512, ts=ts, device=dev)
        duty_ms.append((time.perf_counter() - t0) * 1e3)
        check(len(vecs) == len(ref) >= 2 and all(np.array_equal(v, r) for v, r in zip(vecs, ref)),
              f"duty-cycled DSD {name}: not the emulator's bins")
        duty_minutes += len(vecs)
    print(f"phase 28 DSD on {smi}: dsd_minutes_device {BATCH} x 60 s (343 MB on the card) -> "
          f"{got.shape}, {float(np.median(dsd_times)):.3f} ms per batch (min {min(dsd_times):.3f}, "
          f"max {max(dsd_times):.3f}, n=10, incl. the copy of the vectors), {n_dsd} CUDA kernels "
          f"({busy_dsd:.3f} ms device busy; costliest {top_dsd}), no hand kernel; 8 clips "
          f"against the CPU path and the "
          f"emulator: bins 0-61 identical, fft bins within 1 ({fft_equal:.4f} equal to the "
          f"emulator); duty-cycled, 4 scenarios of 200 s: {duty_minutes} minutes bit-equal to the "
          f"emulator, {sum(duty_ms):.1f} ms in all")

    # ---- 29. the transform's per-minute RoE batch ----------------------------------
    recs = roe_recordings(16, 2)
    transform._classify_minutes(recs[:1], FS, device=dev)  # warm
    res, l_etl, wall = launches_of(lambda: transform._classify_minutes(list(recs), FS, device=dev))
    check(l_etl == {**zeros, "spectrogram_power": 1, "cascade_sosfilt": 2},
          f"minute batch launches {l_etl}, expected K1 1, K4 2")
    res_cpu = transform._classify_minutes(list(recs), FS, device="cpu")
    ulps = 0
    for (d_card, f_card), (d_cpu, f_cpu) in zip(res, res_cpu):
        check(np.array_equal(d_card, d_cpu), f"minute batch counts: card {d_card}, CPU {d_cpu}")
        ulps = max(ulps, int(np.abs(f_card.view(np.int32).astype(np.int64)
                                    - f_cpu.view(np.int32).astype(np.int64)).max()))
    check(ulps <= 1, f"frain_mean card against CPU: {ulps} ulps")
    drops = np.concatenate([d for d, _ in res])
    etl_ms = [wall * 1e3]
    for _ in range(4):
        t0 = time.perf_counter()
        transform._classify_minutes(list(recs), FS, device=dev)
        etl_ms.append((time.perf_counter() - t0) * 1e3)
    # RoE's default check_duration (10 s) bounds the chunks of each minute
    rows = 2 * 16 * len(roe._chunk_plan(roe.build_roe_config(), 60 * FS))
    n_etl, busy_etl, top_etl = device_kernels(
        lambda: transform._classify_minutes(list(recs), FS, device=dev))
    print(f"phase 29 transform minute batch, 16 recordings x 2 minutes (32 x {60 * FS:,} samples, "
          f"{rows} RoE chunk rows) on {smi}: hand-kernel launches "
          f"{ {k: v for k, v in l_etl.items() if v} }, {n_etl} CUDA kernels ({busy_etl:.3f} ms "
          f"device busy; costliest {top_etl}); {float(np.median(etl_ms)):.1f} ms per batch "
          f"(min {min(etl_ms):.1f}, max {max(etl_ms):.1f}, n=5, host clock from int16 on the host "
          f"to counts on the host); minutes with drops {int((drops > 0).sum())}/{drops.size}, "
          f"mean rain_drop_count {drops.mean():.2f}; against the CPU: counts identical, "
          f"frain_mean within {ulps} ulp")

    # ---- 30. the framework processors, card against CPU ------------------------------
    params = {**DEFAULT_PARAMS}
    four = pick[[0, 1, N_AGREE // 2, N_AGREE // 2 + 1]]
    _, l_noise, _ = launches_of(
        lambda: NoiseProcessor(name="noise", device=dev).run(clips[four[0]], params))
    floors = 0.0
    for i in four:
        m_card, s_card = NoiseProcessor(name="noise", device=dev).run(clips[i], params)
        m_cpu, s_cpu = NoiseProcessor(name="noise", device="cpu").run(clips[i], params)
        check(np.array_equal(s_card["frame_class"], s_cpu["frame_class"])
              and m_card["rain_frame_fraction"] == m_cpu["rain_frame_fraction"],
              f"NoiseProcessor clip {i}: frames differ")
        for key in ("mean_noise_floor_db", "median_noise_floor_db"):
            floors = max(floors, abs(m_card[key] - m_cpu[key]) / abs(m_cpu[key]))
        r_card, _ = RainProcessor(name="roe", fn=functools.partial(roe.rain_detection_algo,
                                                                    device=dev)).run(clips[i], {})
        r_cpu, _ = RainProcessor(name="roe", fn=functools.partial(roe.rain_detection_algo,
                                                                   device="cpu")).run(clips[i], {})
        check(all(r_card[k] == r_cpu[k] for k in ("rain_drops", "frain_mean", "rain_drop_count",
                                                  "rain_peaks_count", "rain_drop_count_mod")),
              f"RainProcessor clip {i}: card {r_card} against CPU {r_cpu}")
    check(floors <= 1e-5, f"NoiseProcessor noise floors {floors:.3e} relative")
    print(f"phase 30 processors on 4 clips, card against CPU: NoiseProcessor (the default "
          f"configuration, launches { {k: v for k, v in l_noise.items() if v} }) frames and "
          f"decisions identical, noise floors within {floors:.3e} relative (bound 1e-5); "
          f"RainProcessor over rain_detection_algo: counts and frain_mean identical")
    return {"launches": {"confirmer (phase 27)": l_td, "DSD (phase 28)": l_dsd,
                         "transform minute batch (phase 29)": l_etl, "NoiseProcessor (phase 30)": l_noise},
            "k9": {"ms": k9_ms, "plain_ms": k9_plain, "work": k9_work}}


RECORDING = 78_482 * 512  # one 60-minute recording: 40,182,784 samples
SEQ_N = 872 * 128  # the batch form's clips: 111,616 samples, a multiple of 2 x 128
BF_PARAMS = {"sample_rate": FS, "detector": PARAMS["detector"], "clip_rain_min_frames": 3}


def launches_of(fn):
    """``(fn(), the kernel launches it made, host seconds)``."""
    import torch

    from audio_processing_tools_tpu_torch import _kernels

    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_kernels.LAUNCHES), time.perf_counter() - t0


def long_recording(n: int, seed: int = 32) -> np.ndarray:
    """Noise with sharp 520 Hz pings, one a second on average, as
    ``tests/test_sequence_parallel.py:18-23`` makes them; float32."""
    rng = np.random.default_rng(seed)
    x = 0.01 * rng.standard_normal(n, dtype=np.float32)
    k = np.arange(800)
    ping = (0.5 * np.exp(-k / 60.0) * np.sin(2 * np.pi * 520 * k / FS)).astype(np.float32)
    for t0 in rng.integers(2000, n - 2000, n // FS):
        x[t0 : t0 + 800] += ping
    return x


def ulps(a, b) -> int:
    """The largest distance in float32 units in the last place."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def plain_band_flux(P, mode_bands):
    """Band power and mode flux from a causal (F, T) power, written out here
    from the detector's definition: the bins of 400-3,500 Hz, each bin's
    rise over the frame two back clamped at 0 (0 for the first two frames),
    summed over each mode band's bins in float64."""
    import torch

    freqs = np.linspace(0.0, FS / 2.0, P.shape[0])
    rows = np.flatnonzero((freqs >= 400.0) & (freqs <= 3500.0))
    Pb = P[torch.from_numpy(rows).to(P.device)]  # (K, T)
    Pd = Pb.double()
    d2 = torch.zeros_like(Pd)
    d2[:, 2:] = (Pd[:, 2:] - Pd[:, :-2]).clamp_min(0.0)
    fb = freqs[rows]
    masks = torch.tensor(np.stack([(fb >= lo) & (fb <= hi) for lo, hi in mode_bands]),
                         dtype=torch.float64, device=P.device)
    return Pb, masks @ d2


def max_rel(a, ref) -> float:
    """max |a - ref| over max |ref|, in float64."""
    return float((a.double() - ref.double()).abs().max()) / float(ref.double().abs().max())


def backfill_phases(smi: str) -> dict:
    """Phases 31-35: the fleet backfill path.  The corpus, the time-sharded
    K1, the sharded pipeline's three models, the orchestrator's pandas-free
    core and the backfill CLI as subprocesses.  Returns the launches of the
    in-process paths for the kernels line."""
    import socket
    import tempfile

    import torch

    from audio_processing_tools_tpu_torch.framework.batch import run_batches
    from audio_processing_tools_tpu_torch.io.audio import get_input_data, get_keys
    from audio_processing_tools_tpu_torch.models import roe
    from audio_processing_tools_tpu_torch.models.band_noise import band_noise_process
    from audio_processing_tools_tpu_torch.models.spectral_noise import (
        RainDetectorProcessor,
        SpectralNoiseEngine,
    )
    from audio_processing_tools_tpu_torch.ops._device import f32_recip
    from audio_processing_tools_tpu_torch.ops.spectrogram import spectrogram_power
    from audio_processing_tools_tpu_torch.ops.stft import stft_power
    from audio_processing_tools_tpu_torch.parallel import (
        Mesh,
        ShardedRainPipeline,
        local_rows,
        make_mesh,
    )
    from audio_processing_tools_tpu_torch.parallel import sequence as seq
    from audio_processing_tools_tpu_torch.parallel.mesh import _median
    from audio_processing_tools_tpu_torch.utils.corpus import (
        CLIP_CLASSES,
        HARD_CLIP_CLASSES,
        make_labeled_corpus,
        write_corpus_dir,
    )

    from audio_processing_tools_tpu_torch import _kernels

    dev = torch.device("cuda", 0)
    zeros = {k: 0 for k in _kernels.LAUNCHES}
    tmp = tempfile.TemporaryDirectory(prefix="apt_backfill_")
    procs = []
    try:
        # ---- 31. the corpus ----------------------------------------------------------
        corpus_dir = str(Path(tmp.name) / "corpus")
        counts = {**{k: 16 for k in CLIP_CLASSES}, **{k: 12 for k in HARD_CLIP_CLASSES}}
        t0 = time.perf_counter()
        clips, labels, kinds = make_labeled_corpus(seed=31, seconds=CLIP_SEC, counts=counts)
        synth_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        paths = write_corpus_dir(corpus_dir, clips, labels, kinds)
        write_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        data = get_input_data(get_keys("LocalPath", test_vector_path=corpus_dir), "LocalPath",
                              FS, CLIP_SEC, True, None, None, 2)
        load_ms = (time.perf_counter() - t0) * 1e3
        keys = list(data)
        corpus = np.stack([data[k]["file_contents"] for k in keys])  # key order, as loaded
        truth = np.array([bool(data[k]["raining"]) for k in keys])
        check(len(paths) == BATCH and corpus.shape == (BATCH, int(FS * CLIP_SEC))
              and corpus.dtype == np.float32 and int(truth.sum()) == int(labels.sum()),
              f"corpus {corpus.shape} {corpus.dtype}, {len(paths)} files")
        print(f"phase 31 corpus: {BATCH} clips x {CLIP_SEC:.0f} s ({len(CLIP_CLASSES)} classes x "
              f"16, {len(HARD_CLIP_CLASSES)} hard classes x 12; {int(truth.sum())} rain) in "
              f"{synth_ms:.0f} ms, written as MARK files in {write_ms:.0f} ms, read back through "
              f"get_input_data in {load_ms:.0f} ms (host clock)")

        # ---- 32. the time-sharded K1 ---------------------------------------------------
        x_rec = torch.from_numpy(long_recording(RECORDING)).to(dev)
        mesh4 = Mesh([dev] * 4, ("files",))
        bands = tuple(PARAMS["detector"]["mode_bands"])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        P_sh, l_seq, _ = launches_of(lambda: seq.sequence_sharded_stft_power(x_rec, mesh4))
        peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
        P_ref = spectrogram_power(x_rec, center=False)
        P_plain = stft_power(x_rec, center=False)
        T_rec = RECORDING // 128 - 1
        check(tuple(P_sh.shape) == tuple(P_ref.shape) == tuple(P_plain.shape) == (129, T_rec),
              f"time-sharded power {tuple(P_sh.shape)}")
        seq_same = torch.equal(P_sh, P_ref)
        seq_rel, seq_plain = max_rel(P_sh, P_ref), max_rel(P_sh, P_plain)
        check(l_seq == {**zeros, "spectrogram_power": 1} and (seq_same or seq_rel <= 1e-5)
              and seq_plain <= 1e-5,
              f"time-sharded K1: launches {l_seq}, max|d|/max {seq_rel:.3e} against the unsharded "
              f"K1, {seq_plain:.3e} against stft_power")
        flux, l_flux, _ = launches_of(
            lambda: seq.sequence_sharded_band_flux(x_rec, mesh4, fs=FS, mode_bands=bands))
        bp_plain, mf_plain = plain_band_flux(P_plain, bands)
        bp_rel = max_rel(flux["band_power"], bp_plain)
        flux_rel = max_rel(flux["mode_flux"], mf_plain)
        check(l_flux == {**zeros, "spectrogram_power": 1} and bp_rel <= 1e-5 and flux_rel <= 1e-4
              and flux["mode_flux"].shape == (5, T_rec) and float(flux["mode_flux"].max()) > 0,
              f"time-sharded flux: launches {l_flux}, band power max|d|/max {bp_rel:.3e}, mode "
              f"flux {flux_rel:.3e} against the plain flux")
        del P_plain, bp_plain, mf_plain
        xb = torch.from_numpy(corpus[:, :SEQ_N]).to(dev)
        grid = Mesh([[dev, dev], [dev, dev]], ("files", "seq"))
        P2, l_2d, _ = launches_of(lambda: seq.batch_sequence_sharded_stft_power(xb, grid))
        P2_ref = spectrogram_power(xb, center=False)
        P2_plain = stft_power(xb, center=False)
        two_same = torch.equal(P2, P2_ref)
        two_rel, two_plain = max_rel(P2, P2_ref), max_rel(P2, P2_plain)
        check(tuple(P2.shape) == tuple(P2_ref.shape) == tuple(P2_plain.shape)
              == (BATCH, 129, SEQ_N // 128 - 1)
              and l_2d == {**zeros, "spectrogram_power": 1} and (two_same or two_rel <= 1e-5)
              and two_plain <= 1e-5,
              f"2 x 2 mesh: {tuple(P2.shape)}, launches {l_2d}, max|d|/max {two_rel:.3e} against "
              f"the unsharded K1, {two_plain:.3e} against stft_power")
        ms = {label: float(np.median(cuda_times(fn, 10))) for label, fn in (
            ("sharded", lambda: seq.sequence_sharded_stft_power(x_rec, mesh4)),
            ("unsharded", lambda: spectrogram_power(x_rec, center=False)),
            ("flux", lambda: seq.sequence_sharded_band_flux(x_rec, mesh4, fs=FS, mode_bands=bands)),
            ("2x2", lambda: seq.batch_sequence_sharded_stft_power(xb, grid)),
            ("2x2 unsharded", lambda: spectrogram_power(xb, center=False)))}
        sh_kern, sh_busy, sh_top = device_kernels(
            lambda: seq.sequence_sharded_stft_power(x_rec, mesh4))
        del P_sh, P_ref, flux, P2, P2_ref, P2_plain, x_rec
        print(f"phase 32 time-sharded K1 on {smi}: 60-minute recording ({RECORDING:,} samples) "
              f"on 4 entries of {dev} -> (129, {T_rec:,}) power "
              f"({'the same bits as' if seq_same else f'max|d|/max {seq_rel:.3e} against'} the "
              f"unsharded causal K1; max|d|/max {seq_plain:.3e} against stft_power, bound 1e-5), "
              f"launches {l_seq['spectrogram_power']}, "
              f"{ms['sharded']:.3f} ms (unsharded {ms['unsharded']:.3f} ms; median of 10, CUDA "
              f"events), peak memory {peak_mb:.1f} MiB, {sh_kern} CUDA kernels in one sharded call "
              f"({sh_busy:.3f} ms device busy; costliest {sh_top}); band flux {ms['flux']:.3f} ms, "
              f"launches {l_flux['spectrogram_power']}, against the plain float64 flux from "
              f"stft_power: band power max|d|/max {bp_rel:.3e} (bound 1e-5), mode flux "
              f"{flux_rel:.3e} (bound 1e-4); {BATCH} x {SEQ_N:,} on the 2 x 2 (files, seq) mesh: "
              f"{'the same bits as the unsharded K1' if two_same else f'max|d|/max {two_rel:.3e}'}, "
              f"{two_plain:.3e} against stft_power, launches "
              f"{l_2d['spectrogram_power']}, {ms['2x2']:.3f} ms (unsharded {ms['2x2 unsharded']:.3f})")

        # ---- 33. the sharded pipeline, three models ----------------------------------
        mesh1 = make_mesh(1)
        models = {"spectral": (BF_PARAMS, {"spectrogram_power": 1, "noise_psd_track": 2,
                                           "causal_low_quantile_baseline": 1}),
                  "roe": ({"sample_rate": FS, "check_duration": CLIP_SEC},
                          {"spectrogram_power": 1, "cascade_sosfilt": 2}),
                  "band_noise": ({"sample_rate": FS}, {"spectrogram_power": 1,
                                                       "cascade_sosfilt": 2, "band_noise_scan": 1})}
        pick = np.arange(0, BATCH, BATCH // N_AGREE)  # every 8th key: all nine classes
        x_all = torch.from_numpy(corpus).to(dev)
        copy_host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.from_numpy(corpus).to(dev)
            torch.cuda.synchronize()
            copy_host.append((time.perf_counter() - t0) * 1e3)
        step_launches, lines = {}, []
        spectral_counts = None
        for model, (params, expect) in models.items():
            pipe = ShardedRainPipeline(params, mesh1, model=model)
            pipe.step(corpus[:2])  # warm
            out, l_step, _ = launches_of(lambda: pipe.step(corpus))
            check(l_step == {**zeros, **expect}, f"{model} step launches {l_step}")
            step_launches[f"sharded {model} step (phase 33)"] = l_step
            pc = {k: local_rows(v) for k, v in out["per_clip"].items()}
            agg = {k: np.asarray(v) for k, v in out["aggregates"].items()}
            cpu = ShardedRainPipeline(params, make_mesh(1, device="cpu"), model=model).step(
                corpus[pick])
            pcc = {k: local_rows(v) for k, v in cpu["per_clip"].items()}
            check(int(agg["total_clips"]) == BATCH
                  and int(agg["total_rain_clips"]) == int(pc["clip_is_rain"].sum()),
                  f"{model} aggregates {agg}")
            if model == "spectral":
                for key in ("frame_class", "rain_frame_count", "clip_is_rain"):
                    check(np.array_equal(pc[key][pick], pcc[key]), f"spectral {key}: card != CPU")
                direct = SpectralNoiseEngine(pipe.cfg, device=dev).process_batch(x_all)
                check(np.array_equal(direct["frame_class"].cpu().numpy(), pc["frame_class"])
                      and np.array_equal(direct["rain_conf"].cpu().numpy().view(np.int32),
                                         pc["rain_conf"].view(np.int32)),
                      "spectral step against the engine: not the same bits")
                spectral_counts = pc["rain_frame_count"]
                check(int(agg["total_rain_frames"]) == int(spectral_counts.sum()),
                      "total_rain_frames")
                acc = float((pc["clip_is_rain"] == truth).mean())
                note = (f"frames, counts and decisions identical to the CPU; rain frames "
                        f"{int(agg['total_rain_frames'])}, accuracy against the labels {acc:.4f}")
            elif model == "roe":
                for key in ("rain_drop_count_mod", "rain_drop_count", "rain_peaks_count",
                            "clip_is_rain"):
                    check(np.array_equal(pc[key][pick], pcc[key]), f"RoE {key}: card != CPU")
                roe_ulps = ulps(pc["frain_mean"][pick], pcc["frain_mean"])
                check(roe_ulps <= 1, f"RoE frain_mean card against CPU: {roe_ulps} ulps")
                direct = roe.roe_detect_batch(corpus, device=dev, **params)
                check(np.array_equal(direct["rain_drop_count_mod"], pc["rain_drop_count_mod"])
                      and np.array_equal(direct["frain_mean"].view(np.int32),
                                         pc["frain_mean"].view(np.int32)),
                      "RoE step against roe_detect_batch: not the same bits")
                note = (f"counts identical to the CPU, frain_mean within {roe_ulps} ulp; "
                        f"drops {int(agg['total_drops'])}, rain clips {int(agg['total_rain_clips'])}")
            else:
                card_f = band_noise_process(corpus[pick], pipe.cfg, device=dev)["fft_rain_frame"]
                cpu_f = band_noise_process(corpus[pick], pipe.cfg, device="cpu")["fft_rain_frame"]
                bn_agree = float((card_f.cpu() == cpu_f).float().mean())
                check(bn_agree >= 0.999, f"band noise FFT rain frames agree on {bn_agree:.6f}")
                direct = band_noise_process(x_all, pipe.cfg, device=dev)
                rain = direct["fft_rain_frame"]
                frac = rain.sum(-1).to(torch.float32) * f32_recip(rain.shape[-1], dev)
                for key, ref in (("fft_rain_fraction", frac), ("median_N_E", _median(direct["N_E"])),
                                 ("median_G", _median(direct["G_mag"]))):
                    check(np.array_equal(ref.cpu().numpy().view(np.int32),
                                         pc[key].view(np.int32)),
                          f"band-noise step {key} against band_noise_process: not the same bits")
                note = (f"FFT rain frames agree with the CPU on {bn_agree:.6f}; rain clips "
                        f"{int(agg['total_rain_clips'])}, mean noise energy "
                        f"{float(agg['mean_noise_energy']):.6g}")
            del direct
            times = cuda_times(lambda: pipe.step(corpus), 10)
            n_kern, busy, top = device_kernels(lambda: pipe.step(corpus))
            n_copy, copy_ms = device_copies(lambda: pipe.step(corpus))
            lines.append(f"{model}: {float(np.median(times)):.3f} ms per step (min {min(times):.3f}, "
                         f"max {max(times):.3f}, n=10), launches "
                         f"{ {k: v for k, v in l_step.items() if v} }, {n_kern} CUDA kernels "
                         f"({busy:.3f} ms device busy, of which {n_copy} memory copies "
                         f"{copy_ms:.3f} ms; costliest {top}); {note}")
        print(f"phase 33 ShardedRainPipeline on a one-card mesh, {BATCH} x {CLIP_SEC:.0f} s from "
              f"float32 on the host, on {smi}, every per-clip output the batched engine's bits; "
              f"the corpus's {corpus.nbytes / 1e6:.1f} MB pageable copy to the card alone "
              f"{float(np.median(copy_host)):.3f} ms on the host clock (min {min(copy_host):.3f}, "
              f"max {max(copy_host):.3f}, n=5); " + "; ".join(lines))

        # ---- 34. the orchestrator's pandas-free core ---------------------------------
        kw = dict(params_global={**BF_PARAMS, "check_duration": CLIP_SEC}, InputType="LocalPath",
                  test_vector_path=corpus_dir, batch_save_dir=None, batch_size=BATCH)
        proc = RainDetectorProcessor(device=dev)
        run_batches(processors=[proc], max_files=2, **kw)  # warm
        run, l_orch, wall = launches_of(lambda: run_batches(processors=[proc], **kw))
        check(l_orch == {**zeros, **models["spectral"][1]}, f"orchestrator launches {l_orch}")

        def counts_of(r):
            return {row["file_key"]: row["rain_detector__rain_frame_count"]
                    for row in r["results_rows"]}

        got = counts_of(run)
        t0 = time.perf_counter()
        per_file = counts_of(run_batches(processors=[RainDetectorProcessor(device=dev)],
                                         debug_params={"device_batch": False}, **kw))
        per_file_s = time.perf_counter() - t0
        cpu16 = counts_of(run_batches(processors=[RainDetectorProcessor(device="cpu")],
                                      max_files=N_AGREE, **kw))
        check(list(got) == keys and got == per_file
              and all(got[k] == v for k, v in cpu16.items()) and len(cpu16) == N_AGREE,
              "orchestrator rain_frame_count: device batch, per-file path and CPU differ")
        check(np.array_equal(np.array(list(got.values())), spectral_counts),
              "orchestrator counts differ from phase 33's step")
        print(f"phase 34 run_batches (pandas-free orchestrator) with RainDetectorProcessor over "
              f"{BATCH} MARK files on {smi}: one device batch, launches "
              f"{ {k: v for k, v in l_orch.items() if v} }, {wall * 1e3:.1f} ms = "
              f"{BATCH / wall:.1f} files/s (host clock, file reads included); per-file path on the "
              f"card {per_file_s * 1e3:.0f} ms = {BATCH / per_file_s:.1f} files/s; rain_frame_count "
              f"identical per file across the batch, the per-file path, the CPU ({N_AGREE} files) "
              f"and phase 33")

        # ---- 35. the backfill CLI as subprocesses ------------------------------------
        def cli(*extra):
            p = subprocess.Popen(
                [sys.executable, "-m", "audio_processing_tools_tpu_torch.cli.backfill",
                 "--input-type", "LocalPath", "--path", corpus_dir, "--clip-sec", str(CLIP_SEC),
                 "--batch", "64", "--dsd", *extra],
                cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            procs.append(p)
            return p

        def summary(p):
            out, err = p.communicate(timeout=300)
            check(p.returncode == 0, f"backfill CLI exited {p.returncode}: {err[-3000:]}")
            return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])

        t0 = time.perf_counter()
        one = summary(cli())
        one_s = time.perf_counter() - t0
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        ranks = [cli("--distributed", "--coordinator", f"127.0.0.1:{port}",
                     "--num-processes", "2", "--process-id", str(i)) for i in range(2)]
        two = [summary(p) for p in ranks]
        two_s = time.perf_counter() - t0
        totals = ("total_rain_frames", "total_rain_clips", "total_clips")
        check(all(two[0][k] == two[1][k] == one[k] for k in totals)
              and [s["host"] for s in two] == [0, 1],
              f"2-rank aggregates {two} against one process {one}")
        check(one["total_rain_frames"] == int(spectral_counts.sum()) and one["total_clips"] == BATCH,
              f"backfill total_rain_frames {one['total_rain_frames']} against phase 33's "
              f"{int(spectral_counts.sum())}")
        print(f"phase 35 backfill CLI on {smi}, {BATCH} files, --batch 64 --dsd, no --out: one "
              f"process {one_s:.1f} s wall ({one['wall_time_sec']} s in its loop, "
              f"{one['audio_hours_per_hour']} audio-h/h); 2 ranks on {dev} over gloo "
              f"{two_s:.1f} s wall ({', '.join(str(s['wall_time_sec']) for s in two)} s in their "
              f"loops, {', '.join(str(s['audio_hours_per_hour']) for s in two)} audio-h/h); "
              f"aggregates equal on both ranks and to the one process "
              f"({ {k: one[k] for k in totals} }), total_rain_frames equal to phase 33's")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tmp.cleanup()
    return {"launches": {"time-sharded K1 (phase 32)": l_seq, "time-sharded flux (phase 32)": l_flux,
                         "2 x 2 mesh (phase 32)": l_2d, **step_launches,
                         "orchestrator batch (phase 34)": l_orch},
            "corpus": corpus, "truth": truth}


# phase 36: 8 x 4 x 4 x 2 x 2 x 4 x 2 = 4,096 threshold combos
TUNE_GRID = {
    "new_rain_primary_flux_min": [1.2, 1.5, 1.8, 2.1, 2.4, 2.7, 3.0, 4.0],
    "new_rain_mode1_flux_min": [2.0, 2.3, 2.6, 2.9],
    "new_rain_mode2_flux_min": [2.0, 2.3, 2.6, 2.9],
    "new_rain_mode3_flux_min": [2.5, 3.0],
    "new_rain_min_support_count": [1, 2],
    "td_gate_threshold": [2.0, 2.5, 3.0, 3.75],
    "clip_rain_min_frames": [1, 3],
}
# phase 37's card-against-CPU subgrid: 4 x 2 x 2 x 2 x 2 = 64 combos
TUNE_SUBGRID = {
    "new_rain_primary_flux_min": [1.5, 1.8, 2.4, 3.0],
    "new_rain_mode1_flux_min": [2.3, 2.6],
    "new_rain_min_support_count": [1, 2],
    "td_gate_threshold": [2.5, 3.75],
    "clip_rain_min_frames": [1, 3],
}
TUNE_BASE = {"sample_rate": FS}
FIT_BASE = {"sample_rate": FS, "clip_rain_min_frames": 3}
FIT_KW = {"init": {"new_rain_primary_flux_min": 4.0}, "steps": 300, "lr": 0.05}  # tests/test_tuning.py:145
# phase 39: 4 x 2 x 4 x 2 = 64 RoE combos
ROE_GRID = {
    "harmonic_threshold": [[4.5, 4.0, 3.5, 3.5, 3.5, 3.5], [3.5, 3.0, 2.5, 2.5, 2.5, 2.5],
                           [6.0, 5.0, 4.5, 4.5, 4.5, 4.5], [5.0, 4.5, 4.0, 4.0, 4.0, 4.0]],
    "crest_thr": [3.75, 3.0],
    "min_drop_count": [0.3, 0.5, 1.0, 2.0],
    "kurtosis_thr": [2.5, 3.5],
}
ROE_BASE = {"sample_rate": FS, "check_duration": CLIP_SEC}
ROE_FIT_KW = {"init": {"harmonic_threshold": [9.0, 8.0, 7.0, 7.0, 7.0, 7.0], "min_drop_count": 2.0,
                       "kurtosis_thr": 8.0, "crest_thr": 8.0, "diff_energy_thr": 20.0},
              "steps": 250, "lr": 0.08}  # tests/test_tuning.py:197-203
NATIVE_PARAMS = {"sample_rate": FS, "check_duration": 10, "op_freq_range": [400, 3500],
                 "n_freq_range": [400, 700], "harmonic_threshold": [4.5, 4.0, 3.5, 3.5, 3.5, 3.5],
                 "min_drop_count": 0.3}  # tests/test_native.py:61-65


def native_clips(seed: int = 40):
    """Four clips of harmonic 500 Hz pings (100, 80, 60 and 40 drops) and
    four of noise, 10 s each (``tests/test_native.py:24-32``); labels."""
    rng = np.random.default_rng(seed)
    n = FS * 10
    k = np.arange(1000)
    ping = 0.6 * np.exp(-k / 80.0) * sum((1.0 / h) * np.sin(2 * np.pi * 500.0 * h * k / FS)
                                         for h in range(1, 6))
    clips = []
    for drops in (100, 80, 60, 40):
        x = 0.003 * rng.standard_normal(n)
        for t0 in rng.integers(0, n - 1200, drops):
            x[t0 : t0 + 1000] += ping
        clips.append(x)
    clips += [s * rng.standard_normal(n) for s in (0.02, 0.01, 0.005, 0.002)]
    return np.stack(clips).astype(np.float32), np.arange(8) < 4


def tuning_phases(smi: str, corpus: np.ndarray, truth: np.ndarray) -> dict:
    """Phases 36-40: the threshold-tuning path on phase 31's corpus.  K10
    against its plain version, the spectral sweep, the gradient fits and the
    tuned profile, the RoE sweep and fit, the native bridge and the
    two-pass wrapper.  Returns the launches of the driven paths and K10's
    numbers for the kernels line."""
    import torch

    from audio_processing_tools_tpu_torch import _kernels
    from audio_processing_tools_tpu_torch.config import DEFAULT_MODE_BANDS
    from audio_processing_tools_tpu_torch.models import roe
    from audio_processing_tools_tpu_torch.models.spectral_noise import RainDetectorProcessor
    from audio_processing_tools_tpu_torch.ops import sweep
    from audio_processing_tools_tpu_torch.parallel import Mesh
    from audio_processing_tools_tpu_torch.tuning import (
        TUNED_ACCURACY_V1,
        apply_profile,
        call_native,
        classification_algo,
        dsp_integ,
    )
    from audio_processing_tools_tpu_torch.tuning.gradient import (
        ROE_TUNABLE_SCALARS,
        fit_spectral_thresholds,
        gradient_tune_thresholds,
        roe_gradient_tune_thresholds,
    )
    from audio_processing_tools_tpu_torch.tuning.grid_search import (
        combo_counts,
        combo_sweep_params,
        generate_param_combinations,
        grid_search_vmapped,
        roe_grid_search_vmapped,
        spectral_threshold_features,
    )
    from audio_processing_tools_tpu_torch.utils.corpus import make_hard_corpus

    dev = torch.device("cuda", 0)
    zeros = {k: 0 for k in _kernels.LAUNCHES}
    front = {"spectrogram_power": 1, "noise_psd_track": 1, "causal_low_quantile_baseline": 1}
    # the corpus as int16 PCM, on the card and on the host as the same
    # float32 values (IEEE division by a 0-dim tensor on both)
    pcm = np.round(corpus.astype(np.float64) * 32767.0).astype(np.int16)
    x = torch.from_numpy(pcm).to(dev).to(torch.float32) / torch.tensor(32767.0, device=dev)
    pick = np.arange(0, BATCH, BATCH // N_AGREE)
    x_cpu = torch.from_numpy(pcm[pick]).to(torch.float32) / torch.tensor(32767.0)
    x16 = x[torch.as_tensor(pick, device=dev)]
    B, T = x.shape[0], int(x.shape[1]) // 128 + 1

    # ---- 36. K10 against its plain version ----------------------------------------
    feats, base = spectral_threshold_features(x, TUNE_BASE, device=dev)
    check(all(tuple(v.shape) == (B, T) and bool(torch.isfinite(v).all()) for v in feats.values()),
          f"sweep features {[tuple(v.shape) for v in feats.values()]}")
    combos = generate_param_combinations(TUNE_GRID)
    params = combo_sweep_params(combos, base, dev)
    C = len(combos)
    check(C == 4096 and params.primary_flux_min.dtype == torch.float32
          and params.min_support_count.dtype == torch.int32, f"{C} combos")
    ops = sweep.k10_operands(feats, params)
    got = sweep._launch_k10(*ops)
    ref = sweep._decision_counts_plain(feats, params)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"K10 counts differ from the plain version on "
                                 f"{int((got != ref).sum())} of {got.numel()}")
    bad = {k: v.clone() for k, v in feats.items()}
    bad["primary"][1] = float("nan")  # a row of NaN frames
    bad["s1"][2, ::7] = float("nan")
    bad["s2"][3, ::11] = float("inf")
    bad["primary"][4, ::3] = float("inf")
    bad["td_crest"][5, ::5] = float("nan")
    got_bad = sweep._decision_counts_cuda(bad, params)
    ref_bad = sweep._decision_counts_plain(bad, params)
    torch.cuda.synchronize()
    check(torch.equal(got_bad, ref_bad) and int(got_bad[:, 1].abs().sum()) == 0,
          "K10 on NaN and inf frames differs from the plain version")
    del bad, got_bad, ref_bad
    # grids the sweep's does not hold: every threshold distinct (each slice
    # at its most pairs), non-positive and NaN thresholds with support
    # counts 0-4, one combo; and frame counts around a word and at the most
    # the kernel takes
    gen = torch.Generator(device=dev).manual_seed(36)

    def rand(lo, hi, n=C):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)

    distinct = sweep.SweepParams(rand(0.0, 4.0), rand(-0.5, 3.5), rand(-0.5, 3.5), rand(-0.5, 4.0),
                                 torch.randint(0, 5, (C,), generator=gen, device=dev,
                                               dtype=torch.int32), rand(-0.5, 5.0))
    odd = combo_sweep_params(generate_param_combinations({
        "new_rain_primary_flux_min": [0.0, -0.0, 1.8, float("nan")],
        "new_rain_mode1_flux_min": [-1.0, 2.6], "new_rain_mode2_flux_min": [0.0, 2.3],
        "new_rain_mode3_flux_min": [float("nan"), 3.0],
        "new_rain_min_support_count": [-1, 0, 1, 2, 3, 4],
        "td_gate_threshold": [-1.0, 0.0, 2.5, float("nan")]}), base, dev)
    one = combo_sweep_params([combos[1234]], base, dev)
    Tm = sweep.K10_MAX_FRAMES
    n_long = max(1, B * T // Tm)  # the features' frames cut into rows of Tm
    long_f = {k: v.reshape(-1).repeat(-(-n_long * Tm // v.numel()))[: n_long * Tm]
              .reshape(n_long, Tm) for k, v in feats.items()}
    k10_grids = [
        (f"{C:,} combos, every threshold distinct", feats, distinct),
        (f"{odd.min_support_count.shape[0]} combos, non-positive and NaN thresholds, "
         f"support counts -1 to 4", feats, odd),
        ("one combo", feats, one),
        *((f"T = {t}, {which} combos", {k: v[:, :t].contiguous() for k, v in feats.items()}, p_t)
          for t in (1, 31, 33) for which, p_t in (("the sweep's", params), ("the odd", odd))),
        (f"T = {Tm} (the most), {n_long} clips, the odd combos", long_f, odd),
    ]
    for label, f_g, p_g in k10_grids:
        got_g = sweep._decision_counts_cuda(f_g, p_g)
        ref_g = sweep._decision_counts_plain(f_g, p_g)
        torch.cuda.synchronize()
        check(torch.equal(got_g, ref_g), f"K10 on {label}: counts differ from the plain version "
                                         f"on {int((got_g != ref_g).sum())} of {got_g.numel()}")
        print(f"  K10 {label}: {tuple(got_g.shape)} counts identical (max {int(got_g.max())})")
    del long_f
    k10_ms = graph_ms(lambda: sweep._launch_k10(*ops))
    ops_distinct = sweep.k10_operands(feats, distinct)
    k10_distinct_ms = graph_ms(lambda: sweep._launch_k10(*ops_distinct))
    ops_one = sweep.k10_operands(feats, one)
    k10_one_ms = graph_ms(lambda: sweep._launch_k10(*ops_one))
    k10_call, k10_plain = in_turns(lambda: sweep._decision_counts_plain(feats, params),
                                   lambda: sweep._decision_counts_cuda(feats, params), 2, 10)
    k10_one_call = float(np.median(cuda_times(lambda: sweep._decision_counts_cuda(feats, one), 20)))
    evals = C * B * T
    # bytes: the five planes read and the counts written (the thresholds are
    # 24 bytes a combo); operations: the work these inputs need, one compare
    # a distinct threshold (by axis: primary, three support, gate) and frame
    # per clip, and one word operation a combo and 32 frames per clip, each
    # a lane's clock, which is half an FMA's two at 67 TFLOP/s.  (The rule as
    # written is 11 one-lane operations a (combo, clip, frame) triple.)
    n_distinct = sum(int(torch.unique(t.contiguous().view(torch.int32)).numel())
                     for t in (params.primary_flux_min, params.mode1_flux_min,
                               params.mode2_flux_min, params.mode3_flux_min,
                               params.td_gate_threshold))
    words = -(-T // 32)
    k10_ops = B * (n_distinct * T + C * words)
    k10_work = (4 * (5 * B * T + C * B) + 24 * C, 2 * k10_ops)
    k10_bound, k10_by = bound_of(*k10_work)
    rain_max = int(got.max())
    print(f"phase 36 K10 decision_sweep on {smi}: {C:,} combos x {B} clips x {T} frames "
          f"({evals:.3e} evaluations of the rule), counts identical to the plain version (max "
          f"{rain_max} rain frames), and on NaN and inf frames (a NaN row counts 0) and the "
          f"{len(k10_grids)} grids above; {k10_ms:.4f} ms per launch in a graph of 20 "
          f"({k10_call:.4f} ms per host-launched call with its log planes and pair tables, "
          f"n=20; plain {k10_plain:.3f} ms, n=4); every threshold distinct {k10_distinct_ms:.4f} "
          f"ms; one combo {k10_one_ms:.4f} ms ({k10_one_call:.4f} ms a host-launched call, "
          f"n=20); the work these inputs need: {n_distinct} distinct thresholds x {T} frames + "
          f"{C:,} combos x {words} words, per clip, = {k10_ops:.4e} operations; bound "
          f"{k10_bound:.4f} ms by {k10_by} ({k10_bound / k10_ms:.1%} of it)")
    del got, ref, ops, ops_distinct, ops_one

    # ---- 37. the spectral sweep end to end ------------------------------------------
    res, l_sweep, sweep_s = launches_of(
        lambda: grid_search_vmapped(x, truth, TUNE_GRID, TUNE_BASE, device=dev))
    check(l_sweep == {**zeros, **front, "decision_sweep": 1}, f"sweep launches {l_sweep}")
    check(len(res) == C and [r["parameters"] for r in res] == combos, "sweep results")
    best = max(res, key=lambda r: r["overall_accuracy"])
    default = next(r for r in res if r["parameters"] == {
        "new_rain_primary_flux_min": 1.8, "new_rain_mode1_flux_min": 2.6,
        "new_rain_mode2_flux_min": 2.6, "new_rain_mode3_flux_min": 3.0,
        "new_rain_min_support_count": 2, "td_gate_threshold": 2.5, "clip_rain_min_frames": 3})
    feat_ms = float(np.median(cuda_times(
        lambda: spectral_threshold_features(x, TUNE_BASE, device=dev), 10)))
    sweep_ms = float(np.median(cuda_times(lambda: combo_counts(feats, combos, base), 10)))
    card16 = grid_search_vmapped(x16, truth[pick], TUNE_SUBGRID, TUNE_BASE, device=dev)
    cpu16 = grid_search_vmapped(x_cpu, truth[pick], TUNE_SUBGRID, TUNE_BASE, device="cpu")
    check(len(card16) == 64 and card16 == cpu16,
          "the 64-combo sweep on 16 clips: predictions differ between the card and the CPU")
    mesh4 = Mesh([dev] * 4, ("files",))
    sharded, l_mesh, _ = launches_of(
        lambda: grid_search_vmapped(x, truth, TUNE_GRID, TUNE_BASE, mesh=mesh4, device=dev))
    check(sharded == res and l_mesh["decision_sweep"] == 4,
          f"the sweep over a 4-entry mesh differs from the unsharded one ({l_mesh})")
    print(f"phase 37 spectral sweep on {smi}: {B} x {CLIP_SEC:.0f} s of phase 31's corpus from "
          f"int16 on the card, {C:,} combos: launches "
          f"{ {k: v for k, v in l_sweep.items() if v} }; features {feat_ms:.3f} ms (median of "
          f"10, CUDA events), counts {sweep_ms:.3f} ms (params from the combos, K10, counts to "
          f"the host; median of 10), the whole call {sweep_s * 1e3:.1f} ms on the host clock; "
          f"best combo accuracy {best['overall_accuracy']:.4f} ({best['parameters']}), the "
          f"default thresholds {default['overall_accuracy']:.4f}; 64 combos x {N_AGREE} clips "
          f"identical to the CPU; the sweep on 4 entries of {dev} (K10 x4) equal to the unsharded")

    # ---- 38. the gradient fits and the tuned profile -----------------------------------
    hclips, hlabels, hkinds = make_hard_corpus(seed=17, per_class=8)
    hx = torch.from_numpy(hclips).to(dev)
    fit_h, l_fit, fit_h_s = launches_of(
        lambda: gradient_tune_thresholds(hx, hlabels, FIT_BASE, device=dev, **FIT_KW))
    check(l_fit == {**zeros, **front, "decision_sweep": 2}, f"fit launches {l_fit}")
    hfeats, hbase = spectral_threshold_features(hx, FIT_BASE, device=dev)
    cpu_h = fit_spectral_thresholds({k: v.cpu() for k, v in hfeats.items()}, hlabels, hbase,
                                    **FIT_KW)
    gap_h = max(abs(fit_h["thresholds"][k] - cpu_h["thresholds"][k]) for k in cpu_h["thresholds"])
    check(gap_h <= 0.05 and fit_h["accuracy"] == cpu_h["accuracy"]
          and fit_h["init_accuracy"] == cpu_h["init_accuracy"]
          and bool(np.isfinite(fit_h["loss_history"]).all()),
          f"hard corpus: the card's fit is {gap_h:.3e} from the CPU's, accuracy "
          f"{fit_h['accuracy']} against {cpu_h['accuracy']}")
    check(fit_h["init_accuracy"] < 0.7 and fit_h["accuracy"] >= fit_h["init_accuracy"] + 0.15
          and fit_h["thresholds"]["new_rain_primary_flux_min"] < 3.5,
          f"the hard-corpus fit does not recover: {fit_h['init_accuracy']} -> {fit_h['accuracy']}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit_c = fit_spectral_thresholds(feats, truth, FIT_BASE, **FIT_KW)
    torch.cuda.synchronize()
    fit_c_s = time.perf_counter() - t0
    # the 128-clip fit is chaotic in float32 once the anneal sharpens the
    # surrogate: the card's run is held to the CPU's over its first 100
    # steps, and its end is set beside the CPU's and beside a CPU run on
    # features scaled by 1 + 2^-23 (one float32 ulp), which moves it as far
    feats_cpu = {k: v.cpu() for k, v in feats.items()}
    cpu_c = fit_spectral_thresholds(feats_cpu, truth, FIT_BASE, **FIT_KW)
    ulp_c = fit_spectral_thresholds({k: v * (1 + 2.0**-23) for k, v in feats_cpu.items()}, truth,
                                    FIT_BASE, **FIT_KW)
    rel = np.abs(fit_c["loss_history"] - cpu_c["loss_history"]) / np.abs(cpu_c["loss_history"])
    gap_c = max(abs(fit_c["thresholds"][k] - cpu_c["thresholds"][k]) for k in cpu_c["thresholds"])
    gap_u = max(abs(ulp_c["thresholds"][k] - cpu_c["thresholds"][k]) for k in cpu_c["thresholds"])
    apart = int(np.argmax(rel > 1e-4)) if bool((rel > 1e-4).any()) else len(rel)
    check(float(rel[:100].max()) <= 1e-4 and bool(np.isfinite(fit_c["loss_history"]).all()),
          f"corpus fit: the card's first 100 losses are {float(rel[:100].max()):.3e} from the "
          f"CPU's")
    n20 = device_kernels(lambda: fit_spectral_thresholds(feats, truth, FIT_BASE, **{
        **FIT_KW, "steps": 20}))[0]
    n40 = device_kernels(lambda: fit_spectral_thresholds(feats, truth, FIT_BASE, **{
        **FIT_KW, "steps": 40}))[0]
    per_step = (n40 - n20) / 20
    steps = FIT_KW["steps"]
    lines = [f"hard corpus 32 x 2 s: accuracy {fit_h['init_accuracy']:.4f} -> "
             f"{fit_h['accuracy']:.4f} (the CPU's {cpu_h['accuracy']:.4f}), "
             f"{fit_h_s * 1e3 / steps:.3f} ms a step (host clock, front end and hard scoring "
             f"included), thresholds within {gap_h:.3e} of the CPU's",
             f"corpus {B} x {CLIP_SEC:.0f} s: accuracy {fit_c['init_accuracy']:.4f} -> "
             f"{fit_c['accuracy']:.4f} (the CPU's {cpu_c['accuracy']:.4f}, one ulp off "
             f"{ulp_c['accuracy']:.4f}), {fit_c_s * 1e3 / steps:.3f} ms a step, losses within "
             f"{float(rel[:100].max()):.3e} of the CPU's over steps 0-99 and apart by more than "
             f"1e-4 from step {apart}, final thresholds {gap_c:.3e} from the CPU's (the CPU one "
             f"ulp off: {gap_u:.3e})"]
    proc = RainDetectorProcessor(device=dev)
    default_p = {"sample_rate": FS, "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
                 "classifier_only_mode": True, "clip_rain_min_frames": 3}

    def per_class(params):
        pred = np.array([m["clip_is_rain"] for m, _ in proc.run_batch(hclips, params)])
        return {kind: int(sum(pred[i] == hlabels[i] for i, k in enumerate(hkinds) if k == kind))
                for kind in sorted(set(hkinds))}

    pc_default = per_class(default_p)
    pc_tuned = per_class(apply_profile(default_p, TUNED_ACCURACY_V1))
    check(pc_default == {"rain_faint": 7, "drizzle": 6, "rain_in_wind": 6, "wind_gusty": 5}
          and pc_tuned == {"rain_faint": 7, "drizzle": 8, "rain_in_wind": 6, "wind_gusty": 7},
          f"profiles on the hard corpus: default {pc_default}, tuned {pc_tuned}")
    print(f"phase 38 gradient fits on {smi}, {FIT_KW['steps']} Adam steps from "
          f"new_rain_primary_flux_min 4.0: " + "; ".join(lines) + f"; {per_step:.1f} CUDA "
          f"kernels a step (torch.profiler, 40 steps less 20); launches of the hard-corpus call "
          f"{ {k: v for k, v in l_fit.items() if v} }; tuned-accuracy-v1 through "
          f"RainDetectorProcessor {sum(pc_tuned.values())}/32, the default "
          f"{sum(pc_default.values())}/32")

    # ---- 39. the RoE sweep and fit ----------------------------------------------------------
    roe_res, l_roe, roe_s = launches_of(
        lambda: roe_grid_search_vmapped(x, truth, ROE_GRID, ROE_BASE, device=dev))
    check(l_roe == {**zeros, "spectrogram_power": 1, "cascade_sosfilt": 2},
          f"RoE sweep launches {l_roe}")
    check(len(roe_res) == 64, f"{len(roe_res)} RoE results")
    x_np = x.cpu().numpy()
    for r in roe_res[:4]:
        for i in pick[:8]:
            mod, _, _ = roe.rain_detection_algo(x_np[i], device=dev, return_spectra=False,
                                                **{**ROE_BASE, **r["parameters"]})
            check(mod == r["rain_drop_count_mod"][i],
                  f"RoE sweep against the engine, {r['parameters']}, clip {i}: "
                  f"{r['rain_drop_count_mod'][i]} != {mod}")
    roe_card16 = roe_grid_search_vmapped(x16, truth[pick], ROE_GRID, ROE_BASE, device=dev)
    roe_cpu16 = roe_grid_search_vmapped(x_cpu, truth[pick], ROE_GRID, ROE_BASE, device="cpu")
    check(roe_card16 == roe_cpu16, "the RoE sweep on 16 clips: counts differ between the card and "
                                   "the CPU")
    roe_best = max(roe_res, key=lambda r: r["overall_accuracy"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    roe_fit = roe_gradient_tune_thresholds(x, truth, ROE_BASE, device=dev, **ROE_FIT_KW)
    torch.cuda.synchronize()
    roe_fit_s = time.perf_counter() - t0
    check(bool(np.isfinite(roe_fit["loss_history"]).all())
          and len(roe_fit["thresholds"]["harmonic_threshold"]) == 6
          and all(np.isfinite(roe_fit["thresholds"][k]) for k in ROE_TUNABLE_SCALARS),
          "RoE fit: non-finite loss or thresholds")
    print(f"phase 39 RoE sweep on {smi}: {B} x {CLIP_SEC:.0f} s, 64 combos, launches "
          f"{ {k: v for k, v in l_roe.items() if v} }, {roe_s * 1e3:.1f} ms on the host clock "
          f"(front end once, then roe_apply_thresholds combo by combo); 4 combos x 8 clips equal to "
          f"rain_detection_algo, 64 combos x {N_AGREE} clips identical to the CPU; best accuracy "
          f"{roe_best['overall_accuracy']:.4f}; the RoE fit ({ROE_FIT_KW['steps']} steps from "
          f"tests/test_tuning.py's detuned start): accuracy {roe_fit['init_accuracy']:.4f} -> "
          f"{roe_fit['accuracy']:.4f}, {roe_fit_s * 1e3:.0f} ms (host clock, front end included)")

    # ---- 40. the native bridge and the two-pass wrapper ----------------------------------
    t0 = time.perf_counter()
    lib = call_native.load_native_library()
    build_s = time.perf_counter() - t0
    version = call_native.get_version(lib)
    check("tpu-native-roe" in version, f"native version {version!r}")
    nclips, nlabels = native_clips()
    agree, counts = [], []
    t_py = t_c = 0.0
    for clip, label in zip(nclips, nlabels):
        t0 = time.perf_counter()
        py = classification_algo.python_classifier_wrapper(clip, device=dev, **NATIVE_PARAMS)
        t1 = time.perf_counter()
        cc = classification_algo.c_classifier_wrapper(clip, lib=lib, **NATIVE_PARAMS)
        t2 = time.perf_counter()
        t_py, t_c = t_py + t1 - t0, t_c + t2 - t1
        agree.append(py == cc == bool(label))
        card_di = dsp_integ.rain_detection_algo(clip, device=dev)
        cpu_di = dsp_integ.rain_detection_algo(clip, device="cpu")
        counts.append((card_di[0], cpu_di[0]))
    check(all(agree), f"port RoE on the card and the native library disagree: {agree}")
    check(all(a == b for a, b in counts), f"dsp_integ counts card against CPU: {counts}")
    print(f"phase 40 native bridge: g++ build and load {build_s:.2f} s, version {version!r}; "
          f"8 clips x 10 s, python_classifier_wrapper on {dev} and c_classifier_wrapper agree "
          f"with each other and the labels ({t_py / 8 * 1e3:.1f} ms a clip on the card, "
          f"{t_c / 8 * 1e3:.1f} ms natively, host clock); dsp_integ counts card = CPU "
          f"{[a for a, _ in counts]}")
    return {"launches": {"spectral sweep (phase 37)": l_sweep,
                         "gradient fit, hard corpus (phase 38)": l_fit,
                         "RoE sweep (phase 39)": l_roe},
            "k10": {"ms": k10_ms, "plain_ms": k10_plain, "work": k10_work,
                    "distinct_ms": k10_distinct_ms, "one_combo_ms": k10_one_ms}}



if __name__ == "__main__":
    sys.exit(main())
