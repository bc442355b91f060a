#!/usr/bin/env python3
"""Per-stage time of the PyTorch port's spectral, RoE and band-noise engines.

    python3 tools/profile_torch_stages.py [--model spectral|roe|band_noise]
        [--batch 128] [--iters 64] [--clip-sec 10] [--trials 5]
        [--device cuda|cpu] [--root DIR]

Counterpart of ``tools/profile_stages.py``, with its geometries, stage
names and stage bodies (each body recomputes its prefix, so a row reads as
the pipeline's cost up to that point):

  * spectral: ``--batch`` clips of ``--clip-sec`` s of int16 PCM through the
    classifier-only engine: ``full`` (``SpectralNoiseEngine._run``),
    ``spect``, ``prefilt``, ``spect+psd``, ``td_features``,
    ``baselines_x6``, ``spect+classify``;
  * roe: 32 x 3 s clips when ``--batch`` is left at 128 (the JAX bench's
    geometry): ``full`` (``models/roe.py::_roe_batch``), ``bp_filter``,
    ``bp+spect``, ``pulse_td``, ``bp+spect+nov6``, ``bp+spect+peaks6``,
    ``localavg6_only``;
  * band_noise: 32 x ``--clip-sec`` s clips when ``--batch`` is left at 128:
    ``full``, ``filters``, ``filters_lean``, ``filters+inputs``,
    ``scan_only``.

Each stage maps the batch to one scalar.  A step runs the stage on the
batch perturbed by the previous step's scalar, so K = ``--iters`` chained
steps depend on each other, as the JAX file's ``lax.scan`` makes them.
Per stage, on the card:

  * ``graph_ms``: the median over ``--trials`` replays of a CUDA graph of
    the K chained steps, between CUDA events, over K (the counterpart of
    the JAX file's ``ms_per_step``), with its ``spread`` ((max - min) /
    median).  A stage whose step synchronises with the host cannot be
    captured: it reports ``graph_ms: null`` and ``graph_reason``, the
    error ``torch.cuda.set_sync_debug_mode("error")`` raised on one step
    and the line of the port where it did;
  * ``eager_ms`` and ``eager_spread``: the same K steps run eagerly between
    CUDA events, as users call the port;
  * ``busy_ms``: the device's kernel and copy time in one eager step, from
    ``torch.profiler``;
  * ``first_call_s``: the host seconds of the stage's first call (kernel
    build and first launch included), in place of ``compile_s``.

``floor`` is the same record for an empty body (the perturbation alone),
the JAX docstring's ``floor_ms_per_step``.  ``--device cpu`` runs the
stages on the CPU, timed on the host clock, with no graph and no busy time;
its times are the CPU's, not the card's.  Prints one line per stage and
one JSON line last, with the JAX file's keys (``backend`` becomes
``device``: the card's name and power limit from ``nvidia-smi``).
``--root`` imports the port from another checkout.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, NamedTuple

import numpy as np

FS = 11162
MODELS = ("spectral", "roe", "band_noise")
PKG = "audio_processing_tools_tpu_torch"


class Profile(NamedTuple):
    """A model's input batch on its device, its stage bodies (batch ->
    0-dim tensor) and its shape facts for the JSON line."""

    x: object
    stages: Dict[str, Callable]
    meta: Dict[str, object]


def _geometry(model: str, batch: int, clip_sec: float):
    """(clips, samples a clip): RoE and band noise take 32 clips where the
    batch is left at 128, RoE 3 s clips (``profile_stages.py:278-279,
    400-401``)."""
    if model == "spectral":
        return batch, int(FS * clip_sec)
    B = batch if batch != 128 else 32
    return B, (FS * 3 if model == "roe" else int(FS * clip_sec))


def build_profile(model: str, batch: int = 128, clip_sec: float = 10.0,
                  device: str = "cuda") -> Profile:
    """The stages of ``model`` over its seeded batch on ``device``."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}")
    return {"spectral": _spectral, "roe": _roe, "band_noise": _band_noise}[model](
        *_geometry(model, batch, clip_sec), __import__("torch").device(device))


def _spectral(B: int, N: int, dev) -> Profile:
    """``profile_stages.py:59-188``."""
    import torch

    from audio_processing_tools_tpu_torch.config import DEFAULT_MODE_BANDS, build_noise_config
    from audio_processing_tools_tpu_torch.models.frame_classifier import (
        BandGeometry,
        build_prefilter_sos,
        detect_from_band,
        td_prefilter_sos,
    )
    from audio_processing_tools_tpu_torch.models.spectral_noise import SpectralNoiseEngine
    from audio_processing_tools_tpu_torch.ops.features_td import extract_td_features
    from audio_processing_tools_tpu_torch.ops.filters import sosfiltfilt
    from audio_processing_tools_tpu_torch.ops.spectrogram import spectrogram_power
    from audio_processing_tools_tpu_torch.ops.stft import fft_frequencies
    from audio_processing_tools_tpu_torch.ops.trackers import (
        causal_low_quantile_baseline,
        make_psd_params,
        noise_psd_track,
    )

    cfg = build_noise_config(FS, {
        "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
        "classifier_only_mode": True,
    })
    eng = SpectralNoiseEngine(cfg, device=dev)
    rng = np.random.default_rng(0)
    pcm = torch.from_numpy((rng.standard_normal((B, N)) * 2000).astype(np.int16)).to(dev)

    n_fft, hop = cfg.n_fft, cfg.hop
    T = 1 + N // hop  # center=True frame count
    freqs = fft_frequencies(FS, n_fft)
    band_rows = np.flatnonzero((freqs >= cfg.operating_band[0])
                               & (freqs <= cfg.operating_band[1]))
    rows = torch.from_numpy(band_rows).to(dev)
    psd_params = make_psd_params(
        cfg_q=cfg.q, win_sec=cfg.win_sec, frames_per_sec=FS / hop,
        ema_up=cfg.ema_up, ema_down=cfg.ema_down, eps=cfg.eps,
        noise_psd_max_ratio=cfg.noise_psd_max_ratio,
        adaptive_q_enable=cfg.adaptive_q_enable,
        adaptive_q_min=cfg.adaptive_q_min,
        adaptive_q_alpha=cfg.adaptive_q_alpha,
    )
    sos = build_prefilter_sos(cfg, FS, "highpass")
    td_sos = td_prefilter_sos(cfg)
    geo = BandGeometry(cfg)
    # the band's rows as the engine takes them, a slice (an index array made
    # on the host would be a copy to the card, a synchronisation, each step)
    band = slice(int(geo.band_rows[0]), int(geo.band_rows[-1]) + 1)
    if not np.array_equal(np.arange(band.start, band.stop), geo.band_rows):
        raise ValueError("the operating band's rows are not contiguous")
    mode_bands = tuple((float(a), float(b))
                       for (a, b) in cfg.dget("mode_bands", DEFAULT_MODE_BANDS))
    # a 0-dim divisor: a CUDA tensor divided by a Python float is multiplied
    # by its reciprocal, so the card and the CPU get the same input bits
    scale = torch.tensor(32767.0, device=dev)
    no_rain = torch.zeros((B, T), dtype=torch.bool, device=dev)

    def to_f32(p):
        return p.to(torch.float32) / scale

    def spectrogram(xb):
        return spectrogram_power(xb, n_fft=n_fft, hop=hop, center=True)

    def full(p):
        out = eng._run(to_f32(p), FS)
        return out["rain_conf"].sum() + out["frame_class"].to(torch.float32).sum()

    def spect(p):
        return spectrogram(to_f32(p)).sum()

    def prefilt(p):
        return sosfiltfilt(sos, to_f32(p)).sum()

    def psd(p):
        # spectrogram + band gather + noise PSD scan (detector norm path)
        P = spectrogram(to_f32(p))
        return noise_psd_track(P[:, rows, :], no_rain, psd_params).sum()

    def td(p):
        feats = extract_td_features(to_f32(p), fs=FS, frame_len=n_fft, hop=hop,
                                    operating_band=cfg.operating_band, mode_bands=mode_bands,
                                    td_input_mode="default")
        return sum(v.to(torch.float32).sum() for v in feats.values())

    def baselines(p):
        # the two causal low-quantile baseline scans on mode flux shapes
        xb = to_f32(p)
        b1, _ = causal_low_quantile_baseline(xb[:, :T], q_percent=20.0, samples_per_sec=FS / hop,
                                             win_sec=0.5, floor=1.0)
        b5, _ = causal_low_quantile_baseline(xb[:, :5 * T].reshape(B, 5, T), q_percent=20.0,
                                             samples_per_sec=FS / hop, win_sec=0.5, floor=1.0)
        return b1.sum() + b5.sum()

    def classify(p):
        # the classifier on a synthetic P_det: detect_rain_over_time's body
        # with the outputs the stage reads only (XLA drops the JAX stage's
        # unread debug outputs as dead code)
        xb = to_f32(p)
        Pdb = 10.0 * torch.log10(spectrogram(xb) + cfg.eps)
        x_td = sosfiltfilt(td_sos, xb) if td_sos is not None else xb
        fc, rc, _, _ = detect_from_band(cfg, geo, Pdb[:, band, :], x_td, None, debug=False)
        return rc.sum() + fc.to(torch.float32).sum()

    stages = {"full": full, "spect": spect, "prefilt": prefilt, "spect+psd": psd,
              "td_features": td, "baselines_x6": baselines, "spect+classify": classify}
    return Profile(pcm, stages, {"T_frames": T, "band_bins": len(band_rows)})


def _roe(B: int, Nr: int, dev) -> Profile:
    """``profile_stages.py:256-374``."""
    import torch

    from audio_processing_tools_tpu_torch.models.roe import (
        _find_first_peak_in_range,
        _local_average_sorted3,
        _novelty_spectrum,
        _pulse_characteristics,
        _roe_batch,
        _spectral_peaks,
        build_roe_config,
    )
    from audio_processing_tools_tpu_torch.ops.filters import butter_sos, sosfilt
    from audio_processing_tools_tpu_torch.ops.spectrogram import spectrogram_power

    # no spectra out: the JAX stage reads only the counts, and XLA drops the rest
    cfg = build_roe_config(sample_rate=FS, check_duration=3, return_spectra=False)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((B, Nr)) * 0.05).astype(np.float32)).to(dev)

    N, H = cfg.frame_length, cfg.hop_length
    Fs = float(FS)
    op_lo, op_hi = cfg.op_freq_range
    nyq = 0.5 * Fs
    sos = butter_sos(8, [op_lo / nyq, op_hi / nyq], "bandpass")
    M = cfg.min_average_len
    n_harm_total = cfg.num_harmonics  # harmonic 0 + dynamic 1..n-1
    F = 1 + N // 2
    bins = torch.arange(F, device=dev)
    masks, bounds = [], []
    for hn in range(n_harm_total):
        lo = 500.0 * (hn + 1)
        masks.append((bins >= int(lo / (Fs / N))) & (bins <= int((lo + 300.0) / (Fs / N))))
        # float32 bounds made once: a 0-dim tensor made in the body is a host copy
        bounds.append([torch.tensor(np.float32(v), device=dev)
                       for v in (lo - 100.0, lo + 400.0, lo, lo + 300.0)])

    def mag_of(p):
        return torch.sqrt(spectrogram_power(sosfilt(sos, p), n_fft=N, hop=H, center=True))

    def bp(p):
        return sosfilt(sos, p).sum()

    def bp_spect(p):
        return mag_of(p).sum()

    def pulse(p):
        r = _pulse_characteristics(p, 1 + p.shape[-1] // H, cfg)
        return sum(v.sum() for v in r.values())

    def nov6(p):
        # 6 per-harmonic novelty chains (band mask -> freq-diff -> SNR via
        # the +-M top_k local average -> local-maxima mask -> threshold)
        mag = mag_of(p)
        Y = mag if cfg.log_factor == 0 else torch.log(1 + cfg.log_factor * mag)
        s = 0.0
        for hn in range(n_harm_total):
            thr = float(cfg.harmonic_threshold[min(hn, len(cfg.harmonic_threshold) - 1)])
            novt, novk = _novelty_spectrum(torch.where(masks[hn][:, None], Y, 0.0), M, thr)
            s = s + novk.sum() + novt.sum()
        return s

    def peaks6(p):
        # the spectral peaks are the same for every harmonic's search: made
        # once, as XLA merges the JAX stage's six identical computations
        mag = mag_of(p)
        peaks = _spectral_peaks(mag)
        s = 0.0
        for hn in range(n_harm_total):
            cnt, fpeak = _find_first_peak_in_range(mag, *bounds[hn], Fs, cfg.max_peaks, peaks)
            s = s + cnt.to(torch.float32).sum() + fpeak.sum()
        return s

    def localavg6(p):
        # just the 6 +-M top_k local averages on T-length novelty vectors
        T = 1 + (p.shape[-1] // N) * (N // H)
        nov = p[:, : T + 1]
        s = 0.0
        for _ in range(n_harm_total):
            s = s + _local_average_sorted3(nov, M).sum()
        return s

    def full(p):
        out = _roe_batch(p, cfg)
        return (out["rain_drop_count"].to(torch.float32) + out["frain_mean"]).sum()

    stages = {"full": full, "bp_filter": bp, "bp+spect": bp_spect, "pulse_td": pulse,
              "bp+spect+nov6": nov6, "bp+spect+peaks6": peaks6, "localavg6_only": localavg6}
    return Profile(x, stages, {})


def _band_noise(B: int, N: int, dev) -> Profile:
    """``profile_stages.py:377-476``."""
    import torch

    from audio_processing_tools_tpu_torch.models.band_noise import (
        BandNoiseEstimatorConfig,
        _design_filters,
        _per_frame_inputs,
        _run_band_scan,
        _scan_carry_init,
        band_noise_process,
        n_subframes,
    )
    from audio_processing_tools_tpu_torch.ops.filters import (
        _sosfilt_cascade_matmul,
        cascade_sosfilt,
        sosfilt_zi,
    )

    cfg = BandNoiseEstimatorConfig()
    fl = cfg.frame_len
    T = N // fl
    S = n_subframes(cfg)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((B, N)) * 0.05).astype(np.float32)).to(dev)

    hpf, bpf = _design_filters(cfg)
    zi_h_base = torch.from_numpy(sosfilt_zi(hpf).astype(np.float32)).to(dev)
    zi_b_base = torch.from_numpy(sosfilt_zi(bpf).astype(np.float32)).to(dev)

    def seeds(p):
        x0 = p[:, 0, None, None]
        return zi_h_base * x0, zi_b_base * x0

    def filt(p):
        # the whole-clip entry's cascade (K4), y and the final state
        zh, zb = seeds(p)
        x_h, _ = cascade_sosfilt(hpf, p, zh)
        x_bp, _ = cascade_sosfilt(bpf, x_h, zb)
        return x_h, x_bp

    def filters(p):
        x_h, x_bp = filt(p)
        return x_h.sum() + x_bp.sum()

    def filters_lean(p):
        # the y-only cascade (log-depth matrix prefix, no final state)
        zh, zb = seeds(p)
        x_h = _sosfilt_cascade_matmul(hpf, p, zh)
        x_bp = _sosfilt_cascade_matmul(bpf, x_h, zb)
        return x_h.sum() + x_bp.sum()

    def inputs(p):
        x_h, x_bp = filt(p)
        ins = _per_frame_inputs(x_h[:, : T * fl], x_bp[:, : T * fl], cfg, T)
        return sum(v.sum() for v in ins)

    def scan_only(p):
        # fabricated per-frame inputs: cheap reshapes of the waveform so
        # this row's cost is the scan body itself
        f = torch.abs(p[:, : T * fl].reshape(B, T, fl))
        subE_t = f[..., :S] + 1e-6
        scal = f[..., 0]
        ins = (subE_t, subE_t + 1e-7, scal, scal + 1e-7, scal, torch.sqrt(scal), scal, scal,
               scal)
        outs, _ = _run_band_scan(cfg, _scan_carry_init(cfg, B, p.device), ins)
        return outs["M_clean"].sum() + outs["N_E"].sum()

    def full(p):
        outs = band_noise_process(p, cfg, device=p.device)
        return outs["M_clean"].sum() + outs["N_E"].sum()

    stages = {"full": full, "filters": filters, "filters_lean": filters_lean,
              "filters+inputs": inputs, "scan_only": scan_only}
    return Profile(x, stages, {"T_frames": T})


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def chained(fn: Callable, x, K: int):
    """K steps of ``fn``, each on ``x`` perturbed by the previous step's
    scalar (``profile_stages.py:192-197, 230-234``): int16 PCM gains
    ``seed % 3``, float audio ``(seed % 3) * 1e-6``; the next seed is the
    scalar modulo 7.  Returns the last seed."""
    import torch

    pcm = x.dtype == torch.int16
    seed = torch.zeros((), dtype=x.dtype, device=x.device)
    for _ in range(K):
        s = fn(x + (seed % 3) if pcm else x + (seed % 3.0) * 1e-6)
        seed = s.to(torch.float32) % 7.0
        if pcm:
            seed = seed.to(torch.int16)
    return seed


def _median_spread(times):
    times = sorted(times)
    med = times[len(times) // 2]
    return med, (times[-1] - times[0]) / med


def _event_ms(run: Callable, trials: int, K: int):
    """Median and spread of ``trials`` calls of ``run`` between CUDA events,
    in ms over K."""
    import torch

    times = []
    for _ in range(trials):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / K)
    return _median_spread(times)


def _sync_line(tb) -> str:
    """``path:line`` of the innermost frame of the port in a traceback, else
    of the traceback's innermost frame."""
    frames = traceback.extract_tb(tb)
    for fr in reversed(frames):
        parts = Path(fr.filename).parts
        if PKG in parts:
            return "/".join(parts[parts.index(PKG):]) + f":{fr.lineno}"
    return f"{Path(frames[-1].filename).name}:{frames[-1].lineno}" if frames else "unknown"


def host_sync(fn: Callable, x) -> str | None:
    """Why one step of ``fn`` cannot be captured in a CUDA graph, or None:
    the error a synchronising call raises under
    ``torch.cuda.set_sync_debug_mode("error")``, and the innermost line of
    the port on the way to it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chained(fn, x, 1)
    except RuntimeError as e:
        msg = str(e).strip().splitlines()[0]
        if "synchronizing" not in msg:
            raise  # a failure of the stage itself, not a synchronisation
        return f"{msg} ({_sync_line(e.__traceback__)})"
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return None


def time_stage(fn: Callable, x, K: int, trials: int) -> Dict[str, object]:
    """The record of one stage (see the module's docstring)."""
    import torch

    cuda = x.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    fn(x).item()
    first = time.perf_counter() - t0
    chained(fn, x, K)  # warm
    sync()
    rec: Dict[str, object] = {"graph_ms": None, "spread": None, "graph_reason": None}
    if not cuda:
        times = []
        for _ in range(trials):
            t0 = time.perf_counter()
            chained(fn, x, K).item()
            times.append((time.perf_counter() - t0) * 1e3 / K)
        rec["eager_ms"], rec["eager_spread"] = _median_spread(times)
        rec.update(busy_ms=None, first_call_s=first,
                   graph_reason="CUDA graphs need a CUDA device; host-clock times of the CPU")
        return rec
    rec["eager_ms"], rec["eager_spread"] = _event_ms(lambda: chained(fn, x, K), trials, K)
    rec["busy_ms"] = busy_ms(lambda: chained(fn, x, 1))
    rec["first_call_s"] = first
    reason = host_sync(fn, x)
    if reason is not None:
        rec["graph_reason"] = reason
        return rec
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture needs
        chained(fn, x, 1)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chained(fn, x, K)
    graph.replay()
    torch.cuda.synchronize()
    rec["graph_ms"], rec["spread"] = _event_ms(graph.replay, trials, K)
    del graph
    torch.cuda.synchronize()
    return rec


def busy_ms(step: Callable) -> float:
    """Device ms of the kernels and copies of one call of ``step``, from
    ``torch.profiler`` (after a warm call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def card_name(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[dev.index or 0]


def run(model: str = "spectral", batch: int = 128, iters: int = 64, clip_sec: float = 10.0,
        trials: int = 5, device: str = "cuda", log=print) -> Dict[str, object]:
    """Profile ``model``'s stages; returns the JSON record."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("profile_torch_stages: no CUDA device (pass --device cpu "
                               "for a run on the CPU)")
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None
                           else dev.index)
    prof = build_profile(model, batch, clip_sec, str(dev))
    B = int(prof.x.shape[0])
    results = {}
    for name, fn in prof.stages.items():
        results[name] = time_stage(fn, prof.x, iters, trials)
        log(f"{name}: {results[name]}")
    floor = time_stage(lambda p: p[0, 0].to(torch.float32), prof.x, iters, trials)
    log(f"floor: {floor}")
    rec = {"model": model, "batch": B, "iters": iters,
           "clip_sec": prof.x.shape[-1] / FS, "trials": trials, **prof.meta,
           "device": card_name(dev), "floor": floor, "stages": results}
    if model == "band_noise":
        audio_s = B * prof.x.shape[-1] / FS
        g, e = results["full"]["graph_ms"], results["full"]["eager_ms"]
        rec["audio_sec_per_sec"] = audio_s / (g / 1e3) if g else None
        rec["audio_sec_per_sec_eager"] = audio_s / (e / 1e3)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--clip-sec", type=float, default=10.0)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--model", default="spectral", choices=MODELS,
                    help="roe: the RoE engine at the JAX bench's geometry (32 x 3 s); "
                         "band_noise: the band-noise estimator (32 x 10 s)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="the checkout whose port is profiled")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    rec = run(args.model, args.batch, args.iters, args.clip_sec, args.trials, args.device,
              log=lambda s: print(s, flush=True))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
