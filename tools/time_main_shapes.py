#!/usr/bin/env python3
"""Device time of K1, K4, K6, K7, K8, K9 and K10 at the shapes the main
paths give them, from one checkout's kernels.

    python3 tools/time_main_shapes.py [--root DIR] [--routes] [--out FILE]

K1: the spectral engine's 128 x 10 s batch at 256/128, and at 384/192 and
2048/1024 (off the main path: the mixed-radix route).  K4: band noise's
high-pass (2 sections) and band-pass (4 sections) at 128 x 111,616, and an
8-section band-pass at RoE's 640 x 22,324.  K6: band noise's default scan,
128 lanes x 218 frames.  K7: the live detector's TD prefilter at 64 x
22,272.  K8: the live detector's suppressor with audio out, 64 streams x 2
s, a carried chunk, at 256/128 and at 384/192 (the mixed frame pass).  K9: the confirmer's 871 windows of 384 samples of one
10 s clip, cap 64.  K10: 128 clips x 873 frames of random features with
``chip_smoke.TUNE_GRID``'s combos.  The inputs come from
``chip_smoke.py``'s synthetic clips and streams.  ``--routes`` adds K1's
other routes off the main path (odd mixed 385/192, Rader 1009/504, even
chirp-z 296/148 and 2062/1031, global 16384/8192, 32768/16384 and
60000/30000, split 9999/4999 and 14530/7265, which a checkout without the
split route runs on the chirp-z global route) and K8's chirp-z and global frame passes (296/148,
5920/2960, 10240/5120), a carried 64 x 2 s chunk each.

Each: device ms per call from a CUDA graph of back-to-back calls
(``chip_smoke.graph_ms``), and the kernel's output against its plain
version on the card (bits; K1 within 1e-5 of the maximum, K8's y within
1e-4), else it exits non-zero.  ``--root`` imports the port and
``chip_smoke.py`` from another checkout (the parent's kernels: ``git
archive <parent> | tar -x -C build/parent``), so that two trees are timed
on one card in turns, one process each (parent, this, this, parent).
Prints the card's name and power limit, then one JSON line.  Needs a CUDA
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def cases(dev):
    """Each kernel's call at its main shape and the check of its result:
    ``{label: (call, check)}``; ``check()`` returns the largest error or
    raises ``SystemExit``."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from audio_processing_tools_tpu_torch.models import band_noise as tbn
    from audio_processing_tools_tpu_torch.models import streaming as tsm
    from audio_processing_tools_tpu_torch.ops import filters as tfl
    from audio_processing_tools_tpu_torch.ops import peaks as tpk
    from audio_processing_tools_tpu_torch.ops import sweep as tsw
    from audio_processing_tools_tpu_torch.ops.spectrogram import spectrogram_power
    from audio_processing_tools_tpu_torch.ops.stft import stft_power
    from audio_processing_tools_tpu_torch.tuning.grid_search import (
        combo_sweep_params,
        generate_param_combinations,
    )

    gen = torch.Generator(device=dev).manual_seed(45)
    out = {}

    def bits(a, b, label):
        same, d = cs.same_bits(a, b)
        if not same:
            raise SystemExit(f"{label}: not the plain version's bits (max|d| {d:.3e})")
        return d

    clips, _ = cs.synth_clips()
    x = torch.from_numpy(clips).to(dev)

    def k1_check():
        d = float((spectrogram_power(x) - stft_power(x)).abs().max())
        if d > 1e-5 * float(stft_power(x).abs().max()):
            raise SystemExit(f"K1: max|d| {d:.3e}")
        return d

    out["K1 256/128 128 x 111,620"] = (lambda: spectrogram_power(x), k1_check)

    # K1 at sizes off the main path (the mixed route since it exists, the
    # DFT route before)
    for n_fft in (384, 2048):
        hop = n_fft // 2

        def k1_check_at(n_fft=n_fft, hop=hop):
            ref = stft_power(x, n_fft=n_fft, hop=hop)
            d = float((spectrogram_power(x, n_fft=n_fft, hop=hop) - ref).abs().max())
            if d > 1e-5 * float(ref.abs().max()):
                raise SystemExit(f"K1 {n_fft}/{hop}: max|d| {d:.3e}")
            return d

        out[f"K1 {n_fft}/{hop} 128 x 111,620"] = (
            lambda n_fft=n_fft, hop=hop: spectrogram_power(x, n_fft=n_fft, hop=hop), k1_check_at)

    xb = torch.from_numpy(np.ascontiguousarray(cs.band_noise_clips(128)[:, : 872 * 128])).to(dev)
    hpf, bpf = tbn._design_filters(tbn.BandNoiseEstimatorConfig())
    roe_x = 0.1 * torch.randn((640, 22_324), generator=gen, device=dev)
    roe_sos = tfl.butter_sos(8, [400.0 / (0.5 * cs.FS), 3500.0 / (0.5 * cs.FS)], "bandpass")
    for label, sos, xs in (("K4 high-pass 2 sections 128 x 111,616", hpf, xb),
                           ("K4 band-pass 4 sections 128 x 111,616", bpf, xb),
                           ("K4 band-pass 8 sections 640 x 22,324", roe_sos, roe_x)):
        zi = 0.01 * torch.randn((xs.shape[0], 2 * sos.shape[0]), generator=gen, device=dev)
        flat, tabs = cs.k4_tables(sos, xs.shape[-1], dev)
        S = sos.shape[0]

        def k4_check(flat=flat, tabs=tabs, xs=xs, zi=zi, S=S, label=label):
            (y, z), (yp, zp) = tfl._cascade_sosfilt_cuda(flat, xs, zi, S), \
                tfl._cascade_sosfilt_plain(tabs, xs, zi)
            return max(bits(y, yp, label), bits(z, zp, label))

        out[label] = (lambda flat=flat, xs=xs, zi=zi, S=S: tfl._cascade_sosfilt_cuda(flat, xs, zi, S),
                      k4_check)

    c6 = tbn.build_band_noise_config({"sample_rate": cs.FS})
    h6, b6 = tbn._design_filters(c6)
    T6 = xb.shape[-1] // c6.frame_len
    x6 = xb[:, : T6 * c6.frame_len].contiguous()
    xh, xbp, _, _ = tbn._filters(c6, x6, tbn._seed(h6, x6[:, 0]), tbn._seed(b6, x6[:, 0]))
    inputs6 = tbn._per_frame_inputs(xh, xbp, c6, T6)
    carry6 = tbn._scan_carry_init(c6, x6.shape[0], dev)

    def k6_check():
        (o, c), (op, cp) = tbn._band_scan_cuda(c6, carry6, inputs6), \
            tbn._band_scan_plain(c6, carry6, inputs6)
        bad = cs.k6_mismatches(o, op)[0] + cs.k6_mismatches(c, cp)[0]
        if bad:
            raise SystemExit(f"K6: not the plain loop's {bad}")
        return 0.0

    out[f"K6 default 128 x {T6} frames"] = (lambda: tbn._band_scan_cuda(c6, carry6, inputs6),
                                            k6_check)

    pcm, _ = cs.synth_streams(cs.STREAMS, 2 * cs.CHUNK / cs.FS)
    xs_all = torch.from_numpy(pcm).to(dev).to(torch.float32) / 32767.0
    det = tsm.StreamingRainDetector(device=dev)
    det.setup(dict(cs.STREAM_AUDIO))
    st = det._static()
    x0 = xs_all[:, : cs.CHUNK].contiguous()
    coef = torch.from_numpy(tfl._sos_coefficients(st.td_sos)).to(dev)
    zi7 = 0.01 * torch.randn((cs.STREAMS, st.td_sos.shape[0], 2), generator=gen, device=dev)

    def k7_check():
        (y, z), (yp, zp) = tfl._sosfilt_zi_cuda(coef, x0, zi7), tfl._sosfilt_zi_plain(coef, x0, zi7)
        return max(bits(y, yp, "K7"), bits(z, zp, "K7"))

    out[f"K7 {st.td_sos.shape[0]} sections {cs.STREAMS} x {cs.CHUNK:,}"] = (
        lambda: tfl._sosfilt_zi_cuda(coef, x0, zi7), k7_check)

    state, _ = det.process_chunk_batch(det.init_state_batch(cs.STREAMS), x0)
    x1 = xs_all[:, cs.CHUNK :].contiguous()
    xa = torch.cat([state["raw_tail"], x1], dim=1)
    P = spectrogram_power(xa, n_fft=st.n_fft, hop=st.hop, center=False)
    carry = (tsm._seed_psd(state["sup_psd"], P[:, st.rows, 0], det.cfg.eps),
             state["gain_prev"], state["ola_tail"])
    _, o1 = det.process_chunk_batch(state, x1)
    args = (det.suppressor(), xa, P, o1["frame_class"], o1["noise_conf"], state["frame_idx"],
            carry)

    def k8_check():
        y, _, g = tsm._suppressor_cuda(*args, want_gain=True)
        yp, _, gp = tsm._suppressor_plain(*args)
        bits(g, gp, "K8 gain")
        d = float((y - yp).abs().max())
        if d > 1e-4 * float(yp.abs().max()):
            raise SystemExit(f"K8: y max|d| {d:.3e}")
        return d

    out[f"K8 {cs.STREAMS} x {P.shape[-1]} frames"] = (lambda: tsm._suppressor_cuda(*args),
                                                     k8_check)

    # K8 at 384/192, a carried chunk (the mixed frame pass since it exists)
    det3 = tsm.StreamingRainDetector(device=dev)
    det3.setup({**cs.STREAM_AUDIO, "n_fft": 384, "hop": 192})
    st3 = det3._static()
    L3 = cs.CHUNK // st3.hop * st3.hop
    state3, _ = det3.process_chunk_batch(det3.init_state_batch(cs.STREAMS), xs_all[:, :L3])
    x3 = xs_all[:, L3 : 2 * L3].contiguous()
    xa3 = torch.cat([state3["raw_tail"], x3], dim=1)
    P3 = spectrogram_power(xa3, n_fft=st3.n_fft, hop=st3.hop, center=False)
    carry3 = (tsm._seed_psd(state3["sup_psd"], P3[:, st3.rows, 0], det3.cfg.eps),
              state3["gain_prev"], state3["ola_tail"])
    _, o3 = det3.process_chunk_batch(state3, x3)
    args3 = (det3.suppressor(), xa3, P3, o3["frame_class"], o3["noise_conf"],
             state3["frame_idx"], carry3)

    def k8_check_384():
        y, _, g = tsm._suppressor_cuda(*args3, want_gain=True)
        yp, _, gp = tsm._suppressor_plain(*args3)
        bits(g, gp, "K8 384/192 gain")
        d = float((y - yp).abs().max())
        if d > 1e-4 * float(yp.abs().max()):
            raise SystemExit(f"K8 384/192: y max|d| {d:.3e}")
        return d

    out[f"K8 384/192 {cs.STREAMS} x {P3.shape[-1]} frames"] = (
        lambda: tsm._suppressor_cuda(*args3), k8_check_384)

    x9, p9, d9 = cs.k9_confirmer_rows(clips[1], dev)

    def k9_check():
        got = tpk._select_peaks_by_distance_cuda(x9, p9, d9, 64)
        if not torch.equal(got, tpk._select_peaks_by_distance_plain(x9, p9, d9, 64)):
            raise SystemExit("K9: not the plain loop's mask")
        return 0.0

    out[f"K9 {tuple(x9.shape)} cap 64"] = (
        lambda: tpk._select_peaks_by_distance_cuda(x9, p9, d9, 64), k9_check)

    feats = {k: 3.0 * torch.rand((128, 873), generator=gen, device=dev) for k in tsw.FEATURES}
    combos = generate_param_combinations(cs.TUNE_GRID)
    prm = combo_sweep_params(combos, dict(cs.TUNE_BASE), dev)
    ops = tsw.k10_operands(feats, prm)

    def k10_check():
        if not torch.equal(tsw._launch_k10(*ops), tsw._decision_counts_plain(feats, prm)):
            raise SystemExit("K10: counts differ from the plain version")
        return 0.0

    out[f"K10 {len(combos):,} combos x 128 x 873"] = (lambda: tsw._launch_k10(*ops), k10_check)
    return out


def route_cases(dev):
    """K1's and K8's routes off the main path, as :func:`cases` gives the
    main shapes: ``{label: (call, check)}``."""
    import torch

    import chip_smoke as cs
    from audio_processing_tools_tpu_torch.models import streaming as tsm
    from audio_processing_tools_tpu_torch.ops.spectrogram import k1_route, spectrogram_power
    from audio_processing_tools_tpu_torch.ops.stft import stft_power

    out = {}
    x = torch.from_numpy(cs.synth_clips()[0]).to(dev)
    for n_fft in (385, 1009, 296, 2062, 16384, 32768, 60000, 9999, 14530):
        hop = n_fft // 2

        def k1_check(n_fft=n_fft, hop=hop):
            ref = stft_power(x, n_fft=n_fft, hop=hop)
            d = float((spectrogram_power(x, n_fft=n_fft, hop=hop) - ref).abs().max())
            if d > 1e-5 * float(ref.abs().max()):
                raise SystemExit(f"K1 {n_fft}/{hop}: max|d| {d:.3e}")
            return d

        out[f"K1 {n_fft}/{hop} {k1_route(n_fft, hop)} 128 x 111,620"] = (
            lambda n_fft=n_fft, hop=hop: spectrogram_power(x, n_fft=n_fft, hop=hop), k1_check)

    pcm, _ = cs.synth_streams(cs.STREAMS, 2 * cs.CHUNK / cs.FS + 1.0)
    xs_all = torch.from_numpy(pcm).to(dev).to(torch.float32) / 32767.0
    for n_fft in (296, 5920, 10240):
        det = tsm.StreamingRainDetector(device=dev)
        det.setup({**cs.STREAM_AUDIO, "n_fft": n_fft, "hop": n_fft // 2})
        st = det._static()
        L = max(cs.CHUNK // st.hop, 2) * st.hop
        state, _ = det.process_chunk_batch(det.init_state_batch(cs.STREAMS), xs_all[:, :L])
        x1 = xs_all[:, L : 2 * L].contiguous()
        xa = torch.cat([state["raw_tail"], x1], dim=1)
        P = spectrogram_power(xa, n_fft=st.n_fft, hop=st.hop, center=False)
        carry = (tsm._seed_psd(state["sup_psd"], P[:, st.rows, 0], det.cfg.eps),
                 state["gain_prev"], state["ola_tail"])
        _, o1 = det.process_chunk_batch(state, x1)
        args = (det.suppressor(), xa, P, o1["frame_class"], o1["noise_conf"],
                state["frame_idx"], carry)

        def k8_check(args=args, n_fft=n_fft):
            y, _, g = tsm._suppressor_cuda(*args, want_gain=True)
            yp, _, gp = tsm._suppressor_plain(*args)
            same, _ = cs.same_bits(g, gp)
            if not same:
                raise SystemExit(f"K8 {n_fft}: not the plain loop's gain")
            d = float((y - yp).abs().max())
            if d > 1e-4 * float(yp.abs().max()):
                raise SystemExit(f"K8 {n_fft}: y max|d| {d:.3e}")
            return d

        label = f"K8 {n_fft}/{n_fft // 2} {tsm.k8_route(n_fft)} {cs.STREAMS} x {P.shape[-1]} frames"
        out[label] = (lambda args=args: tsm._suppressor_cuda(*args), k8_check)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--routes", action="store_true",
                    help="also K1's and K8's routes off the main path")
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("time_main_shapes: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from audio_processing_tools_tpu_torch import _kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    _kernels.build()
    dev = torch.device("cuda", 0)
    result = {"root": args.root, "card": smi, "ms": {}, "max_abs_err": {}}
    todo = {**cases(dev), **(route_cases(dev) if args.routes else {})}
    for label, (call, check) in todo.items():
        result["max_abs_err"][label] = check()
        torch.cuda.synchronize()
        result["ms"][label] = cs.graph_ms(call)
        print(f"{label}: {result['ms'][label]:.4f} ms")
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
