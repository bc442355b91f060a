#!/usr/bin/env python3
"""Device time of K8 (the streaming suppressor, ``csrc/streaming.cu``) and
K4 (the cascade filter, ``csrc/cascade.cu``) at the shapes their paths give
them, with each of their launches apart.

    python3 tools/time_k4_k8.py [--out FILE] [--variant NAME ...]

K8: 64 streams x 2 s chunks (174 frames, the live profile), the
low-latency profile's 16 streams x 512 and x 1,024 samples (4 and 8
frames), and 64 x 2 s at n_fft 64 and 1,024; its inputs are a carried
chunk of ``chip_smoke.py``'s synthetic streams through the detector, as
phase 12 makes them.  K4: band noise's high-pass and band-pass at 128 x
111,616 (2 and 4 sections) and RoE's operating band-pass (8 sections, 640 x
22,324) and pulse band-pass (4 sections, 640 x 22,580).

For each: the gain and carries (K8) or y and the final state (K4) against
the plain version, bit for bit (K8's y within 1e-4 of max), else it exits
non-zero; then device ms per call from a CUDA graph of 20 back-to-back
calls (``chip_smoke.graph_ms``) and each CUDA kernel's device ms per launch
(``chip_smoke.launch_breakdown``).  A launch that fails raises.
``--variant`` also times named edits of the committed sources
(``VARIANTS``), each built from a copy of ``csrc/`` under
``build/k4k8_variants/``: the experiments behind the kernels' design
choices.  Prints the card's name and power limit, then one JSON line.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

K8_SHAPES = (  # label, streams, chunk samples, extra parameters
    ("live 64 x 174", 64, 22_272, {}),
    ("low latency 16 x 4", 16, 512, {}),
    ("low latency 16 x 8", 16, 1_024, {}),
    ("n_fft 64, 64 x 2 s", 64, 22_272, {"n_fft": 64, "hop": 32}),
    ("n_fft 1024, 64 x 2 s", 64, 22_016, {"n_fft": 1024, "hop": 512}),
)

#: name: (kernel, keeps the plain version's bits, [(source, text, replacement)])
VARIANTS = {
    # K4's output pass without its Toeplitz loop (timing only: y is wrong)
    "k4-no-toeplitz-loop": ("k4", False, [("cascade.cu", "for (int g = 1; g <= i0; g += kWin)",
                                           "for (int g = 1; g <= 0; g += kWin)")]),
    # four walk warps (clips) a CUDA block, the earlier design
    "k4-walk-4-warps": ("k4", True, [("cascade.cu", "constexpr int kWalkLanes = 1;",
                                      "constexpr int kWalkLanes = 4;")]),
    # K8's walk with 1, 2 or 8 frames a round between barriers
    **{f"k8-walk-{n}-frames": ("k8", True, [("streaming.cu", "constexpr int kFrames = 4;",
                                             f"constexpr int kFrames = {n};")])
       for n in (1, 2, 8)},
}


def k8_case(tsm, params: dict, B: int, L: int, dev):
    """K8's arguments for the second chunk of ``B`` synthetic streams of
    ``L`` samples through the audio-out detector."""
    import chip_smoke
    import torch

    from audio_processing_tools_tpu_torch.ops.spectrogram import spectrogram_power

    det = tsm.StreamingRainDetector(device=dev)
    det.setup({**chip_smoke.STREAM_AUDIO, **params})
    st = det._static()
    pcm, _ = chip_smoke.synth_streams(B, max(2 * L / chip_smoke.FS, 1.0) + 0.01)
    x = torch.from_numpy(pcm[:, : 2 * L]).to(dev).to(torch.float32) / 32767.0
    state, _ = det.process_chunk_batch(det.init_state_batch(B), x[:, :L])
    x1 = x[:, L:]
    xa = torch.cat([state["raw_tail"], x1], dim=1)
    P = spectrogram_power(xa, n_fft=st.n_fft, hop=st.hop, center=False)
    carry = (tsm._seed_psd(state["sup_psd"], P[:, st.rows, 0], det.cfg.eps),
             state["gain_prev"], state["ola_tail"])
    _, out = det.process_chunk_batch(state, x1)
    return (det.suppressor(), xa, P, out["frame_class"], out["noise_conf"], state["frame_idx"],
            carry)


def k4_cases(dev):
    """K4's four (label, sos, rows, zi) at band noise's and RoE's shapes."""
    import chip_smoke
    import torch

    from audio_processing_tools_tpu_torch.models import band_noise as tbn
    from audio_processing_tools_tpu_torch.models import roe
    from audio_processing_tools_tpu_torch.ops import filters as tfl

    cfg = tbn.build_band_noise_config({"sample_rate": chip_smoke.FS})
    clips = torch.from_numpy(chip_smoke.band_noise_clips(chip_smoke.BATCH)).to(dev)
    T = clips.shape[1] // cfg.frame_len * cfg.frame_len
    xT = clips[:, :T].contiguous()
    hpf, bpf = tbn._design_filters(cfg)
    x_h = tfl.cascade_sosfilt(hpf, xT, tbn._seed(hpf, xT[:, 0]))[0]
    rc = roe.build_roe_config(return_spectra=False)
    x = torch.from_numpy(chip_smoke.synth_clips()[0]).to(dev)
    rows = torch.cat([x[:, o : o + t] for o, t in roe._chunk_plan(rc, x.shape[-1])], 0).contiguous()
    nyq = 0.5 * chip_smoke.FS
    sos8 = tfl.butter_sos(8, [rc.op_freq_range[0] / nyq, rc.op_freq_range[1] / nyq], "bandpass")
    sos4 = tfl.butter_sos(4, [400.0 / nyq, 900.0 / nyq], "bandpass")
    y8 = tfl.cascade_sosfilt(sos8, rows, torch.zeros((rows.shape[0], 8, 2), device=dev))[0]
    padded = torch.nn.functional.pad(y8, (rc.hop_length, rc.hop_length)).contiguous()
    return [(label, sos, xs, 0.01 * torch.ones((xs.shape[0], 2 * sos.shape[0]), device=dev))
            for label, sos, xs in (("band noise high-pass", hpf, xT),
                                   ("band noise band-pass", bpf, x_h),
                                   ("RoE operating band-pass", sos8, rows),
                                   ("RoE pulse band-pass", sos4, padded))]


def time_k8(tsm, cases, exact: bool = True) -> dict:
    """K8 on each case: checked against its plain loop, then timed."""
    import chip_smoke
    import torch

    out = {}
    for label, case in cases.items():
        y_k, _, g_k = tsm._suppressor_cuda(*case, want_gain=True)
        y_p, _, g_p = tsm._suppressor_plain(*case)
        torch.cuda.synchronize()
        same_g, _ = chip_smoke.same_bits(g_k, g_p)
        y_rel = float((y_k - y_p).abs().max() / y_p.abs().max())
        if exact and not (same_g and y_rel <= 1e-4):
            raise SystemExit(f"K8 {label}: gain bits {same_g}, y {y_rel:.3e}")
        fn = lambda: tsm._suppressor_cuda(*case)  # noqa: E731
        out[label] = {"streams": int(case[3].shape[0]), "frames": int(case[3].shape[1]),
                      "n_fft": case[0].st.n_fft, "graph_ms": chip_smoke.graph_ms(fn),
                      "kernels": chip_smoke.launch_breakdown(fn), "y_rel": y_rel}
        print(f"K8 {label}: {out[label]}")
    return out


def time_k4(cases, exact: bool = True) -> dict:
    """K4 on each case: checked against its plain version, then timed."""
    import chip_smoke

    from audio_processing_tools_tpu_torch.ops import filters as tfl

    out = {}
    for label, sos, xs, zi in cases:
        (y_k, z_k), (y_p, z_p) = chip_smoke.k4_pair(sos, xs, zi)
        same = chip_smoke.same_bits(y_k, y_p)[0] and chip_smoke.same_bits(z_k, z_p)[0]
        if exact and not same:
            raise SystemExit(f"K4 {label}: not the plain version's bits")
        flat, _ = chip_smoke.k4_tables(sos, xs.shape[-1], xs.device)
        fn = lambda: tfl._cascade_sosfilt_cuda(flat, xs, zi, sos.shape[0])  # noqa: E731
        b_ms, b_by = chip_smoke.bound_of(*chip_smoke.k4_work(xs, sos.shape[0]))
        out[label] = {"rows": xs.shape[0], "samples": xs.shape[1], "sections": sos.shape[0],
                      "same_bits": same, "graph_ms": chip_smoke.graph_ms(fn),
                      "kernels": chip_smoke.launch_breakdown(fn), "bound_ms": b_ms, "bound_by": b_by}
        print(f"K4 {label}: {out[label]}")
    return out


def variant_source(csrc: Path, name: str) -> Path:
    """A copy of ``csrc`` with the edits of variant ``name``."""
    out = REPO / "build" / "k4k8_variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    for source, text, replacement in VARIANTS[name][2]:
        src = (out / source).read_text()
        if src.count(text) != 1:
            raise SystemExit(f"variant {name}: {source} has no single {text!r}")
        (out / source).write_text(src.replace(text, replacement))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS))
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))

    import torch

    if not torch.cuda.is_available():
        print("time_k4_k8: no CUDA device", file=sys.stderr)
        return 1
    from audio_processing_tools_tpu_torch import _kernels
    from audio_processing_tools_tpu_torch.models import streaming as tsm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    lib = _kernels.build()
    keep = False  # ptxas's lines for K8's and K4's kernels
    for ln in lib.build_log.splitlines():
        if "Compiling entry function" in ln:
            keep = "suppressor" in ln or "cascade" in ln
        if keep and "ptxas info" in ln:
            print(ln.strip())
    dev = torch.device("cuda", 0)
    k8 = {label: k8_case(tsm, params, B, L, dev) for label, B, L, params in K8_SHAPES}
    k4 = k4_cases(dev)
    result = {"card": smi, "k8": time_k8(tsm, k8), "k4": time_k4(k4),
              "variants": {}}

    csrc = _kernels.CSRC
    for name in args.variant:
        kernel, exact, _ = VARIANTS[name]
        _kernels.CSRC = variant_source(csrc, name)
        _kernels._LIBRARY = None
        if kernel == "k8":
            result["variants"][name] = time_k8(tsm, {"live 64 x 174": k8["live 64 x 174"]}, exact)
        else:
            result["variants"][name] = time_k4([k4[1], k4[2]], exact)
        _kernels.CSRC, _kernels._LIBRARY = csrc, None
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
