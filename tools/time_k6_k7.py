#!/usr/bin/env python3
"""Device time of K6 (the band-noise estimator scan, ``csrc/band_noise.cu``)
and K7 (``sosfilt`` with ``zi``, ``csrc/filters.cu``) at the shapes their
paths give them, with each launch apart.

    python3 tools/time_k6_k7.py [--out FILE] [--variant NAME ...]

K6: the band-noise batch (128 clips x 218 frames, the default
configuration), the served path's chunks (4,096-sample packets, 8 frames,
3 streams batched and 1 alone, the scan carried from the packet before, as
``chip_smoke.py`` phase 20 sends them) and the batch at W = 64.  Its inputs
are ``chip_smoke.py``'s band-noise clips through the high-pass, band-pass
and per-frame inputs.  K7: the live prefilter (the streaming detector's TD
high-pass, 2 sections) at 64 streams x 22,272 samples and at the
low-latency profile's 16 x 512 and 16 x 1,024, and band noise's high-pass
(2 sections) and band-pass (4) at 128 x 111,616, with nonzero ``zi``.

For each: the outputs and carries against the plain version, bit for bit
where values are numbers (``chip_smoke.same_bits``), else it exits
non-zero; then device ms per call from a CUDA graph of 20 back-to-back
calls (``chip_smoke.graph_ms``) and each CUDA kernel's device ms per
launch (``chip_smoke.launch_breakdown``).  The SM clock is read with
``nvidia-smi`` while K7's live shape runs for a second, and the cycles of
one thread's dependent float32 chains (an addition; K7's section step) with
the SM's cycle counter, which set K7's chain bound.  ``--variant``
also times named edits of the committed sources (``VARIANTS``), each built
from a copy of ``csrc/`` under ``build/k6k7_variants/``: the design
choices tried.  Prints the card's name and power limit, then one JSON line.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PACKET = 4096  # the served path's packet, 8 frames of 512

#: name: (kernel, keeps the plain version's bits, [(source, text, replacement)])
VARIANTS = {
    # K6 with the rank count over the slot ring on every frame, as before
    # its sorted view
    "k6-rank-count": ("k6", True, [("band_noise.cu", "constexpr bool kSortedView = true;",
                                    "constexpr bool kSortedView = false;")]),
    # K6's prologue and epilogue alone, no frame walked (timing only)
    "k6-no-chain": ("k6", False, [("band_noise.cu", "for (int i = 0; i < nf; ++i) {",
                                   "for (int i = 0; i < 0; ++i) {")]),
    # K6's chain without the common frame's pushes (timing only)
    "k6-no-merge": ("k6", False, [("band_noise.cu", "        if (pm) ring.template push<true>("
                                   "u, ub, pm, pk >> 16, wr, W, frame_idx, count_valid);\n",
                                   "")]),
    # K7's tiles in long rows (from 1,024 samples) and in short ones (from 128)
    **{f"k7-long-tile-{n}": ("k7", True, [("filters.cu", "constexpr int kTileLong = 1024;",
                                            f"constexpr int kTileLong = {n};")])
       for n in (256, 512)},
    **{f"k7-short-tile-{n}": ("k7", True, [("filters.cu", "constexpr int kTileShort = 128;",
                                             f"constexpr int kTileShort = {n};")])
       for n in (256, 1024)},
    # K7 with a run-time test around each section of a sample, which compiles
    # to a branch and a convergence barrier every sample
    "k7-guarded-sections": ("k7", True, [("filters.cu",
                                          "    for (int g = 0; g < G; ++g) {\n"
                                          "      const float out = ",
                                          "    for (int g = 0; g < G; ++g) if (g < S - s0) {\n"
                                          "      const float out = ")]),
    # K7 with two sections a walker: one thread runs both of the live
    # prefilter's sections, sample by sample
    "k7-2-sections-a-walker": ("k7", True, [("filters.cu",
                                             "constexpr int kSectionsPerWalker = 1;",
                                             "constexpr int kSectionsPerWalker = 2;")]),
}


# One thread's dependent float32 chains, timed with the SM's cycle counter:
# a chain of additions, and K7's section recurrence over a constant input
# (its four dependent operations a sample: z0 -> y -> a1 y -> b1 x - a1 y -> + z1).
CHAIN_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void chains(long long* out, float a, float b, float v, int n) {
  float x = a;
  const long long t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) x = __fadd_rn(x, b);
  const long long t1 = clock64();
  float z0 = a, z1 = b;
  const float b0 = 0.25f, b1 = -0.5f, b2 = 0.25f, a1 = -1.5f, a2 = 0.56f;
  const long long t2 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    const float y = __fadd_rn(__fmul_rn(b0, v), z0);
    z0 = __fadd_rn(__fsub_rn(__fmul_rn(b1, v), __fmul_rn(a1, y)), z1);
    z1 = __fsub_rn(__fmul_rn(b2, v), __fmul_rn(a2, y));
  }
  const long long t3 = clock64();
  out[0] = t1 - t0;
  out[1] = t3 - t2;
  out[2] = __float_as_int(x) ^ __float_as_int(z0) ^ __float_as_int(z1);
}
extern "C" int chain_cycles(long long* host, int n) {
  long long* d = nullptr;
  cudaError_t e = cudaMalloc(&d, 3 * sizeof(long long));
  if (e != cudaSuccess) return (int)e;
  chains<<<1, 1>>>(d, 1.0f, 1e-7f, 0.5f, n);
  e = cudaMemcpy(host, d, 3 * sizeof(long long), cudaMemcpyDeviceToHost);
  cudaFree(d);
  return (int)e;
}
"""


def chain_cycles(n: int = 1 << 16) -> dict:
    """Cycles a dependent float32 addition and cycles a sample of K7's
    section recurrence take on one thread of the card (``CHAIN_SOURCE``,
    built with nvcc into ``build/``)."""
    import ctypes

    from audio_processing_tools_tpu_torch import _kernels

    out_dir = REPO / "build" / "chain_cycles"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "chains.cu", out_dir / "libchains.so"
    src.write_text(CHAIN_SOURCE)
    subprocess.run([_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)], check=True,
                   timeout=300)
    fn = ctypes.CDLL(str(lib)).chain_cycles
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    host = (ctypes.c_longlong * 3)()
    if fn(host, n) != 0:
        raise RuntimeError("chain_cycles: the probe failed")
    return {"fadd_cycles": host[0] / n, "section_sample_cycles": host[1] / n}


def smi_query(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def k6_cases(dev) -> dict:
    """K6's (config, carry, inputs) at the batch's, the served chunks' and
    W = 64's shapes."""
    import chip_smoke
    import torch

    from audio_processing_tools_tpu_torch.models import band_noise as tbn

    clips = torch.from_numpy(chip_smoke.band_noise_clips(chip_smoke.BATCH)).to(dev)

    def case(cfg, x, state=None):
        N = cfg.frame_len
        T = x.shape[1] // N
        x = x[:, : T * N].contiguous()
        if state is None:
            hpf, bpf = tbn._design_filters(cfg)
            zi_h, zi_b = tbn._seed(hpf, x[:, 0]), tbn._seed(bpf, x[:, 0])
            carry = tbn._scan_carry_init(cfg, x.shape[0], dev)
        else:
            zi_h, zi_b, carry = state["zi_h"], state["zi_b"], state["scan"]
        x_h, x_bp, _, _ = tbn._filters(cfg, x, zi_h, zi_b)
        return cfg, carry, tbn._per_frame_inputs(x_h, x_bp, cfg, T)

    cfg = tbn.build_band_noise_config({"sample_rate": chip_smoke.FS})
    out = {"batch 128 x 218": case(cfg, clips)}
    for B in (3, 1):
        x = clips[:B, : 2 * PACKET]
        _, state = tbn.band_noise_process_chunk(x[:, :PACKET], cfg,
                                                tbn.band_noise_init_state(cfg, B, dev))
        out[f"served {B} x 8"] = case(cfg, x[:, PACKET:], state)
    cfg64 = tbn.build_band_noise_config({"sample_rate": chip_smoke.FS, "W": 64})
    out["W 64, 128 x 218"] = case(cfg64, clips)
    return out


def k7_cases(dev) -> dict:
    """K7's (coef, x, zi) at the live, low-latency and band-noise shapes."""
    import chip_smoke
    import torch

    from audio_processing_tools_tpu_torch.models import band_noise as tbn
    from audio_processing_tools_tpu_torch.models import streaming as tsm
    from audio_processing_tools_tpu_torch.ops import filters as tfl

    gen = torch.Generator(device=dev).manual_seed(67)
    det = tsm.StreamingRainDetector(device=dev)
    det.setup(dict(chip_smoke.STREAM_PARAMS))
    td = det._static().td_sos
    pcm, _ = chip_smoke.synth_streams(chip_smoke.STREAMS, chip_smoke.CHUNK / chip_smoke.FS + 0.01)
    live = torch.from_numpy(pcm[:, : chip_smoke.CHUNK]).to(dev).to(torch.float32) / 32767.0
    cfg = tbn.build_band_noise_config({"sample_rate": chip_smoke.FS})
    clips = torch.from_numpy(chip_smoke.band_noise_clips(chip_smoke.BATCH)).to(dev)
    xT = clips[:, : clips.shape[1] // cfg.frame_len * cfg.frame_len].contiguous()
    hpf, bpf = tbn._design_filters(cfg)

    def case(sos, x):
        coef = torch.from_numpy(tfl._sos_coefficients(sos)).to(dev)
        zi = 0.01 * torch.randn((x.shape[0], sos.shape[0], 2), generator=gen, device=dev)
        return coef, x.contiguous(), zi

    x_h = tfl.cascade_sosfilt(hpf, xT, tbn._seed(hpf, xT[:, 0]))[0]
    return {
        "live 64 x 22,272": case(td, live),
        "low latency 16 x 512": case(td, live[:16, :512]),
        "low latency 16 x 1,024": case(td, live[:16, :1024]),
        "band noise high-pass 128 x 111,616": case(hpf, xT),
        "band noise band-pass 128 x 111,616": case(bpf, x_h),
    }


def sm_clock_under(fn, seconds: float = 1.0) -> str:
    """The SM clock ``nvidia-smi`` reads while a CUDA graph of ``fn`` is
    replayed back to back for ``seconds``."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(20):
            fn()
    reading = []
    reader = threading.Thread(
        target=lambda: (time.sleep(seconds / 3), reading.append(smi_query("clocks.sm"))))
    reader.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        graph.replay()
        torch.cuda.synchronize()
    reader.join()
    return reading[0]


def time_k6(tbn, cases: dict, exact: bool = True) -> dict:
    """K6 on each case: outputs and carry checked against its plain loop,
    then timed."""
    import chip_smoke
    import torch

    out = {}
    for label, (cfg, carry, inputs) in cases.items():
        out_k, carry_k = tbn._band_scan_cuda(cfg, carry, inputs)
        out_p, carry_p = tbn._band_scan_plain(cfg, carry, inputs)
        torch.cuda.synchronize()
        bad = chip_smoke.k6_mismatches(out_k, out_p)[0]
        bad += [f"carry {key}" for key in chip_smoke.k6_mismatches(carry_k, carry_p)[0]]
        if exact and bad:
            raise SystemExit(f"K6 {label}: not the plain loop's {bad}")
        fn = lambda: tbn._band_scan_cuda(cfg, carry, inputs)  # noqa: E731
        B, T, S = inputs[0].shape
        out[label] = {"lanes": B, "frames": T, "subframes": S, "W": cfg.W, "same_bits": not bad,
                      "graph_ms": chip_smoke.graph_ms(fn),
                      "kernels": chip_smoke.launch_breakdown(fn)}
        print(f"K6 {label}: {out[label]}")
    return out


def time_k7(tfl, cases: dict, exact: bool = True) -> dict:
    """K7 on each case: y and zf checked against its plain loop, then timed."""
    import chip_smoke
    import torch

    out = {}
    for label, (coef, x, zi) in cases.items():
        y_k, z_k = tfl._sosfilt_zi_cuda(coef, x, zi)
        y_p, z_p = tfl._sosfilt_zi_plain(coef, x, zi)
        torch.cuda.synchronize()
        same = chip_smoke.same_bits(y_k, y_p)[0] and chip_smoke.same_bits(z_k, z_p)[0]
        if exact and not same:
            raise SystemExit(f"K7 {label}: not the plain loop's bits")
        fn = lambda: tfl._sosfilt_zi_cuda(coef, x, zi)  # noqa: E731
        b_ms, b_by = chip_smoke.bound_of(4 * (2 * x.numel() + 2 * zi.numel()),
                                         9 * coef.shape[0] * x.numel())
        out[label] = {"rows": x.shape[0], "samples": x.shape[1], "sections": coef.shape[0],
                      "same_bits": same, "graph_ms": chip_smoke.graph_ms(fn),
                      "kernels": chip_smoke.launch_breakdown(fn), "bound_ms": b_ms,
                      "bound_by": b_by}
        print(f"K7 {label}: {out[label]}")
    return out


def variant_source(csrc: Path, name: str) -> Path:
    """A copy of ``csrc`` with the edits of variant ``name``."""
    out = REPO / "build" / "k6k7_variants" / name
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
        print("time_k6_k7: no CUDA device", file=sys.stderr)
        return 1
    from audio_processing_tools_tpu_torch import _kernels
    from audio_processing_tools_tpu_torch.models import band_noise as tbn
    from audio_processing_tools_tpu_torch.ops import filters as tfl

    smi = smi_query("name,power.limit")
    print(smi)
    lib = _kernels.build()
    keep = False  # ptxas's lines for K6's and K7's kernels
    for ln in lib.build_log.splitlines():
        if "Compiling entry function" in ln:
            keep = "band_scan" in ln or "sosfilt_zi" in ln
        if keep and "ptxas info" in ln:
            print(ln.strip())
    dev = torch.device("cuda", 0)
    k6, k7 = k6_cases(dev), k7_cases(dev)
    result = {"card": smi, "k6": time_k6(tbn, k6), "k7": time_k7(tfl, k7),
              "sm_clock_k7_live": sm_clock_under(
                  lambda: tfl._sosfilt_zi_cuda(*k7["live 64 x 22,272"])),
              "chains": chain_cycles(), "variants": {}}
    print(f"SM clock under K7's live shape: {result['sm_clock_k7_live']}; one thread's "
          f"dependent chains: {result['chains']}")

    csrc = _kernels.CSRC
    for name in args.variant:
        kernel, exact, _ = VARIANTS[name]
        _kernels.CSRC = variant_source(csrc, name)
        _kernels._LIBRARY = None
        if kernel == "k6":
            result["variants"][name] = time_k6(
                tbn, {k: k6[k] for k in ("batch 128 x 218", "served 3 x 8")}, exact)
        else:
            result["variants"][name] = time_k7(
                tfl, {k: k7[k] for k in ("live 64 x 22,272", "low latency 16 x 512",
                                         "low latency 16 x 1,024")}, exact)
        _kernels.CSRC, _kernels._LIBRARY = csrc, None
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
