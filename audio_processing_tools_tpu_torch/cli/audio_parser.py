"""MARK decode CLI (parity with reference ``test_audio_parser.py``, headless).

Counterpart of ``audio_processing_tools_tpu/cli/audio_parser.py``, with the
same output.  Parses a MARK file (PCM or forced ALAC), reports stats,
optionally writes a WAV and a waveform PNG (matplotlib, imported only for
``--plot-out``) — no OS media player / human-in-the-loop step.
"""

from __future__ import annotations

import argparse

import numpy as np

from audio_processing_tools_tpu_torch.io.mark import parse_mark_audio_file
from audio_processing_tools_tpu_torch.io.audio import write_wav


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="MARK .bin file")
    ap.add_argument("--force-type", choices=["pcm", "alac"], default=None)
    ap.add_argument("--wav-out", default=None, help="write decoded WAV here")
    ap.add_argument("--plot-out", default=None, help="write waveform PNG here")
    args = ap.parse_args(argv)

    with open(args.path, "rb") as f:
        raw = f.read()
    sig, meta = parse_mark_audio_file(raw, force_file_type=args.force_type)

    print(f"file: {args.path}")
    for k, v in meta.items():
        print(f"  {k}: {v}")
    sig_f = sig.astype(np.float64) / 32768.0
    print(f"  samples: {sig.size}")
    print(f"  rms: {np.sqrt(np.mean(sig_f**2)):.6f}")
    print(f"  peak: {np.max(np.abs(sig_f)):.6f}")

    if args.wav_out:
        write_wav(args.wav_out, sig, meta["sample_rate"])
        print(f"wrote {args.wav_out}")
    if args.plot_out:
        import matplotlib

        matplotlib.use("Agg")
        from audio_processing_tools_tpu_torch.viz.visualize_audio import plot_audio_signal

        fig = plot_audio_signal(sig_f, meta["sample_rate"], title=args.path)
        fig.savefig(args.plot_out, dpi=100)
        print(f"wrote {args.plot_out}")


if __name__ == "__main__":
    main()
