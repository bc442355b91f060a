"""Real-time chunked rain detection with the PyTorch port
(``StreamingRainDetector`` demo).

Counterpart of ``examples/streaming_detect.py``.  Simulates a live audio
feed: quiet background for the first half of the stream, rain starting
mid-stream.  Audio arrives in hop-multiple chunks; the detector threads its
state between chunks and reports rain frames as they happen, with NO
lookahead (the same causality contract as the reference firmware,
``edge/rain_frame_classifier.py``; chunk invariance is bitwise,
``tests/test_torch_streaming.py``).

Run: ``python examples/torch_streaming_detect.py [--device cpu]`` (the card
by default; a few seconds on the CPU).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from audio_processing_tools_tpu_torch.config import DEFAULT_MODE_BANDS  # noqa: E402
from audio_processing_tools_tpu_torch.models.frame_classifier import FrameClass  # noqa: E402
from audio_processing_tools_tpu_torch.models.streaming import StreamingRainDetector  # noqa: E402
from audio_processing_tools_tpu_torch.utils.corpus import synth_clip  # noqa: E402

FS = 11162


def main(device: str = "cuda") -> None:
    rng = np.random.default_rng(7)
    quiet = synth_clip("noise", rng, fs=FS, seconds=4.0)
    rainy = synth_clip("rain_heavy", rng, fs=FS, seconds=4.0)
    stream = np.concatenate([quiet, rainy]).astype(np.float32)

    det = StreamingRainDetector(device=device)
    det.setup({
        "sample_rate": FS,
        "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
    })
    state = det.init_state()
    hop = det.cfg.hop
    chunk_len = 32 * hop  # ~0.37 s of audio per "network packet"

    print(f"streaming {len(stream) / FS:.0f} s of audio in "
          f"{chunk_len / FS * 1000:.0f} ms chunks on {device} (rain starts at 4.0 s)")
    t_cursor = 0.0
    first_rain_t = None
    total_rain = 0
    for start in range(0, len(stream) - chunk_len + 1, chunk_len):
        chunk = stream[start : start + chunk_len]
        state, out = det.process_chunk(state, chunk)
        rain_frames = int((out["frame_class"] == int(FrameClass.RAIN)).sum())
        total_rain += rain_frames
        # sustained-detection gate (the clip aggregator's min-frames rule):
        # a lone rain frame during tracker warmup is not an event
        if rain_frames >= 3 and first_rain_t is None:
            first_rain_t = t_cursor
        bar = "#" * min(rain_frames, 40)
        print(f"  t={t_cursor:5.2f}s  rain_frames={rain_frames:3d} {bar}")
        t_cursor += chunk_len / FS

    print(f"\nfirst rain detected at t={first_rain_t:.2f} s "
          f"(ground truth onset 4.00 s); {total_rain} rain frames total")
    if first_rain_t is None or not 3.5 <= first_rain_t <= 6.0:
        raise SystemExit("expected detection shortly after the 4 s onset")
    print("OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Chunked rain detection on a live feed.")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(ap.parse_args().device)
