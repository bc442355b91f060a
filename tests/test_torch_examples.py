"""The port's examples (``examples/torch_*.py``) run for real on the CPU,
each with the check its JAX original makes and ``tests/test_examples.py``
asserts: detection timing, tuning improvement, accuracy and dashboards.
The streaming example's per-chunk rain frames are also held to the JAX
``StreamingRainDetector`` on the same stream (exact: frame counts)."""

import os
import re
import subprocess
import sys

import numpy as np

from audio_processing_tools_tpu.config import DEFAULT_MODE_BANDS
from audio_processing_tools_tpu.models.frame_classifier import FrameClass
from audio_processing_tools_tpu.models.streaming import StreamingRainDetector
from audio_processing_tools_tpu.utils.corpus import synth_clip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 11162


def _run_example(name, args=(), timeout=600):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", name), *args, "--device", "cpu"],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
    )
    assert out.returncode == 0, (
        f"{name} failed:\n{out.stderr[-3000:]}\n{out.stdout[-1000:]}"
    )
    return out.stdout


def _jax_chunk_rain_frames():
    """``examples/streaming_detect.py``'s stream through the JAX detector:
    the rain frames of each chunk."""
    rng = np.random.default_rng(7)
    stream = np.concatenate([synth_clip("noise", rng, fs=FS, seconds=4.0),
                             synth_clip("rain_heavy", rng, fs=FS, seconds=4.0)]).astype(np.float32)
    det = StreamingRainDetector()
    det.setup({"sample_rate": FS, "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)}})
    state = det.init_state()
    chunk_len = 32 * det.cfg.hop
    counts = []
    for start in range(0, len(stream) - chunk_len + 1, chunk_len):
        state, out = det.process_chunk(state, stream[start : start + chunk_len])
        counts.append(int(np.sum(np.asarray(out["frame_class"]) == FrameClass.RAIN)))
    return counts


def test_streaming_detect_example():
    stdout = _run_example("torch_streaming_detect.py")
    assert "first rain detected at t=" in stdout
    assert stdout.strip().endswith("OK")
    counts = [int(m) for m in re.findall(r"rain_frames=\s*(\d+)", stdout)]
    assert counts == _jax_chunk_rain_frames()


def test_tune_thresholds_example():
    stdout = _run_example("torch_tune_thresholds.py")
    assert "RoE gradient fit" in stdout
    assert stdout.strip().endswith("OK")


def test_end_to_end_example(tmp_path):
    out_dir = str(tmp_path / "demo")
    stdout = _run_example("torch_end_to_end.py", (out_dir,))
    assert "accuracy:" in stdout
    assert "'accuracy': 1.0" in stdout  # the labeled corpus's canary, as the JAX example's
    for f in ("overview.png", "classifier_debug.png"):
        assert os.path.exists(os.path.join(out_dir, f)), f
