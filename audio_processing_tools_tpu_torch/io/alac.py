"""ALAC decode on the host: the in-process decoder, or the ffmpeg binary
when the caller asks for it.

Counterpart of ``audio_processing_tools_tpu/io/alac.py``.  The reference
(``parse.py:373-472``) decodes payload -> CAF re-containerization ->
ffmpeg subprocess -> int16 WAV.  Two routes here:

  * ``native`` (the default, also taken for ``"auto"``): the port's
    in-process decoder, ``io/alac_native.py::decode_alac_payload`` (its
    magic cookie picks the fast decoder or the libavcodec shim); no
    subprocess, no temporary files.
  * ``ffmpeg``: the reference's subprocess route, only when the caller
    passes ``method="ffmpeg"``.  Where no ffmpeg is found it raises
    ``FileNotFoundError``.

Neither route falls back to the other: a route that cannot decode raises.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import wave
from typing import Optional

import numpy as np

from audio_processing_tools_tpu_torch.io.caf import rearrange_bytes


def resolve_ffmpeg_path(ffmpeg_path: Optional[str] = None) -> str:
    """Resolve ffmpeg: explicit arg > $FFMPEG_PATH > PATH > common locations."""
    candidates = []
    if ffmpeg_path:
        candidates.append(ffmpeg_path)
    env = os.environ.get("FFMPEG_PATH")
    if env:
        candidates.append(env)
    for c in candidates:
        resolved = shutil.which(c)
        if resolved:
            return resolved
        if os.path.exists(c) and os.access(c, os.X_OK):
            return c
    resolved = shutil.which("ffmpeg")
    if resolved:
        return resolved
    for fp in ("/opt/homebrew/bin/ffmpeg", "/usr/local/bin/ffmpeg",
               "/usr/bin/ffmpeg", "/bin/ffmpeg"):
        if os.path.exists(fp) and os.access(fp, os.X_OK):
            return fp
    raise FileNotFoundError(
        "ffmpeg not found. Install it or set FFMPEG_PATH to the absolute "
        "path of ffmpeg."
    )


def have_ffmpeg() -> bool:
    try:
        resolve_ffmpeg_path()
        return True
    except FileNotFoundError:
        return False


def have_alac_decoder() -> bool:
    """True when any ALAC decode route (fast, shim, or ffmpeg) is available."""
    from audio_processing_tools_tpu_torch.io.alac_native import have_alac_shim, load_alac_fast

    try:
        load_alac_fast()
        return True
    except (OSError, RuntimeError):
        return have_alac_shim() or have_ffmpeg()


def decode_alac_to_pcm(audio_data: bytes, *, ffmpeg_path: Optional[str] = None,
                       method: str = "native") -> np.ndarray:
    """Decode a firmware ALAC payload to int16 PCM samples.

    ``method``: ``"native"`` (or ``"auto"``, the JAX package's default
    name): the in-process decoder; ``"ffmpeg"``: the ffmpeg binary on the
    payload re-containerized as CAF.
    """
    if method not in ("auto", "native", "ffmpeg"):
        raise ValueError(f"unknown ALAC decode method: {method!r}")
    if method != "ffmpeg":
        from audio_processing_tools_tpu_torch.io.alac_native import decode_alac_payload

        return decode_alac_payload(audio_data)

    ffmpeg = resolve_ffmpeg_path(ffmpeg_path)
    with tempfile.TemporaryDirectory() as temp_dir:
        caf_path = os.path.join(temp_dir, "audio.caf")
        wav_path = os.path.join(temp_dir, "audio.wav")
        with open(caf_path, "wb") as f:
            f.write(rearrange_bytes(audio_data))

        result = subprocess.run(
            [ffmpeg, "-hide_banner", "-loglevel", "error", "-y",
             "-i", caf_path, wav_path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        if result.returncode != 0:
            raise RuntimeError(
                "ffmpeg failed while decoding ALAC.\n"
                f"Return code: {result.returncode}\n"
                f"stderr:\n{result.stderr.strip()}"
            )

        with wave.open(wav_path, "rb") as wav_file:
            if wav_file.getsampwidth() != 2:
                raise ValueError(
                    f"Expected 16-bit WAV, got sampwidth={wav_file.getsampwidth()}"
                )
            raw = wav_file.readframes(wav_file.getnframes())
            return np.frombuffer(raw, dtype=np.int16)
