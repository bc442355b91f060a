"""Hardware-in-the-loop classifier backend (Mark-3 MCU via ``m3cli``).

Counterpart of ``audio_processing_tools_tpu/tuning/device_backend.py``
(reference ``edge/parameter_tuning/call_c_fun.py:248-367``): flash the
classifier model, stream audio through the real CM7, parse the response
bytes back into the port's ``rain_cl_optional_data_t``.  The physical
device and the ``m3cli`` binary are absent in CI; the interface stays
pluggable: inject ``runner`` to fake the transport, or rely on the clear
error.
"""

from __future__ import annotations

import ctypes
import subprocess
from typing import Callable, Optional, Tuple

import numpy as np

from audio_processing_tools_tpu_torch.tuning.call_native import rain_cl_optional_data_t

DEFAULT_M3CLI = "m3cli"


class DeviceBackendError(RuntimeError):
    pass


def _default_runner(cmd: list, input_bytes: Optional[bytes] = None) -> bytes:
    try:
        result = subprocess.run(
            cmd, input=input_bytes, capture_output=True, timeout=120,
        )
    except FileNotFoundError as e:
        raise DeviceBackendError(
            f"m3cli binary not found ({cmd[0]!r}). The device-in-loop backend "
            "requires a connected Mark-3 and the firmware CLI on PATH."
        ) from e
    if result.returncode != 0:
        raise DeviceBackendError(
            f"m3cli failed ({result.returncode}): {result.stderr[:500]!r}"
        )
    return result.stdout


def parse_device_response(raw: bytes) -> Tuple[int, float]:
    """Decode the MCU's response bytes into (raindrops, mean_freq[0]).

    The device returns a serialized ``rain_cl_optional_data_t``, parsed as
    ``call_c_fun.py:344-367`` does.
    """
    size = ctypes.sizeof(rain_cl_optional_data_t)
    if len(raw) < size:
        raise DeviceBackendError(
            f"device response too short: {len(raw)} < {size} bytes"
        )
    out = rain_cl_optional_data_t.from_buffer_copy(raw[:size])
    return int(out.raindrops), float(out.mean_freq[0])


def rain_detection_algo_device(
    audio_data: np.ndarray,
    *,
    m3cli_path: str = DEFAULT_M3CLI,
    model_bin: str = "RAINCL.BIN",
    runner: Optional[Callable[[list, Optional[bytes]], bytes]] = None,
    flash_model: bool = False,
    **_params,
) -> Tuple[int, float]:
    """Run the classifier on the physical MCU.

    Steps (``call_c_fun.py:248-367``):
      1. optionally flash the model (``dfu_model <model_bin>``),
      2. stream int16 PCM via ``model_input``,
      3. run ``cm7ctl modelrun <model_bin>``,
      4. parse the optional-data response.
    """
    run = runner or _default_runner

    audio = np.asarray(audio_data)
    if np.issubdtype(audio.dtype, np.floating):
        audio = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    else:
        audio = audio.astype(np.int16)
    pcm = audio.astype("<i2").tobytes()

    if flash_model:
        run([m3cli_path, "dfu_model", model_bin], None)
    run([m3cli_path, "model_input"], pcm)
    response = run([m3cli_path, "cm7ctl", "modelrun", model_bin], None)
    return parse_device_response(response)
