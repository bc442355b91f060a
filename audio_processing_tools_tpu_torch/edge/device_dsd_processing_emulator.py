"""Shim: the import path ``edge.device_dsd_processing_emulator`` that the
reference's ``transform.py:25`` and ``visualization_utils.py:8`` expect but
which is broken in the reference's packaged layout (SURVEY §7).  Here it
works."""

from audio_processing_tools_tpu_torch.host_analysis.dsd_emulator import (  # noqa: F401
    DsdProcessingEmulator,
    DsdProcessingEmualtor,
    read_audio_file,
    dsd_minutes_vectorized,
    HEADER_SIZE,
    DEFAULT_BYTES_PER_SAMPLE,
)
