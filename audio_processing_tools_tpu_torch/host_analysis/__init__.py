"""Host-analysis tools: the firmware's DSD minute vectors.

Counterpart of ``audio_processing_tools_tpu/host_analysis/__init__.py``:
the NumPy emulator (the oracle, a host copy) and the device pipeline.
"""

from audio_processing_tools_tpu_torch.host_analysis.dsd_emulator import (
    DsdProcessingEmulator,
    DsdProcessingEmualtor,  # the reference's misspelt name
)
from audio_processing_tools_tpu_torch.host_analysis.dsd_device import (
    dsd_minutes_device,
    dsd_minutes_device_duty_cycled,
)

__all__ = [
    "DsdProcessingEmulator",
    "DsdProcessingEmualtor",
    "dsd_minutes_device",
    "dsd_minutes_device_duty_cycled",
]
