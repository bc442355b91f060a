"""Legacy output-shape converters (parity with reference ``postprocess/``)."""

from audio_processing_tools_tpu_torch.postprocess.rain import postprocess_rain
from audio_processing_tools_tpu_torch.postprocess.noise import postprocess_noise

__all__ = ["postprocess_rain", "postprocess_noise"]
