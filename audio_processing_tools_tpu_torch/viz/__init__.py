"""Visualization: waveforms, spectrograms, engine debug dashboards.

Counterpart of ``audio_processing_tools_tpu/viz/__init__.py``
(``visualize_audio.py`` and ``visualize_noise_output.py``): the same names
and signatures, matplotlib figures returned so notebooks and tests can
assert on them.  The dashboards read the port engine's outputs, tensors on
any device or NumPy.
"""

from audio_processing_tools_tpu_torch.viz.visualize_audio import (
    plot_audio_signal,
    plot_audio_fft,
    plot_audio_spectrogram,
)
from audio_processing_tools_tpu_torch.viz.visualize_noise_output import (
    show_noise_processing_results,
    frames_to_df,
    plot_frame_classifier_debug,
    plot_frame_classifier_tuning,
    plot_noise_suppressor_debug,
)

__all__ = [
    "plot_audio_signal",
    "plot_audio_fft",
    "plot_audio_spectrogram",
    "show_noise_processing_results",
    "frames_to_df",
    "plot_frame_classifier_debug",
    "plot_frame_classifier_tuning",
    "plot_noise_suppressor_debug",
]
