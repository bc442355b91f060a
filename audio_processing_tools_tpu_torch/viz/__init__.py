"""Visualization: waveforms, spectra and spectrograms.

Counterpart of ``audio_processing_tools_tpu/viz/__init__.py`` for
``visualize_audio.py``; the engine-debug dashboards
(``visualize_noise_output.py``) are not ported yet.  Figures are returned so
notebooks and tests can assert on them.
"""

from audio_processing_tools_tpu_torch.viz.visualize_audio import (
    plot_audio_signal,
    plot_audio_fft,
    plot_audio_spectrogram,
)

__all__ = [
    "plot_audio_signal",
    "plot_audio_fft",
    "plot_audio_spectrogram",
]
