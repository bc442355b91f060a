"""Engine debug dashboards (parity with ``visualize_noise_output.py``).

Counterpart of ``audio_processing_tools_tpu/viz/visualize_noise_output.py``
(``:31-418``).  Panel inventory mirrors the reference (matplotlib; plotly is
not a dependency):

  * ``show_noise_processing_results`` (``:15-196``): audio playback (when
    IPython is present) + waveform overlay + original/denoised spectrograms
    + noise PSD + debug rows (gain G, band power, band noise), each 1-D as a
    line or 2-D as a heatmap.
  * ``plot_frame_classifier_debug`` (``:241-393``): optional waveform,
    score/label track with PSD-update markers, flux evidence, TD features,
    gate tracks, decision.
  * ``plot_frame_classifier_tuning`` (``:395-639``): optional waveform,
    rain/noise confidence with threshold overlays and PSD-update markers,
    time windowing, per-mode flux-vs-threshold panels.
  * ``plot_noise_suppressor_debug`` (``:641-727``): G / P_band_all /
    N_band_all as heat-or-line rows, graceful empty-figure fallback.

The panels read the port engine's outputs as they come: tensors on any
device (``process_batch``, one clip's row of it) or NumPy arrays
(``process``); each value is copied to the host once.  pandas, matplotlib
and IPython are imported inside the functions.  Every panel function
returns the matplotlib Figure so tests can assert panel/series content.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np


def _host(x):
    """A tensor (any device) or array-like as a NumPy array; None stays."""
    if x is None:
        return None
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _display_audio(x, sr: int, label: str) -> bool:
    """Jupyter playback widget when IPython is available (reference
    ``visualize_noise_output.py:32-36``); headless no-op otherwise."""
    try:
        import IPython.display as ipd
    except ImportError:
        return False
    print(f"{label}:")
    ipd.display(ipd.Audio(_host(x), rate=sr))
    return True


def frames_to_df(det_debug: Dict[str, Any], times: Optional[np.ndarray] = None):
    """Per-frame detector streams as a pandas DataFrame
    (``visualize_noise_output.py:197-239`` equivalent)."""
    import pandas as pd

    n = None
    cols: Dict[str, np.ndarray] = {}
    for k, v in det_debug.items():
        arr = _host(v) if not isinstance(v, (dict, str, bool, int, float)) else None
        if arr is not None and arr.ndim == 1:
            if n is None:
                n = arr.shape[0]
            if arr.shape[0] == n:
                cols[k] = arr
    df = pd.DataFrame(cols)
    if times is not None and len(times) == len(df):
        df.insert(0, "time_s", _host(times))
    return df


def _heat_or_line(fig, ax, data, times, title: str, ylabel: str,
                  freqs: Optional[np.ndarray] = None) -> None:
    """1-D -> line, 2-D -> heatmap (reference ``_plot_1d_or_2d``)."""
    arr = _host(data)
    times = _host(times)
    if arr.ndim == 1:
        x = times if times is not None and len(times) == len(arr) \
            else np.arange(len(arr))
        ax.plot(x, arr)
        ax.grid(True, alpha=0.3)
        ax.set_ylabel(ylabel)
    elif arr.ndim == 2:
        x = times if times is not None and len(times) == arr.shape[1] \
            else np.arange(arr.shape[1])
        y = freqs if freqs is not None and len(freqs) == arr.shape[0] \
            else np.arange(arr.shape[0])
        im = ax.pcolormesh(x, y, arr, shading="auto")
        fig.colorbar(im, ax=ax)
        ax.set_ylabel(ylabel if freqs is None else "Freq [Hz]")
    else:
        ax.text(0.5, 0.5, f"unsupported shape {arr.shape}", ha="center",
                va="center")
    ax.set_title(title, fontsize=9)


def show_noise_processing_results(out: Dict[str, Any], sample_rate: int = 11162,
                                  fmax: float = 4000.0, title_prefix: str = "",
                                  play_audio: bool = True,
                                  title: Optional[str] = None):
    """Playback + waveform/spectrogram/noise-PSD/gain dashboard
    (``visualize_noise_output.py:15-196``).

    ``out`` is the payload of ``SpectralNoiseEngine.process`` with
    ``return_spectra``/``return_debug``/``compute_output_audio`` on (missing
    pieces degrade to fewer panels).
    """
    import matplotlib.pyplot as plt

    if title:  # back-compat alias
        title_prefix = title
    if title_prefix:
        title_prefix = title_prefix.strip() + " - "
    eps = 1e-9

    x = _host(out.get("x_filt"))
    y = _host(out.get("y", out.get("y_suppressed")))
    S = _host(out.get("S"))
    S_hat = _host(out.get("S_hat"))
    debug = out.get("debug") or {}
    noise_psd = _host(out.get("noise_psd", debug.get("noise_psd")))
    times = _host(out["times"]) if "times" in out else None
    freqs = (np.linspace(0.0, sample_rate / 2.0, S.shape[0])
             if S is not None else None)

    if play_audio:
        if x is not None:
            _display_audio(x, sample_rate, f"{title_prefix}Original audio")
        if y is not None:
            _display_audio(y, sample_rate, f"{title_prefix}Denoised audio")

    G = _host(debug.get("G"))
    P_band = _host(debug.get("P_band_all"))
    N_band = _host(debug.get("N_band_all"))
    freqs_band = _host(debug.get("freqs_band"))

    n_specs = int(S is not None) + int(S_hat is not None) + int(
        noise_psd is not None)
    extra = int(G is not None) + int(P_band is not None) + int(N_band is not None)
    total_rows = 1 + n_specs + extra
    fig, axes = plt.subplots(total_rows, 1, figsize=(10, 3 * total_rows))
    axes = np.atleast_1d(axes)
    row = 0

    # 1) waveform overlay
    ax = axes[row]; row += 1
    if x is not None:
        ax.plot(np.arange(len(x)) / sample_rate, x,
                label="Original", alpha=0.7)
    if y is not None:
        ax.plot(np.arange(len(y)) / sample_rate, y,
                label="Denoised", alpha=0.7)
    ax.set_title(f"{title_prefix}Waveforms")
    ax.set_xlabel("Time [s]")
    ax.legend(fontsize=8)
    ax.grid(True, alpha=0.3)

    fmask = freqs <= fmax if freqs is not None else None

    def _spec_panel(Sx, label):
        nonlocal row
        ax = axes[row]; row += 1
        mag_db = 20 * np.log10(np.abs(Sx) + eps)
        t = times if times is not None and len(times) == mag_db.shape[1] \
            else np.arange(mag_db.shape[1])
        im = ax.pcolormesh(t, freqs[fmask], mag_db[fmask, :], shading="auto")
        ax.set_ylabel("Freq [Hz]")
        ax.set_title(f"{label} [dB]", fontsize=9)
        fig.colorbar(im, ax=ax, label="dB")

    if S is not None:
        _spec_panel(S, "Original spectrogram")
    if S_hat is not None:
        _spec_panel(S_hat, "Denoised spectrogram")
    if noise_psd is not None:
        ax = axes[row]; row += 1
        nd = 10 * np.log10(noise_psd + eps)
        t = times if times is not None and len(times) == nd.shape[1] \
            else np.arange(nd.shape[1])
        fr = freqs if freqs is not None and len(freqs) == nd.shape[0] \
            else np.arange(nd.shape[0])
        fm = fr <= fmax
        im = ax.pcolormesh(t, fr[fm], nd[fm, :], shading="auto")
        ax.set_ylabel("Freq [Hz]")
        ax.set_xlabel("Time [s]")
        ax.set_title("Estimated noise PSD [dB]", fontsize=9)
        fig.colorbar(im, ax=ax, label="dB")

    if G is not None:
        _heat_or_line(fig, axes[row], G, times, "Gain G", "Gain", freqs)
        row += 1
    if P_band is not None:
        _heat_or_line(fig, axes[row], P_band, times,
                      "Signal band power P_band_all", "Power", freqs_band)
        row += 1
    if N_band is not None:
        _heat_or_line(fig, axes[row], N_band, times,
                      "Noise band power N_band_all", "Power", freqs_band)
        row += 1

    fig.tight_layout()
    return fig


def plot_frame_classifier_debug(det_debug: Dict[str, Any],
                                times: Optional[np.ndarray] = None,
                                audio: Optional[np.ndarray] = None,
                                sr: Optional[int] = None,
                                operating_band: Optional[Tuple[float, float]] = None,
                                title: str = "Frame classifier"):
    """Waveform / score+label+PSD-markers / flux / TD / gates / decision
    (``visualize_noise_output.py:241-393``)."""
    import matplotlib.pyplot as plt

    df = frames_to_df(det_debug, times)
    x = df["time_s"] if "time_s" in df else np.arange(len(df))
    audio = _host(audio)

    with_audio = audio is not None and sr is not None
    n_rows = 5 + int(with_audio)
    fig, axes = plt.subplots(n_rows, 1, figsize=(11, 2.4 * n_rows),
                             sharex=with_audio is False)
    axes = np.atleast_1d(axes)
    row = 0

    if with_audio:
        t_audio = np.arange(len(audio)) / float(sr)
        axes[row].plot(t_audio, audio, linewidth=0.6)
        axes[row].set_title(f"{title}: audio", fontsize=9)
        row += 1

    # score / label with PSD-update markers
    ax = axes[row]; row += 1
    if "rain_conf" in df:
        ax.plot(x, df["rain_conf"], label="rain_conf", linewidth=0.8)
    if "noise_conf" in df:
        ax.plot(x, df["noise_conf"], label="noise_conf", linewidth=0.8,
                alpha=0.7)
    if "frame_class" in df:
        ax.plot(x, df["frame_class"] / 2.0, label="label (0/0.5/1)",
                linewidth=0.8, alpha=0.7)
    psd_key = "use_for_noise_psd" if "use_for_noise_psd" in df else None
    if psd_key and "rain_conf" in df:
        m = df[psd_key].astype(bool).to_numpy()
        ax.plot(np.asarray(x)[m], df["rain_conf"].to_numpy()[m], "x",
                markersize=5, label="use_for_noise_psd")
    ax.set_ylim(-0.1, 1.1)
    ax.legend(fontsize=7)
    band_txt = (f" (operating_band={operating_band[0]:.0f}-"
                f"{operating_band[1]:.0f} Hz)" if operating_band else "")
    ax.set_title(f"{title}: score / label{band_txt}", fontsize=9)

    # mode-flux evidence
    ax = axes[row]; row += 1
    for key in ("primary_mode_flux", "support_mode_flux_1",
                "support_mode_flux_2", "support_mode_flux_3"):
        if key in df:
            ax.plot(x, np.log1p(np.maximum(df[key], 0)), label=key,
                    linewidth=0.8)
    ax.legend(fontsize=7)
    ax.set_title("normalized mode flux (log1p)", fontsize=9)

    # TD features
    ax = axes[row]; row += 1
    for key in ("td_crest_factor", "td_kurtosis", "td_block_energy_crest"):
        if key in df:
            ax.plot(x, df[key], label=key, linewidth=0.8)
    ax.legend(fontsize=7)
    ax.set_title("TD features", fontsize=9)

    # gate tracks (0/1)
    ax = axes[row]; row += 1
    for key in ("td_gate_mask", "peak_gate_score", "peak_valid_count"):
        if key in df:
            v = df[key].astype(float)
            vmax = max(float(v.max()), 1.0)
            ax.step(x, v / vmax, where="mid", label=key, linewidth=0.8)
    ax.set_ylim(-0.1, 1.1)
    ax.legend(fontsize=7)
    ax.set_title("gates", fontsize=9)

    # decision
    ax = axes[row]; row += 1
    if "frame_class" in df:
        ax.step(x, df["frame_class"], where="mid", label="frame_class")
    if "rain_conf" in df:
        ax.plot(x, df["rain_conf"], alpha=0.6, label="rain_conf")
    ax.set_ylim(-0.1, 2.2)
    ax.legend(fontsize=7)
    ax.set_title("decision (0=noise 1=uncertain 2=rain)", fontsize=9)
    ax.set_xlabel("time (s)")
    fig.tight_layout()
    return fig


def plot_frame_classifier_tuning(det_debug: Dict[str, Any],
                                 thresholds: Optional[Dict[str, float]] = None,
                                 times: Optional[np.ndarray] = None,
                                 audio: Optional[np.ndarray] = None,
                                 sr: Optional[int] = None,
                                 t0: Optional[float] = None,
                                 t1: Optional[float] = None,
                                 title: str = "Frame Classifier Tuning"):
    """Tuning dashboard: confidence + threshold overlays + windowing +
    per-mode flux-vs-threshold (``visualize_noise_output.py:395-639``)."""
    import matplotlib.pyplot as plt

    thresholds = thresholds or {
        "new_rain_primary_flux_min": 1.8,
        "new_rain_mode1_flux_min": 2.6,
        "new_rain_mode2_flux_min": 2.6,
        "new_rain_mode3_flux_min": 3.0,
        "rain_hi": 0.6,
        "noise_hi": 0.8,
    }
    df = frames_to_df(det_debug, times)
    x = np.asarray(df["time_s"] if "time_s" in df else np.arange(len(df)),
                   float)
    audio = _host(audio)

    # time window (reference t0/t1 args)
    lo = float(t0) if t0 is not None else (x[0] if len(x) else 0.0)
    hi = float(t1) if t1 is not None else (x[-1] if len(x) else 0.0)
    m = (x >= lo) & (x <= hi)
    dfw, xw = df.loc[m], x[m]

    names = [
        ("primary_mode_flux_gated", "new_rain_primary_flux_min"),
        ("support_mode_flux_1_gated", "new_rain_mode1_flux_min"),
        ("support_mode_flux_2_gated", "new_rain_mode2_flux_min"),
        ("support_mode_flux_3_gated", "new_rain_mode3_flux_min"),
    ]
    with_audio = audio is not None and sr is not None
    n_rows = 1 + len(names) + int(with_audio)
    fig, axes = plt.subplots(n_rows, 1, figsize=(11, 2.2 * n_rows),
                             sharex=with_audio is False)
    axes = np.atleast_1d(axes)
    row = 0

    if with_audio:
        t_audio = np.arange(len(audio)) / float(sr)
        ma = (t_audio >= lo) & (t_audio <= hi)
        axes[row].plot(t_audio[ma], audio[ma], linewidth=0.6)
        axes[row].set_title(f"{title}: audio", fontsize=9)
        row += 1

    # confidence + threshold overlays + PSD-update markers
    ax = axes[row]; row += 1
    if "rain_conf" in dfw:
        ax.plot(xw, dfw["rain_conf"], label="rain_conf", linewidth=0.8)
    if "noise_conf" in dfw:
        ax.plot(xw, dfw["noise_conf"], label="noise_conf", linewidth=0.8,
                alpha=0.7)
    if "use_for_noise_psd" in dfw and "rain_conf" in dfw:
        mm = dfw["use_for_noise_psd"].astype(bool).to_numpy()
        ax.plot(xw[mm], dfw["rain_conf"].to_numpy()[mm], "x", markersize=5,
                label="use_for_noise_psd")
    if thresholds.get("rain_hi") is not None:
        ax.axhline(thresholds["rain_hi"], color="r", linestyle="--",
                   linewidth=0.8, label="rain_hi")
    if thresholds.get("noise_hi") is not None:
        ax.axhline(1.0 - thresholds["noise_hi"], color="g", linestyle=":",
                   linewidth=0.8, label="1-noise_hi")
    ax.set_ylim(-0.1, 1.1)
    ax.legend(fontsize=7)
    ax.set_title(f"{title}: confidence", fontsize=9)

    for col, thr_key in names:
        ax = axes[row]; row += 1
        if col in dfw:
            ax.plot(xw, np.log1p(np.maximum(dfw[col], 0)), linewidth=0.8)
        thr = thresholds.get(thr_key)
        if thr is not None:
            ax.axhline(thr, color="r", linestyle="--", linewidth=0.8)
        ax.set_title(f"{col} (thr {thr})", fontsize=8)
    axes[-1].set_xlabel("time (s)")
    fig.tight_layout()
    return fig


def plot_noise_suppressor_debug(debug: Dict[str, Any],
                                times: Optional[np.ndarray] = None,
                                operating_band: Optional[Tuple[float, float]] = None,
                                title: str = "Noise suppressor debug"):
    """Suppressor internals: G / P_band_all / N_band_all heat-or-line rows +
    PSD-update gating (``visualize_noise_output.py:641-727``)."""
    import matplotlib.pyplot as plt

    G = _host(debug.get("G"))
    P_band = _host(debug.get("P_band_all"))
    N_band = _host(debug.get("N_band_all"))
    used = _host(debug.get("use_for_noise_psd"))
    freqs_band = _host(debug.get("freqs_band"))
    times = _host(times)

    rows = [r for r in (
        ("Gain G", G, "Gain", None),
        ("Signal band power P_band_all", P_band, "Power", freqs_band),
        ("Noise band power N_band_all", N_band, "Power", freqs_band),
        ("frames used for PSD update", used, "used", None),
    ) if r[1] is not None]
    if not rows:
        fig, ax = plt.subplots(figsize=(8, 2))
        ax.text(0.5, 0.5,
                "No suppressor debug arrays found (G/P_band_all/N_band_all).",
                ha="center", va="center")
        ax.set_title(title)
        return fig

    if operating_band is not None:
        title = (f"{title} (operating_band={operating_band[0]:.0f}-"
                 f"{operating_band[1]:.0f} Hz)")
    fig, axes = plt.subplots(len(rows), 1, figsize=(11, 2.6 * len(rows)),
                             sharex=True)
    axes = np.atleast_1d(axes)
    for ax, (name, data, ylabel, fr) in zip(axes, rows):
        if name.startswith("frames used"):
            arr = data.astype(int)
            x = times if times is not None and len(times) == len(arr) \
                else np.arange(len(arr))
            ax.step(x, arr, where="mid")
            ax.set_title(name, fontsize=9)
        else:
            _heat_or_line(fig, ax, data, times, name, ylabel, fr)
    axes[0].set_title(f"{title}\n{rows[0][0]}", fontsize=9)
    axes[-1].set_xlabel("time (s)")
    fig.tight_layout()
    return fig
