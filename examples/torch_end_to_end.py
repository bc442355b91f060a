"""End-to-end tour with the PyTorch port: synth corpus -> framework run ->
evaluation -> dashboards.

Counterpart of ``examples/end_to_end.py``.  Covers the workflow a reference
(``Arable/audio_processing_tools``) user runs daily: build a labeled
test-vector corpus, push it through ``process_audio_batches_v2`` with the
flagship detector, split FP/FN with the evaluation harness, and render the
engine-debug dashboards.  It needs pandas and matplotlib, so it runs where
they are installed:

    python examples/torch_end_to_end.py /tmp/apt_demo [--device cpu]

(the card by default; under a minute on the CPU).
"""

import argparse
import os
import sys

# allow running from a source checkout without installing
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(out_dir: str = "/tmp/apt_demo", device: str = "cuda") -> None:
    from audio_processing_tools_tpu_torch.config import DEFAULT_MODE_BANDS
    from audio_processing_tools_tpu_torch.evaluation import evaluate_corpus
    from audio_processing_tools_tpu_torch.framework import process_audio_batches_v2
    from audio_processing_tools_tpu_torch.models.spectral_noise import (
        RainDetectorProcessor,
        SpectralNoiseEngine,
    )
    from audio_processing_tools_tpu_torch.utils.corpus import (
        make_labeled_corpus,
        write_corpus_dir,
    )
    from audio_processing_tools_tpu_torch.viz import (
        plot_frame_classifier_debug,
        show_noise_processing_results,
    )

    os.makedirs(out_dir, exist_ok=True)
    corpus_dir = os.path.join(out_dir, "corpus")

    # 1) deterministic labeled corpus (rain / noise / wind / tonal)
    clips, labels, kinds = make_labeled_corpus(seed=7, seconds=2.0)
    write_corpus_dir(corpus_dir, clips, labels, kinds)
    print(f"corpus: {len(clips)} clips -> {corpus_dir}")

    # 2) batch run through the framework (device-batched detector)
    proc = RainDetectorProcessor(name="rain_detector", device=device)
    results, states = process_audio_batches_v2(
        processors=[proc],
        params_global={
            "sample_rate": 11162, "check_duration": 2.0,
            "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
            "clip_rain_min_frames": 3,
        },
        InputType="LocalPath", test_vector_path=corpus_dir,
        batch_save_dir=None,
    )
    print(f"processed {len(results)} files at "
          f"{results.attrs['files_per_sec_total']:.1f} files/s on {device}")

    # 3) accuracy + reference-shaped FP/FN CSVs
    stats = evaluate_corpus(
        results, predicted_col="rain_detector__clip_is_rain",
        actual_col="rain_actual", out_dir=out_dir,
    )
    print("accuracy:", stats)

    # 4) engine-debug dashboards for one rain clip
    import matplotlib

    matplotlib.use("Agg")
    eng = SpectralNoiseEngine(device=device)
    eng.setup({
        "sample_rate": 11162,
        "detector": {"mode_bands": list(DEFAULT_MODE_BANDS)},
        "return_debug": True, "return_detector_debug": True,
        "return_noise_psd": True, "return_spectra": True,
        "compute_output_audio": True, "return_filtered_audio": True,
    })
    out = eng.process(clips[0])
    fig = show_noise_processing_results(out, 11162, play_audio=False)
    fig.savefig(os.path.join(out_dir, "overview.png"), dpi=80)
    fig2 = plot_frame_classifier_debug(out["det_debug"], out["times"],
                                       audio=clips[0], sr=11162)
    fig2.savefig(os.path.join(out_dir, "classifier_debug.png"), dpi=80)
    print(f"dashboards -> {out_dir}/overview.png, classifier_debug.png")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Corpus -> framework -> evaluation -> dashboards.")
    ap.add_argument("out_dir", nargs="?", default="/tmp/apt_demo")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    main(args.out_dir, args.device)
