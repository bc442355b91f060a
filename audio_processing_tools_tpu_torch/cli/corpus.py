"""Synthesize a labeled test-vector corpus of MARK container files.

Counterpart of ``audio_processing_tools_tpu/cli/corpus.py``: the same flags
write the same bytes.  The reference's test strategy runs classifiers over labeled "test vector"
directories (True/False in filenames — reference ``audio_io.py:218-225``);
this tool manufactures such corpora deterministically for smoke tests,
tuning dry-runs, and CI:

    python -m audio_processing_tools_tpu_torch.cli.corpus --out ./test_vectors \\
        --seed 7 --seconds 2 --rain-heavy 6 --noise 6 --wind 4
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    from audio_processing_tools_tpu_torch.utils.corpus import (
        CLIP_CLASSES,
        make_labeled_corpus,
        write_corpus_dir,
    )

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fs", type=int, default=11162)
    ap.add_argument("--alac", action="store_true",
                    help="write ALAC (file_version=1) containers")
    for kind in CLIP_CLASSES:
        ap.add_argument(f"--{kind.replace('_', '-')}", type=int, default=4,
                        dest=kind)
    args = ap.parse_args(argv)

    counts = {kind: getattr(args, kind) for kind in CLIP_CLASSES}
    clips, labels, kinds = make_labeled_corpus(
        seed=args.seed, fs=args.fs, seconds=args.seconds, counts=counts,
    )
    if args.alac:
        import os

        import numpy as np

        from audio_processing_tools_tpu_torch.io.mark import write_mark_audio_file

        os.makedirs(args.out, exist_ok=True)
        paths = []
        for i, (clip, raining) in enumerate(zip(clips, labels)):
            name = f"{kinds[i]}_{i:03d}_{'True' if raining else 'False'}.bin"
            pcm = (np.clip(clip, -1, 1) * 32767).astype(np.int16)
            p = os.path.join(args.out, name)
            with open(p, "wb") as f:
                f.write(write_mark_audio_file(
                    pcm, sample_rate=args.fs, timestamp=i, file_version=1))
            paths.append(p)
    else:
        paths = write_corpus_dir(args.out, clips, labels, kinds, fs=args.fs)

    print(json.dumps({
        "files": len(paths), "seconds": args.seconds, "seed": args.seed,
        "codec": "alac" if args.alac else "pcm", "counts": counts,
        "out": args.out,
    }))


if __name__ == "__main__":
    main()
