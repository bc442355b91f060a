"""MARK header inspection CLI (parity with reference ``test_header_parser.py``).

Counterpart of ``audio_processing_tools_tpu/cli/header_parser.py``, with
the same output.  Parses one ``.bin`` file or every ``.bin`` in a folder and
prints the 40-byte header fields.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from audio_processing_tools_tpu_torch.io.mark import MarkHeaderError, parse_mark_header


def print_header(path: Path) -> None:
    try:
        hdr = parse_mark_header(path.read_bytes())
    except MarkHeaderError as e:
        print(f"{path}: BAD HEADER ({e})")
        return
    payload = hdr.pop("audio")
    print(f"{path}:")
    for k, v in hdr.items():
        print(f"  {k}: {v}")
    print(f"  payload_bytes: {len(payload)}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help=".bin file or folder of .bin files")
    args = ap.parse_args(argv)
    p = Path(args.path)
    if p.is_dir():
        for f in sorted(p.rglob("*.bin")):
            print_header(f)
    else:
        print_header(p)


if __name__ == "__main__":
    main()
