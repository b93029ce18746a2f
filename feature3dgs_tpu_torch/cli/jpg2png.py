"""Convert a directory of JPGs to PNGs: a copy of ``scripts/jpg2png.py``.

    python -m feature3dgs_tpu_torch.cli.jpg2png -i <dir> [-o <dir>] [--delete]

The counterpart of the original jpg2png.py helper (datasets shipped as .jpg,
the pipeline reading .png). It uses no framework; flags, file names and
messages are the script's.
"""
from __future__ import annotations

import os
import sys
from argparse import ArgumentParser


def main(argv=None):
    ap = ArgumentParser()
    ap.add_argument("--input", "-i", required=True, help="directory of .jpg")
    ap.add_argument("--output", "-o", default=None,
                    help="output directory (default: in place)")
    ap.add_argument("--delete", action="store_true",
                    help="remove the source .jpg after conversion")
    args = ap.parse_args(argv)

    from PIL import Image
    out_dir = args.output or args.input
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(args.input)):
        stem, ext = os.path.splitext(name)
        if ext.lower() not in (".jpg", ".jpeg"):
            continue
        src = os.path.join(args.input, name)
        Image.open(src).convert("RGB").save(
            os.path.join(out_dir, stem + ".png"))
        if args.delete:
            os.remove(src)
        n += 1
    print(f"converted {n} images -> {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
