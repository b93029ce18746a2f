"""COLMAP dataset conversion: a copy of ``scripts/convert.py``.

    python -m feature3dgs_tpu_torch.cli.convert -s <scene> [--no_gpu]
        [--skip_matching] [--camera OPENCV] [--colmap_executable PATH]
        [--resize]

The counterpart of the original convert.py:31-124: feature extraction,
matching, mapping and undistortion of ``<scene>/input`` through the COLMAP
binary, the sparse model moved into ``<scene>/sparse/0``, and with
``--resize`` 1/2, 1/4 and 1/8 image pyramids (PIL's LANCZOS). It uses no
framework; the flags, COLMAP command lines, output tree and messages are
the script's.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from argparse import ArgumentParser


def run(cmd):
    print("+", " ".join(cmd))
    rc = subprocess.call(cmd)
    if rc != 0:
        print(f"command failed with code {rc}. Exiting.")
        sys.exit(rc)


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--camera", default="OPENCV")
    parser.add_argument("--colmap_executable", default="")
    parser.add_argument("--resize", action="store_true")
    args = parser.parse_args(argv)

    colmap = args.colmap_executable or shutil.which("colmap")
    if not colmap:
        sys.exit("COLMAP binary not found; install COLMAP or pass "
                 "--colmap_executable (convert.py requires it, like the "
                 "reference README.md:486-492)")
    use_gpu = "0" if args.no_gpu else "1"
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted/sparse"), exist_ok=True)
        run([colmap, "feature_extractor",
             "--database_path", f"{src}/distorted/database.db",
             "--image_path", f"{src}/input",
             "--ImageReader.single_camera", "1",
             "--ImageReader.camera_model", args.camera,
             "--SiftExtraction.use_gpu", use_gpu])
        run([colmap, "exhaustive_matcher",
             "--database_path", f"{src}/distorted/database.db",
             "--SiftMatching.use_gpu", use_gpu])
        run([colmap, "mapper",
             "--database_path", f"{src}/distorted/database.db",
             "--image_path", f"{src}/input",
             "--output_path", f"{src}/distorted/sparse",
             "--Mapper.ba_global_function_tolerance=0.000001"])

    run([colmap, "image_undistorter",
         "--image_path", f"{src}/input",
         "--input_path", f"{src}/distorted/sparse/0",
         "--output_path", src, "--output_type", "COLMAP"])

    sparse_dir = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse_dir, "0"), exist_ok=True)
    for f in os.listdir(sparse_dir):
        if f != "0":
            shutil.move(os.path.join(sparse_dir, f),
                        os.path.join(sparse_dir, "0", f))

    if args.resize:
        from PIL import Image
        for factor, name in ((2, "images_2"), (4, "images_4"), (8, "images_8")):
            out_dir = os.path.join(src, name)
            os.makedirs(out_dir, exist_ok=True)
            for fname in os.listdir(os.path.join(src, "images")):
                img = Image.open(os.path.join(src, "images", fname))
                img.resize((img.width // factor, img.height // factor),
                           Image.LANCZOS).save(os.path.join(out_dir, fname))
    print("Done.")


if __name__ == "__main__":
    main()
