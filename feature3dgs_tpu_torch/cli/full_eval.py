"""Full-evaluation CLI: train, render and score the standard scene lists.

    python -m feature3dgs_tpu_torch.cli.full_eval -m360 <dir> -tat <dir> \\
        -db <dir> [--output_path ./eval]

The port of ``scripts/full_eval.py`` (the original full_eval.py:15-75),
with its scene lists and flags: MipNeRF360 (outdoor scenes at images_4,
indoor at images_2), Tanks and Temples, Deep Blending; each scene through
the port's train and render CLIs, then the metrics CLI over all of them,
each as a subprocess. They run on the card (``--device cpu`` passes the
CPU on to each).
"""
from __future__ import annotations

import os
import subprocess
import sys
from argparse import ArgumentParser

MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]


def run(cmd):
    print("+", " ".join(cmd), flush=True)
    subprocess.check_call(cmd)


def scene_list(args) -> list:
    """(source path, extra train arguments) of every scene asked for."""
    scenes = []
    if args.mipnerf360:
        scenes += [(os.path.join(args.mipnerf360, s), ["-i", "images_4"])
                   for s in MIPNERF360_OUTDOOR]
        scenes += [(os.path.join(args.mipnerf360, s), ["-i", "images_2"])
                   for s in MIPNERF360_INDOOR]
    if args.tanksandtemples:
        scenes += [(os.path.join(args.tanksandtemples, s), [])
                   for s in TANKS_AND_TEMPLES]
    if args.deepblending:
        scenes += [(os.path.join(args.deepblending, s), [])
                   for s in DEEP_BLENDING]
    return scenes


def main(argv=None):
    parser = ArgumentParser(description="Train, render and score the "
                                        "standard scenes (PyTorch)")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--mipnerf360", "-m360", default=None)
    parser.add_argument("--tanksandtemples", "-tat", default=None)
    parser.add_argument("--deepblending", "-db", default=None)
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--foundation_model", "-f", default="lseg")
    parser.add_argument("--iterations", type=int, default=30_000)
    parser.add_argument("--device", default=None,
                        help="torch device of every step (default: the "
                             "CUDA card)")
    args = parser.parse_args(argv)

    from feature3dgs_tpu_torch import default_device
    device = str(default_device(args.device))

    cli = lambda name: [sys.executable, "-m", f"feature3dgs_tpu_torch.cli.{name}"]
    dev = ["--device", device]
    model_paths = []
    for source, extra in scene_list(args):
        model_path = os.path.join(args.output_path, os.path.basename(source))
        model_paths.append(model_path)
        common = ["-s", source, "-m", model_path, "-f",
                  args.foundation_model, "--eval"]
        if not args.skip_training:
            run([*cli("train"), *common, *extra, "--iterations",
                 str(args.iterations), "--quiet", "--disable_viewer",
                 "--test_iterations", str(args.iterations), *dev])
        if not args.skip_rendering:
            run([*cli("render"), *common, "--iteration",
                 str(args.iterations), "--skip_train", *dev])
    if not args.skip_metrics and model_paths:
        run([*cli("metrics"), "-m", *model_paths, *dev])
    return 0


if __name__ == "__main__":
    sys.exit(main())
