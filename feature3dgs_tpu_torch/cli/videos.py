"""Assemble mp4 videos from rendered frame folders.

    python -m feature3dgs_tpu_torch.cli.videos -m <model_path>
        [--iteration N] [--fps 30] [--sets video novel_views]
        [--kinds renders feature_map]

The port of ``scripts/videos.py`` (the original videos.py:35-91): for each
``<model_path>/<set>/ours_<N>/<kind>/`` with frames, the PNGs in sorted
order through cv2's mp4v writer into
``<model_path>/<set>_ours_<N>_<kind>.mp4``. Host-only: it reads files the
render CLI wrote.
"""
from __future__ import annotations

import os
import sys
from argparse import ArgumentParser


def frames_to_video(frame_dir: str, out_path: str, fps: int = 30,
                    suffix: str = ".png"):
    import cv2
    names = sorted(n for n in os.listdir(frame_dir) if n.endswith(suffix))
    if not names:
        raise FileNotFoundError(f"no {suffix} frames in {frame_dir}")
    first = cv2.imread(os.path.join(frame_dir, names[0]))
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
    for n in names:
        writer.write(cv2.imread(os.path.join(frame_dir, n)))
    writer.release()
    print(f"{len(names)} frames -> {out_path}")


def main(argv=None) -> int:
    parser = ArgumentParser()
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--fps", type=int, default=30)
    parser.add_argument("--sets", nargs="+",
                        default=["video", "novel_views"])
    parser.add_argument("--kinds", nargs="+",
                        default=["renders", "feature_map"])
    args = parser.parse_args(argv)

    it = args.iteration
    for set_name in args.sets:
        base = os.path.join(args.model_path, set_name)
        if not os.path.isdir(base):
            continue
        for ours in sorted(os.listdir(base)):
            if it != -1 and not ours.endswith(str(it)):
                continue
            for kind in args.kinds:
                d = os.path.join(base, ours, kind)
                if os.path.isdir(d) and os.listdir(d):
                    frames_to_video(
                        d, os.path.join(args.model_path,
                                        f"{set_name}_{ours}_{kind}.mp4"),
                        args.fps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
