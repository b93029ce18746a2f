"""Command-line flags and ``cfg_args`` merging for the render CLI.

Port of the part of ``feature3dgs_tpu/config.py`` that rendering uses: the
model, pipeline and rasterizer flag groups with the same names, shorthands
and defaults, and ``combine_with_saved``, which fills flags left at their
defaults from ``<model_path>/cfg_args`` — the JSON the JAX trainer writes,
or the original code's repr'd ``Namespace(...)``. Keys of ``cfg_args`` that
no flag here names (optimizer settings, TPU-only rasterizer settings) are
ignored.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re
from typing import Any

from feature3dgs_tpu_torch.ops.rasterize import RasterConfig


@dataclasses.dataclass
class ModelConfig:
    """ModelParams (the original arguments/__init__.py:47-65)."""

    sh_degree: int = 3
    source_path: str = ""          # -s
    foundation_model: str = ""     # -f: '', 'sam', 'lseg'
    model_path: str = ""           # -m
    images: str = "images"         # -i
    resolution: int = -1           # -r
    white_background: bool = False  # -w
    eval: bool = False
    speedup: bool = False


def add_model_args(parser: argparse.ArgumentParser):
    g = parser.add_argument_group("Loading Parameters")
    d = ModelConfig()
    g.add_argument("--sh_degree", type=int, default=d.sh_degree)
    g.add_argument("--source_path", "-s", type=str, default=d.source_path)
    g.add_argument("--foundation_model", "-f", type=str,
                   default=d.foundation_model)
    g.add_argument("--model_path", "-m", type=str, default=d.model_path)
    g.add_argument("--images", "-i", type=str, default=d.images)
    g.add_argument("--resolution", "-r", type=int, default=d.resolution)
    g.add_argument("--white_background", "-w", action="store_true")
    g.add_argument("--eval", action="store_true")
    g.add_argument("--speedup", action="store_true")


def add_pipeline_args(parser: argparse.ArgumentParser):
    """The original pipeline flags; rendering reads none of them, but saved
    configs and scripts pass them."""
    g = parser.add_argument_group("Pipeline Parameters")
    g.add_argument("--convert_SHs_python", action="store_true")
    g.add_argument("--compute_cov3D_python", action="store_true")
    g.add_argument("--debug", action="store_true")


def add_raster_args(parser: argparse.ArgumentParser):
    g = parser.add_argument_group("Rasterizer Parameters")
    r = RasterConfig()
    g.add_argument("--tile_size", type=int, default=None,
                   help="square tile override (sets both tile_w and tile_h)")
    g.add_argument("--tile_w", type=int, default=r.tile_w)
    g.add_argument("--tile_h", type=int, default=r.tile_h)
    g.add_argument("--chunk", type=int, default=r.chunk)
    g.add_argument("--instance_capacity", type=int, default=r.instance_capacity)
    # scripts/render.py's flag; rendering here never truncates a tile list
    g.add_argument("--tile_capacity", type=int, default=1 << 12)


def extract_model(args) -> ModelConfig:
    return ModelConfig(
        sh_degree=args.sh_degree,
        source_path=os.path.abspath(args.source_path) if args.source_path else "",
        foundation_model=args.foundation_model, model_path=args.model_path,
        images=args.images, resolution=args.resolution,
        white_background=args.white_background, eval=args.eval,
        speedup=args.speedup)


def extract_raster(args) -> RasterConfig:
    tile_size = getattr(args, "tile_size", None)
    return RasterConfig(
        tile_w=tile_size or args.tile_w, tile_h=tile_size or args.tile_h,
        chunk=args.chunk, instance_capacity=args.instance_capacity)


def parse_saved_namespace(text: str) -> dict:
    """Parse a JSON cfg_args or the original repr'd ``Namespace(k=v, ...)``."""
    text = text.strip()
    if text.startswith("{"):
        return json.loads(text)
    m = re.match(r"Namespace\((.*)\)$", text, re.S)
    if not m:
        raise ValueError("unrecognized cfg_args format")
    parts, depth, cur = [], 0, ""
    for ch in m.group(1):
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        parts.append(cur)
    out: dict[str, Any] = {}
    for part in parts:
        k, _, v = part.partition("=")
        try:
            out[k.strip()] = ast.literal_eval(v.strip())
        except (ValueError, SyntaxError):
            out[k.strip()] = v.strip()
    return out


def combine_with_saved(parser: argparse.ArgumentParser, argv=None):
    """Values from <model_path>/cfg_args for flags left at their defaults
    (the original get_combined_args, arguments/__init__.py:97-117)."""
    args = parser.parse_args(argv)
    cfg_path = os.path.join(args.model_path, "cfg_args")
    if args.model_path and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            saved = parse_saved_namespace(f.read())
        defaults = {a.dest: parser.get_default(a.dest) for a in parser._actions}
        for k, v in saved.items():
            if hasattr(args, k) and getattr(args, k) == defaults.get(k):
                setattr(args, k, v)
    return args
