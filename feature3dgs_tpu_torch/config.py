"""Command-line flags and ``cfg_args`` merging for the train and render
CLIs.

Port of ``feature3dgs_tpu/config.py``: the model, pipeline, optimization
and rasterizer flag groups with the same names, shorthands and defaults,
and ``combine_with_saved``, which fills flags left at their defaults from
``<model_path>/cfg_args`` — the JSON either trainer writes, or the original
code's repr'd ``Namespace(...)``. Keys of ``cfg_args`` that no flag here
names (TPU-only rasterizer settings) are ignored; ``--tile_capacity``,
``--bwd_chunk`` and ``--matmul_precision`` are accepted so that the JAX
scripts' command lines parse, and select nothing. ``--alpha_matmul`` is this
package's own flag: it switches both compositing kernels to their
alpha_matmul mode (``RasterConfig.alpha_matmul``).
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re
from typing import Any

from feature3dgs_tpu_torch.model.optim import LRConfig
from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
from feature3dgs_tpu_torch.train.trainer import OptimizationConfig


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


@dataclasses.dataclass
class PipelineConfig:
    """PipelineParams (the original arguments/__init__.py:67-72). The flags
    are accepted and recorded; this package has one formulation of each
    stage, so they select nothing."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


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
    """The original pipeline flags; neither CLI reads them, but saved
    configs and scripts pass them."""
    g = parser.add_argument_group("Pipeline Parameters")
    g.add_argument("--convert_SHs_python", action="store_true")
    g.add_argument("--compute_cov3D_python", action="store_true")
    g.add_argument("--debug", action="store_true")


def add_optimization_args(parser: argparse.ArgumentParser):
    g = parser.add_argument_group("Optimization Parameters")
    o, lr = OptimizationConfig(), LRConfig()
    g.add_argument("--iterations", type=int, default=o.iterations)
    for name in ("position_lr_init", "position_lr_final",
                 "position_lr_delay_mult"):
        g.add_argument(f"--{name}", type=float, default=getattr(lr, name))
    g.add_argument("--position_lr_max_steps", type=int,
                   default=lr.position_lr_max_steps)
    for name in ("feature_lr", "opacity_lr", "scaling_lr", "rotation_lr",
                 "semantic_feature_lr"):
        g.add_argument(f"--{name}", type=float, default=getattr(lr, name))
    g.add_argument("--percent_dense", type=float, default=o.percent_dense)
    g.add_argument("--lambda_dssim", type=float, default=o.lambda_dssim)
    for name in ("densification_interval", "opacity_reset_interval",
                 "densify_from_iter", "densify_until_iter"):
        g.add_argument(f"--{name}", type=int, default=getattr(o, name))
    g.add_argument("--densify_grad_threshold", type=float,
                   default=o.densify_grad_threshold)


def add_raster_args(parser: argparse.ArgumentParser):
    g = parser.add_argument_group("Rasterizer Parameters")
    r = RasterConfig()
    g.add_argument("--tile_size", type=int, default=None,
                   help="square tile override (sets both tile_w and tile_h)")
    g.add_argument("--tile_w", type=int, default=r.tile_w)
    g.add_argument("--tile_h", type=int, default=r.tile_h)
    g.add_argument("--chunk", type=int, default=r.chunk)
    g.add_argument("--bwd_chunk", type=int, default=64,
                   help="accepted and ignored: the backward kernel walks "
                        "its own chunk of 32 entries")
    g.add_argument("--instance_capacity", type=int, default=r.instance_capacity)
    # scripts/render.py's flag; rendering here never truncates a tile list
    g.add_argument("--tile_capacity", type=int, default=1 << 12)
    g.add_argument("--matmul_precision", type=str, default="highest",
                   choices=["highest", "high", "default"],
                   help="accepted and ignored: every product here keeps f32 "
                        "accuracy (3xTF32 in the kernels, TF32 off elsewhere)")
    g.add_argument("--alpha_matmul", action="store_true",
                   help="evaluate the Gaussian exponent as a six-term dot "
                        "over tile-local monomials in both kernels "
                        "(RasterConfig.alpha_matmul)")


def extract_model(args) -> ModelConfig:
    return ModelConfig(
        sh_degree=args.sh_degree,
        source_path=os.path.abspath(args.source_path) if args.source_path else "",
        foundation_model=args.foundation_model, model_path=args.model_path,
        images=args.images, resolution=args.resolution,
        white_background=args.white_background, eval=args.eval,
        speedup=args.speedup)


def extract_pipeline(args) -> PipelineConfig:
    return PipelineConfig(convert_SHs_python=args.convert_SHs_python,
                          compute_cov3D_python=args.compute_cov3D_python,
                          debug=args.debug)


def extract_optimization(args) -> OptimizationConfig:
    lr_names = [f.name for f in dataclasses.fields(LRConfig)
                if f.name != "position_lr_delay_steps"]
    return OptimizationConfig(
        iterations=args.iterations,
        lr=LRConfig(**{k: getattr(args, k) for k in lr_names}),
        percent_dense=args.percent_dense, lambda_dssim=args.lambda_dssim,
        densification_interval=args.densification_interval,
        opacity_reset_interval=args.opacity_reset_interval,
        densify_from_iter=args.densify_from_iter,
        densify_until_iter=args.densify_until_iter,
        densify_grad_threshold=args.densify_grad_threshold)


def extract_raster(args) -> RasterConfig:
    tile_size = getattr(args, "tile_size", None)
    return RasterConfig(
        tile_w=tile_size or args.tile_w, tile_h=tile_size or args.tile_h,
        chunk=args.chunk, instance_capacity=args.instance_capacity,
        alpha_matmul=bool(getattr(args, "alpha_matmul", False)))


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
