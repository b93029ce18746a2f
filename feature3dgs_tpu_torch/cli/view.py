"""Viewer server: serve a trained model to the SIBR remote viewer.

    python -m feature3dgs_tpu_torch.cli.view -m <model_path> [--iteration N]
        [--ip 127.0.0.1] [--port 6009] [--device cpu]

The port of ``scripts/view.py`` (the original view.py:9-35), with its
flags: loads ``point_cloud/iteration_N/point_cloud.ply`` (the newest by
default) and answers the SIBR protocol (``viewer/network_gui.py``), one
frame a camera message, rendered and post-processed on the CUDA card
(``--device cpu`` for the plain versions). Runs until interrupted.
"""
from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import torch


def build_parser() -> ArgumentParser:
    from feature3dgs_tpu_torch import config as C
    parser = ArgumentParser(description="Viewing script parameters (PyTorch)")
    C.add_model_args(parser)
    C.add_pipeline_args(parser)
    C.add_raster_args(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    return parser


def load_model(mcfg, iteration: int, device):
    """(params, state, bg) of ``point_cloud/iteration_N`` (-1: the newest)."""
    from feature3dgs_tpu_torch.model.ply_io import load_gaussians_ply
    if iteration == -1:
        pc_dir = os.path.join(mcfg.model_path, "point_cloud")
        iteration = max(int(d.split("_")[-1]) for d in os.listdir(pc_dir))
    params, state = load_gaussians_ply(
        os.path.join(mcfg.model_path, "point_cloud", f"iteration_{iteration}",
                     "point_cloud.ply"),
        max_sh_degree=mcfg.sh_degree, device=device)
    bg = torch.tensor([1.0, 1.0, 1.0] if mcfg.white_background
                      else [0.0, 0.0, 0.0], device=device)
    return params, state, bg


def serve(gui, render_fn, source_path: str, n_gaussians: int, device,
          stop=None):
    """Answer viewer clients on ``gui`` until ``stop`` (a threading.Event)
    is set: one frame (``network_gui.render_frame``) a camera message, the
    Gaussian count as the metrics; a dropped client is let go and the next
    one awaited."""
    from feature3dgs_tpu_torch.render.modes import RENDER_ITEMS
    from feature3dgs_tpu_torch.viewer.network_gui import render_frame
    with torch.inference_mode():
        while stop is None or not stop.is_set():
            if gui.conn is None:
                gui.try_connect(list(RENDER_ITEMS), wait=0.2)
                continue
            try:
                cam = gui.receive()
                frame = (render_frame(render_fn, cam, device)
                         if cam is not None else None)
                gui.send(frame, source_path, {"#": n_gaussians, "loss": 0.0})
            except (ConnectionError, OSError):
                gui.disconnect()


def main(argv=None) -> int:
    from feature3dgs_tpu_torch import config as C
    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.render import renderer
    from feature3dgs_tpu_torch.viewer.network_gui import NetworkGUI
    args = C.combine_with_saved(build_parser(), argv)
    device = default_device(args.device)
    mcfg = C.extract_model(args)
    rcfg = C.extract_raster(args)
    params, state, bg = load_model(mcfg, args.iteration, device)

    def render_fn(view, scaling_modifier):
        return renderer.render(params, state, view, bg=bg, config=rcfg,
                               scaling_modifier=scaling_modifier)

    gui = NetworkGUI(args.ip, args.port)
    print(f"Serving {state.num_active} gaussians on {args.ip}:{args.port}")
    serve(gui, render_fn, mcfg.source_path, state.num_active, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
