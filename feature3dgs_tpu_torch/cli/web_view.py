"""Browser viewer: interactive orbit viewing of a trained model.

    python -m feature3dgs_tpu_torch.cli.web_view -m <model_path>
        [--iteration N] [--ip 127.0.0.1] [--port 8090] [--device cpu]

then open http://127.0.0.1:8090 (port-forward when the model lives on a
remote machine). The port of ``scripts/web_view.py``, with its flags:
drag = orbit, wheel = zoom, shift-drag = pan; every render channel
(RGB/Depth/Edge/Normal/Curvature/Feature-PCA) and the Gaussian scaling
slider of the SIBR protocol. World-up comes from the model's
``cameras.json``. Frames render on the CUDA card (``--device cpu`` for the
plain versions).
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np


def build_parser():
    from feature3dgs_tpu_torch.cli.view import build_parser as view_parser
    parser = view_parser()
    parser.description = "Web viewer parameters (PyTorch)"
    parser.set_defaults(port=8090)
    return parser


def make_viewer(args, device):
    """The WebViewer of ``args``' model (not yet serving)."""
    from feature3dgs_tpu_torch import config as C
    from feature3dgs_tpu_torch.cli.view import load_model
    from feature3dgs_tpu_torch.render import renderer
    from feature3dgs_tpu_torch.viewer.web import WebViewer, estimate_up
    mcfg = C.extract_model(args)
    rcfg = C.extract_raster(args)
    params, state, bg = load_model(mcfg, args.iteration, device)

    xyz = params.xyz[state.alive].cpu().numpy()
    center = xyz.mean(axis=0)
    radius = float(np.percentile(np.linalg.norm(xyz - center, axis=1), 90))
    cams_json = None
    cams_path = os.path.join(mcfg.model_path, "cameras.json")
    if os.path.exists(cams_path):
        with open(cams_path) as f:
            cams_json = json.load(f)

    def render_fn(cam, scaling_modifier):
        import torch
        with torch.inference_mode():
            out = renderer.render(params, state, cam.to_view(device), bg=bg,
                                  config=rcfg,
                                  scaling_modifier=scaling_modifier)
        return {"color": out.color, "feature": out.feature,
                "depth": out.depth}

    return WebViewer(
        render_fn, center=center, radius=max(radius, 1e-3),
        up=estimate_up(cams_json), n_gaussians=state.num_active,
        feature_dim=int(params.semantic_feature.shape[-1]),
        source=mcfg.source_path or mcfg.model_path,
        host=args.ip, port=args.port)


def main(argv=None) -> int:
    from feature3dgs_tpu_torch import config as C
    from feature3dgs_tpu_torch import default_device
    args = C.combine_with_saved(build_parser(), argv)
    viewer = make_viewer(args, default_device(args.device))
    print(f"Serving {viewer.meta['n_gaussians']} gaussians at "
          f"http://{args.ip}:{viewer.port}/  (ctrl-c to stop)")
    viewer.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
