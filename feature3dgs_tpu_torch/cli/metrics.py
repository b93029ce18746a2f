"""Metrics CLI: image quality of the rendered test views.

    python -m feature3dgs_tpu_torch.cli.metrics -m <model_path> [...]

The port of ``scripts/metrics.py`` (the original metrics.py:36-93): for
each method under ``<model_path>/test/``, SSIM and PSNR (the port's
``train/losses.py``) and LPIPS-VGG (``metrics/lpips.py``) of every render
against its ground truth, on the card (``--device cpu`` for the CPU);
``results.json`` (means) and ``per_view.json`` in the model directory, with
the keys of scripts/metrics.py. LPIPS is null unless ``LPIPS_WEIGHTS`` names
a weights file.
"""
from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch


def _load_dir(path):
    from PIL import Image
    for n in sorted(os.listdir(path)):
        yield n, np.asarray(Image.open(os.path.join(path, n)).convert("RGB"),
                            np.float32) / 255.0


def _mean_or_none(values):
    values = [x for x in values if x is not None]
    return float(np.mean(values)) if values else None


def main(argv=None):
    parser = ArgumentParser(description="Image-quality metrics of the test "
                                        "renders (PyTorch)")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    from feature3dgs_tpu_torch import default_device
    from feature3dgs_tpu_torch.metrics.lpips import (lpips_available,
                                                     lpips_distance)
    from feature3dgs_tpu_torch.train import losses as L

    device = default_device(args.device)
    use_lpips = lpips_available(device)
    for model_path in args.model_paths:
        print(f"Scene: {model_path}")
        full, per_view = {}, {}
        test_dir = os.path.join(model_path, "test")
        if not os.path.isdir(test_dir):
            print("  no test renders found")
            continue
        for method in sorted(os.listdir(test_dir)):
            rdir = os.path.join(test_dir, method, "renders")
            gdir = os.path.join(test_dir, method, "gt")
            if not (os.path.isdir(rdir) and os.path.isdir(gdir)):
                continue
            ssims, psnrs, lpipss, names = [], [], [], []
            gts = dict(_load_dir(gdir))
            with torch.no_grad():
                for name, render in _load_dir(rdir):
                    if name not in gts:
                        continue
                    r = torch.from_numpy(render).to(device)
                    g = torch.from_numpy(gts[name]).to(device)
                    ssims.append(float(L.ssim(r, g)))
                    psnrs.append(float(L.psnr(r, g)))
                    lpipss.append(lpips_distance(render, gts[name],
                                                 device=device)
                                  if use_lpips else None)
                    names.append(name)
            lp = _mean_or_none(lpipss)
            print(f"  {method}: SSIM {np.mean(ssims):.7f} "
                  f"PSNR {np.mean(psnrs):.7f} "
                  f"LPIPS {lp if lp is not None else 'n/a'}")
            full[method] = {"SSIM": float(np.mean(ssims)),
                            "PSNR": float(np.mean(psnrs)), "LPIPS": lp}
            per_view[method] = {
                "SSIM": dict(zip(names, map(float, ssims))),
                "PSNR": dict(zip(names, map(float, psnrs))),
                "LPIPS": dict(zip(names, lpipss))}
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(full, f, indent=True)
        with open(os.path.join(model_path, "per_view.json"), "w") as f:
            json.dump(per_view, f, indent=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
