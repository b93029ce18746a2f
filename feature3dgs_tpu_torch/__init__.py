"""feature3dgs_tpu_torch — Feature 3D Gaussian Splatting in PyTorch and CUDA.

The PyTorch port of ``feature3dgs_tpu``: the same Gaussian parameters,
activations, PLY schema, rasterizer contract (RGB, N-dim features and depth
in one pass, plus radii, visibility, ``n_contrib`` and the overflow
counters) and render CLI, with the compositing kernel written by hand in
CUDA C++ for Hopper (``ops/csrc/raster_forward.cu``). This slice serves
renders; training comes next.

Precision: everything is float32. Importing the package sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``, so matrix products and
convolutions on the card run in full float32 rather than TF32.

Device: entry points run on ``default_device()``, which is the CUDA card and
raises when there is none, unless the caller asks for ``"cpu"`` (as the
tests do). On CPU tensors every kernel wrapper runs its plain PyTorch
version.

Layout (module names follow ``feature3dgs_tpu`` where that helps a reader
find the counterpart):
  core/      camera transforms, SH, EWA projection
  ops/       binning, plain compositor, CUDA kernel wrapper, rasterize
  model/     Gaussian parameters, decoder, PLY I/O
  data/      PLY codec, cameras, COLMAP / Blender loaders
  render/    renderer binding, render modes
  train/     the feature resize used by rendering; decoder checkpoints
  cli/       render CLI (python -m feature3dgs_tpu_torch.cli.render)
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def default_device(device: str | torch.device | None = None) -> torch.device:
    """The device entry points run on: the CUDA card unless ``device``
    names another. Raises when CUDA is asked for (explicitly or by default)
    and absent — there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
