"""feature3dgs_tpu_torch — Feature 3D Gaussian Splatting in PyTorch and CUDA.

The PyTorch port of ``feature3dgs_tpu``: the same Gaussian parameters,
activations, PLY schema, rasterizer contract (RGB, N-dim features and depth
in one differentiable pass, plus radii, visibility, ``n_contrib`` and the
overflow counters), losses, Adam, training step and render CLI, with the
compositing kernels written by hand in CUDA C++ for Hopper: the forward
``ops/csrc/raster_forward.cu`` and the backward
``ops/csrc/raster_backward.cu``, sharing ``ops/csrc/raster_common.cuh``.

Precision: everything is float32. Importing the package sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``, so matrix products and
convolutions on the card run in full float32 rather than TF32.

Device: entry points run on ``default_device()``, which is the CUDA card and
raises when there is none, unless the caller asks for ``"cpu"`` (as the
tests do). For CPU tensors ``ops.rasterize`` runs each kernel's plain
PyTorch version; the kernel wrappers themselves raise on anything but CUDA
tensors.

Layout (module names follow ``feature3dgs_tpu`` where that helps a reader
find the counterpart):
  core/      camera transforms, SH, EWA projection
  ops/       binning, plain compositor forward and backward, CUDA kernel
             wrappers, segment-sum, rasterize (autograd Function) and the
             forward-only rasterize_batch, the per-pixel oracle, the 3-NN
  model/     Gaussian parameters, decoder, PLY I/O, Adam, densification
  data/      PLY codec, cameras, COLMAP / Blender loaders, synthetic scenes
  render/    renderer binding (render, render_batch), render and viewer
             modes, novel-view paths, language-guided editing
  tasks/     segmentation, ADE20K labels, CLIP text embeddings
  metrics/   LPIPS (VGG16)
  train/     losses, train_step and the Trainer, checkpoints
  viewer/    the SIBR remote viewer's protocol, the browser viewer
  encoders/  LSeg, CLIP pixel features, SAM encoding and mask decoding
  native/    the C++ host helpers (3-NN, points3D.bin scan), built with
             the host's C++ compiler at first use
  bench_utils.py  step spans by CUDA events, profiler tables, bench.py's
             scene, the card's peaks: what the measuring CLIs and
             chip_smoke.py share
  tracing.py the program's own spans and counters (stages, host waits,
             instances), recorded while a profiler runs or under
             tracing.recording()
  cli/       train, render, segmentation, segmentation_metric, metrics,
             full_eval, view, web_view, videos, encode_lseg, segment_time,
             parity_check, convert and jpg2png; the measuring CLIs bench,
             bench_render, profile_step, bench_longrun and bench_scaling;
             the stage micro-benchmarks micro_segsum, micro_expand and
             micro_pack (python -m feature3dgs_tpu_torch.cli.<name>)
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# PyTorch's CPU build can return unary float math (exp, log, sqrt) off by
# ~1e-4 relative in part of the first such call that runs on several
# threads; one tiny single-threaded call first avoids it
# (tests/test_torch_isolation.py::test_first_threaded_cpu_math_is_exact).
torch.exp(torch.zeros(1))

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
