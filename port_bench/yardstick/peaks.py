"""NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit), frozen from
``feature3dgs_tpu_torch/bench_utils.py:42-44``: float32 outside the tensor
cores (the program computes in f32 with TF32 off) and HBM3 bandwidth."""
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
