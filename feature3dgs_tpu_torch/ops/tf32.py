"""Plain PyTorch emulation of the 3xTF32 product the compositing kernels run
on the tensor cores (ops/csrc/raster_common.cuh: ``tf32_split``,
``mma_3xtf32``). Used by the tests and the chip smoke check to state what
the split is worth; the main path never calls it.

A TF32 operand keeps 11 significant bits of an f32. The kernels split each
operand ``x`` into ``hi`` = ``x`` rounded to nearest at 11 bits (Veltkamp's
split with 2^13 + 1) and ``lo = x - hi`` (exact), of which the tensor core
reads the upper 19 bits, and sum ``lo.hi + hi.lo + hi.hi`` over 8 inner
indices at a time from a zero accumulator, adding each such group to an f32
accumulator outside the tensor core.
"""
from __future__ import annotations

import torch

# inner indices of one mma.sync.m16n8k8
MMA_K = 8


def _truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32: its upper 19 bits."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo) of an f32 tensor as the kernels split it: hi + lo == x up to
    the low bits the tensor core drops from lo (below 2^-22 |x|)."""
    x = x.to(torch.float32)
    p = x * 8193.0
    hi = (x - p) + p
    return hi, _truncate_tf32(x - hi)


def _grouped_matmul(terms, k: int) -> torch.Tensor:
    """sum over groups of MMA_K inner indices of the f32-rounded group sums
    of ``terms`` (pairs of [M,K] and [K,N] operands), accumulated in f32."""
    m, n = terms[0][0].shape[0], terms[0][1].shape[1]
    acc = torch.zeros((m, n), dtype=torch.float32)
    for k0 in range(0, k, MMA_K):
        group = torch.zeros((m, n), dtype=torch.float64)
        for a, b in terms:
            group += a[:, k0:k0 + MMA_K].double() @ b[k0:k0 + MMA_K].double()
        acc += group.to(torch.float32)
    return acc


def matmul_3xtf32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M,K] @ b [K,N] as the kernels compute it: split operands, three
    TF32 products per group of 8 inner indices (each product of two 11-bit
    values is exact; the group sum is rounded once to f32), groups added in
    f32 in order."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return _grouped_matmul([(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)],
                           a.shape[1])


def matmul_tf32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same product in one TF32 pass (operands rounded to 11 bits, no
    correction terms): about three decimal digits."""
    return _grouped_matmul([(tf32_split(a)[0], tf32_split(b)[0])], a.shape[1])
