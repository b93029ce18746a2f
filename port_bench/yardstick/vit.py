"""Float32 operations of one image through SAM's ViT image encoder, counted
from its shapes: the matrix products and convolutions, 2 operations a
multiply-add (the norms, softmax, GELU and additions, under 1% of the
whole, are left out). Windowed blocks attend within windows of the grid
zero-padded to whole windows (64 x 64 -> 70 x 70 at ViT-H), so their
query, key, value and output projections and attention run over the padded
tokens, their MLP over the grid's; global blocks over the grid's. The
relative-position terms are each query's product with its row and column
tables. The numerator of ``mfu`` in the encoder's cell, whatever
implements it."""
from __future__ import annotations


def block_ops(d: int, heads: int, mlp: int, grid: int, window: int) -> int:
    """One block; ``window`` 0 for a global block."""
    side = window or grid
    n_win = (-(-grid // side)) ** 2        # windows, the grid padded
    t = side * side                        # tokens a window
    padded = n_win * t
    ops = 2 * padded * d * 3 * d           # qkv
    ops += 2 * 2 * n_win * t * t * d       # q k^T and p v, all heads
    ops += 2 * 2 * n_win * d * side ** 3   # the height and width terms
    ops += 2 * padded * d * d              # output projection
    ops += 2 * 2 * grid * grid * d * mlp   # MLP
    return ops


def image_ops(vision: dict) -> int:
    """One image at the SamVisionConfig widths ``vision``: patch embedding,
    every block, and the neck's 1x1 and 3x3 convolutions."""
    d, p = vision["hidden_size"], vision["patch_size"]
    grid = vision["image_size"] // p
    c = vision["output_channels"]
    globals_ = set(vision["global_attn_indexes"])
    ops = 2 * grid * grid * d * 3 * p * p
    for i in range(vision["num_hidden_layers"]):
        ops += block_ops(d, vision["num_attention_heads"], vision["mlp_dim"],
                         grid, 0 if i in globals_ else vision["window_size"])
    ops += 2 * grid * grid * d * c + 2 * grid * grid * c * c * 9
    return ops
