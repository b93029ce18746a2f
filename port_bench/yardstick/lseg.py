"""Float32 operations of one image through LSeg's network (ViT-L/16 trunk,
DPT head), counted from its shapes: the matrix products and convolutions,
2 operations a multiply-add. The norms, softmax, GELU, ReLU, additions and
the bilinear resizes are left out. ``net`` holds the port's
``build_lseg`` widths, lower-cased, as the configuration's "net" group
does; the input is h x w with sides that are multiples of 32 (the
network's input at one scale).

Three parts, as the program's spans split them:
  embed_ops  the patch embedding (in ``lseg.encode``'s own time);
  trunk_ops  the blocks (``lseg.block``): q, k, v and output projections,
             q k^T and p v over every token pair (global attention, cls
             included), the MLP;
  head_ops   the reassemble (``lseg.reassemble``: readout Linear 2d -> d,
             1x1 convolutions, the 4x4/s4 and 2x2/s2 transposed and the
             3x3/s2 resamples), the fusion (``lseg.fusion``: the
             ``layer*_rn`` 3x3 convolutions, each RefineNet's residual
             units and 1x1 convolution) and ``head1`` (``lseg.head``).
Their sum is the numerator of ``mfu`` in the LSeg export's cell, whatever
implements it; ``trunk_ops`` that of ``lseg_vit_roofline``.
"""
from __future__ import annotations


def block_ops(d: int, tokens: int, mlp: int) -> int:
    """One block over ``tokens`` tokens of width ``d``."""
    n = tokens
    return (2 * n * d * 3 * d          # qkv
            + 2 * 2 * n * n * d        # q k^T and p v, all heads
            + 2 * n * d * d            # output projection
            + 2 * 2 * n * d * mlp)     # MLP


def conv_ops(hw: tuple, c_in: int, c_out: int, k: int) -> int:
    """A k x k convolution producing an ``hw`` map (for a transposed one
    with stride equal to its kernel: over its input's map)."""
    return 2 * hw[0] * hw[1] * c_in * c_out * k * k


def image_ops(net: dict, h: int, w: int, mlp_ratio: int = 4) -> dict:
    """{"embed_ops", "trunk_ops", "head_ops"} of one h x w input."""
    d, p = net["vit_dim"], net["patch"]
    f, c, out_c = net["reassemble"], net["features"], net["out_c"]
    gh, gw = h // p, w // p
    g = (gh, gw)
    embed = conv_ops(g, 3, d, p)
    trunk = net["vit_depth"] * block_ops(d, gh * gw + 1, mlp_ratio * d)
    # the four levels' maps: /4, /8, /16 and /32 of the input
    g4 = ((gh - 1) // 2 + 1, (gw - 1) // 2 + 1)
    levels = ((4 * gh, 4 * gw), (2 * gh, 2 * gw), g, g4)
    head = 0
    for k in range(4):
        head += 2 * gh * gw * 2 * d * d               # readout
        head += conv_ops(g, d, f[k], 1)               # 1x1
    head += conv_ops(g, f[0], f[0], 4)                # 4x4/s4 transposed
    head += conv_ops(g, f[1], f[1], 2)                # 2x2/s2 transposed
    head += conv_ops(g4, f[3], f[3], 3)               # 3x3/s2
    for k in range(4):
        head += conv_ops(levels[k], f[k], c, 3)       # layer*_rn
    # RefineNets 4..1: residual units at the level's map (two 3x3
    # convolutions each; refinenet4 has no skip, so one unit), then the 1x1
    # convolution at twice its size
    for k, units in ((3, 1), (2, 2), (1, 2), (0, 2)):
        hw = levels[k]
        head += units * 2 * conv_ops(hw, c, c, 3)
        head += conv_ops((2 * hw[0], 2 * hw[1]), c, c, 1)
    head += conv_ops((8 * gh, 8 * gw), c, out_c, 1)   # head1 at /2
    return {"embed_ops": embed, "trunk_ops": trunk, "head_ops": head}
