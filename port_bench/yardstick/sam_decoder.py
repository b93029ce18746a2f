"""Float32 operations of SAM's prompt encoder and mask decoder, counted from
their shapes: the matrix products and transposed convolutions, 2
operations a multiply-add, and the random-Fourier encodings' products (the
norms, softmax, GELU, ReLU, sines and additions are left out). Tokens: the
IoU token, the mask tokens and the prompt's (a point and its pad point).
Attention runs at the width over the downsample rate, but the tokens'
self-attention at the full width. Work that is the same for every prompt
of a call is counted once a call: the image's encoding, and in the first
two-way block the projections of the image's tokens before any prompt has
touched them (the token-to-image keys and values, the image-to-token
queries). ``decode_ops`` is the mask decoder's roofline numerator in the
segmenting cell and a part of its ``mfu``, whatever implements it."""
from __future__ import annotations

import math


def attention_ops(n_q: int, n_k: int, c: int, inner: int) -> int:
    """Projections in (q from the queries, k and v from the keys), the two
    products over ``inner`` and the projection out."""
    return (2 * n_q * c * inner + 2 * 2 * n_k * c * inner
            + 2 * 2 * n_q * n_k * inner + 2 * n_q * inner * c)


def _widths(prompt_encoder: dict, mask_decoder: dict) -> dict:
    md = mask_decoder
    c = md["hidden_size"]
    grid = prompt_encoder["image_size"] // prompt_encoder["patch_size"]
    masks = md["num_multimask_outputs"] + 1
    return dict(c=c, inner=c // md["attention_downsample_rate"],
                n=grid * grid, grid=grid, masks=masks, tokens=1 + masks + 2,
                mlp=md["mlp_dim"], depth=md["num_hidden_layers"],
                iou_depth=md["iou_head_depth"],
                iou_hidden=md["iou_head_hidden_dim"])


def point_ops(prompt_encoder: dict, mask_decoder: dict) -> int:
    """One point prompt through the mask decoder: its random-Fourier
    encoding (the point and the pad point), every two-way block, the final
    attention, the two transposed convolutions, the hypernetwork MLPs, the
    IoU head and the product of the mask weights with the upscaled
    embedding (every mask token's, the single-mask one too); but not
    ``shared_ops``, counted once a call."""
    w = _widths(prompt_encoder, mask_decoder)
    c, inner, n, t = w["c"], w["inner"], w["n"], w["tokens"]
    ops = 2 * 2 * 2 * (c // 2) - shared_ops(prompt_encoder, mask_decoder)
    for _ in range(w["depth"]):
        ops += attention_ops(t, t, c, c)             # tokens' self-attention
        ops += attention_ops(t, n, c, inner)         # token -> image
        ops += 2 * 2 * t * c * w["mlp"]              # MLP
        ops += attention_ops(n, t, c, inner)         # image -> token
    ops += attention_ops(t, n, c, inner)             # final token -> image
    ops += 2 * n * c * (c // 4) * 4                  # upscale 2x, C -> C/4
    ops += 2 * (4 * n) * (c // 4) * (c // 8) * 4     # upscale 2x, -> C/8
    ops += w["masks"] * 2 * (c * c + c * c + c * (c // 8))
    dims = [c] + [w["iou_hidden"]] * (w["iou_depth"] - 1) + [w["masks"]]
    ops += sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    ops += 2 * w["masks"] * (c // 8) * (16 * n)      # masks
    return ops


def shared_ops(prompt_encoder: dict, mask_decoder: dict) -> int:
    """The first two-way block's projections of the image's tokens that no
    prompt has touched yet, the same for every prompt: the token-to-image
    keys and values and the image-to-token queries."""
    w = _widths(prompt_encoder, mask_decoder)
    return 3 * 2 * w["n"] * w["c"] * w["inner"] if w["depth"] else 0


def call_ops(prompt_encoder: dict, mask_decoder: dict) -> int:
    """What each call of the decoder adds once: the image's random-Fourier
    encoding and ``shared_ops``."""
    w = _widths(prompt_encoder, mask_decoder)
    return (2 * w["n"] * 2 * (w["c"] // 2)
            + shared_ops(prompt_encoder, mask_decoder))


def decode_ops(prompt_encoder: dict, mask_decoder: dict, points: int
               ) -> int:
    """One call of the decoder on ``points`` single-point prompts."""
    return (points * point_ops(prompt_encoder, mask_decoder)
            + call_ops(prompt_encoder, mask_decoder))


def view_ops(cfg: dict) -> int:
    """One view of the automatic mask generator: its point grid in batches
    through the decoder."""
    g = cfg["generator"]
    points, per = g["points_per_side"] ** 2, g["points_per_batch"]
    pe, md = cfg["prompt_encoder"], cfg["mask_decoder"]
    return (points * point_ops(pe, md)
            + math.ceil(points / per) * call_ops(pe, md))
