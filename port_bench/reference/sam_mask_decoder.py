"""SAM's prompt encoder, two-way mask decoder and automatic mask generator
in plain torch and float32, written from the published code:
segment-anything ``modeling/prompt_encoder.py`` (``PositionEmbeddingRandom``,
the point embeddings with the pad point), ``modeling/transformer.py``
(``TwoWayTransformer``, ``TwoWayAttentionBlock``, ``Attention`` with its
downsampled inner width), ``modeling/mask_decoder.py`` (the output
upscaling, the hypernetwork MLPs, the IoU head, the multimask selection),
``modeling/sam.py`` (``postprocess_masks``), ``utils/transforms.py``
(``ResizeLongestSide.apply_coords``) and ``utils/amg.py`` with
``automatic_mask_generator.py`` (the point grid, the stability score, the
filters, ``batched_mask_to_box``, the crop-edge test, box NMS, the records).
It imports neither ``transformers`` nor the program, and runs every product
in full float32 (TF32 off; the control turns it on around a call).

Departures, each where the port's model (``transformers``' ``SamModel`` at
facebook/sam-vit-huge's configuration) or the configuration differs from
that code: the two-way blocks' LayerNorm eps is the configuration's (1e-6;
segment-anything's ``nn.LayerNorm`` default is 1e-5); the generator runs
the configuration's single crop (``crop_n_layers`` 0), where the uncrop is
the identity; the mask-prompt path (``mask_downscaling``) is drawn and
loaded but not run, since the generator gives no mask prompt. The
planted faults of the decoder (``FAULTS``) and of the selection
(``SELECTION_FAULTS``) are calibration's, never a run's. Box NMS
visits the candidates in numpy's argsort of the negated scores (torchvision
leaves the order of ties unspecified) and takes IoUs in float64
(torchvision's float32 makes the same decisions for integer boxes of under
2^24 pixels).

Weights: ``draw`` fills every parameter by segment-anything's names from a
seeded generator with ``sam_vit.SamViT.draw``'s rule (matrices and kernels
N(0, 1/fan_in), biases and vectors N(0, 0.02^2), norm scales 1 + N(0,
0.1^2)), but the random-Fourier matrix N(0, 1), as segment-anything draws
that buffer; then two factors the configuration states (its ``draw``):
the hypernetwork MLPs' last layers (weight and bias) times
``hyper_out_scale``, which scales every mask logit by it, and
``iou_out_shift`` added to the IoU head's output bias. With the plain draw
the logits are of order 1 and the predicted IoUs of order 0.1, so no
candidate passes the stability (offset 1) or IoU (0.88) filter, and the
selection would do no work. ``port_state`` renames the weights to the
port's ``shared_image_embedding``, ``prompt_encoder`` and ``mask_decoder``
state dicts, which the program loads strictly; ``load`` takes them back as
strictly.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.sam_vit import layer_norm, layer_norm_2d

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FAULTS = ("no_image_to_token", "no_key_pe", "no_downsample")
SELECTION_FAULTS = ("no_iou_filter", "no_stability_offset", "no_nms")
VECTOR_STD = 0.02
NORM_STD = 0.1
MASK_THRESHOLD = 0.0
# LayerNorm2d's eps in the upscaling (modeling/common.py) and the final
# attention's LayerNorm (nn.LayerNorm's default)
NORM2D_EPS = 1e-6
FINAL_EPS = 1e-5


def _attn_names(prefix: str, c: int, inner: int) -> dict:
    s = {}
    for p in ("q_proj", "k_proj", "v_proj"):
        s[f"{prefix}.{p}.weight"] = (inner, c)
        s[f"{prefix}.{p}.bias"] = (inner,)
    s[f"{prefix}.out_proj.weight"] = (c, inner)
    s[f"{prefix}.out_proj.bias"] = (c,)
    return s


def _mlp_names(prefix: str, dims: list) -> dict:
    s = {}
    for i, (n, k) in enumerate(zip(dims[:-1], dims[1:])):
        s[f"{prefix}.layers.{i}.weight"] = (k, n)
        s[f"{prefix}.layers.{i}.bias"] = (k,)
    return s


class SamDecoder:
    """The prompt encoder and mask decoder at the configuration's widths
    (``prompt_encoder`` as SamPromptEncoderConfig keys, ``mask_decoder`` as
    SamMaskDecoderConfig keys); ``params`` holds the weights by
    segment-anything's names, on the host."""

    def __init__(self, prompt_encoder: dict, mask_decoder: dict):
        pe, md = prompt_encoder, mask_decoder
        self.c = md["hidden_size"]
        if pe["hidden_size"] != self.c:
            raise ValueError("prompt and mask decoder widths differ")
        self.input_size = pe["image_size"]
        self.grid = pe["image_size"] // pe["patch_size"]
        self.mask_in = pe["mask_input_channels"]
        self.n_points = pe["num_point_embeddings"]
        self.depth, self.mlp = md["num_hidden_layers"], md["mlp_dim"]
        self.heads = md["num_attention_heads"]
        self.downsample = md["attention_downsample_rate"]
        self.n_masks = md["num_multimask_outputs"] + 1
        self.iou_depth = md["iou_head_depth"]
        self.iou_hidden = md["iou_head_hidden_dim"]
        self.eps = md["layer_norm_eps"]
        self.params: dict = {}

    def shapes(self) -> dict:
        """Every parameter's shape, by segment-anything's name."""
        c, mi, inner = self.c, self.mask_in, self.c // self.downsample
        s = {"prompt_encoder.pe_layer.positional_encoding_gaussian_matrix":
             (2, c // 2)}
        for i in range(self.n_points):
            s[f"prompt_encoder.point_embeddings.{i}.weight"] = (1, c)
        s["prompt_encoder.not_a_point_embed.weight"] = (1, c)
        for k, shape in (("0.weight", (mi // 4, 1, 2, 2)),
                         ("0.bias", (mi // 4,)), ("1.weight", (mi // 4,)),
                         ("1.bias", (mi // 4,)),
                         ("3.weight", (mi, mi // 4, 2, 2)), ("3.bias", (mi,)),
                         ("4.weight", (mi,)), ("4.bias", (mi,)),
                         ("6.weight", (c, mi, 1, 1)), ("6.bias", (c,))):
            s[f"prompt_encoder.mask_downscaling.{k}"] = shape
        s["prompt_encoder.no_mask_embed.weight"] = (1, c)
        m = "mask_decoder"
        s[f"{m}.iou_token.weight"] = (1, c)
        s[f"{m}.mask_tokens.weight"] = (self.n_masks, c)
        for i in range(self.depth):
            b = f"{m}.transformer.layers.{i}"
            s.update(_attn_names(f"{b}.self_attn", c, c))
            s[f"{b}.norm1.weight"] = s[f"{b}.norm1.bias"] = (c,)
            s.update(_attn_names(f"{b}.cross_attn_token_to_image", c, inner))
            s[f"{b}.norm2.weight"] = s[f"{b}.norm2.bias"] = (c,)
            s[f"{b}.mlp.lin1.weight"] = (self.mlp, c)
            s[f"{b}.mlp.lin1.bias"] = (self.mlp,)
            s[f"{b}.mlp.lin2.weight"] = (c, self.mlp)
            s[f"{b}.mlp.lin2.bias"] = (c,)
            s[f"{b}.norm3.weight"] = s[f"{b}.norm3.bias"] = (c,)
            s[f"{b}.norm4.weight"] = s[f"{b}.norm4.bias"] = (c,)
            s.update(_attn_names(f"{b}.cross_attn_image_to_token", c, inner))
        s.update(_attn_names(f"{m}.transformer.final_attn_token_to_image", c,
                             inner))
        s[f"{m}.transformer.norm_final_attn.weight"] = (c,)
        s[f"{m}.transformer.norm_final_attn.bias"] = (c,)
        s[f"{m}.output_upscaling.0.weight"] = (c, c // 4, 2, 2)
        s[f"{m}.output_upscaling.0.bias"] = (c // 4,)
        s[f"{m}.output_upscaling.1.weight"] = (c // 4,)
        s[f"{m}.output_upscaling.1.bias"] = (c // 4,)
        s[f"{m}.output_upscaling.3.weight"] = (c // 4, c // 8, 2, 2)
        s[f"{m}.output_upscaling.3.bias"] = (c // 8,)
        for t in range(self.n_masks):
            s.update(_mlp_names(f"{m}.output_hypernetworks_mlps.{t}",
                                [c, c, c, c // 8]))
        s.update(_mlp_names(f"{m}.iou_prediction_head",
                            [c] + [self.iou_hidden] * (self.iou_depth - 1)
                            + [self.n_masks]))
        return s

    def name_map(self) -> dict:
        """The port's state-dict key (``shared_image_embedding.``,
        ``prompt_encoder.`` or ``mask_decoder.`` and the module's own key)
        -> this decoder's parameter name. The random-Fourier matrix is one
        buffer the port holds twice."""
        gauss = "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"
        m = {"shared_image_embedding.positional_embedding": gauss,
             "prompt_encoder.shared_embedding.positional_embedding": gauss,
             "prompt_encoder.not_a_point_embed.weight":
                 "prompt_encoder.not_a_point_embed.weight",
             "prompt_encoder.no_mask_embed.weight":
                 "prompt_encoder.no_mask_embed.weight",
             "mask_decoder.iou_token.weight": "mask_decoder.iou_token.weight",
             "mask_decoder.mask_tokens.weight":
                 "mask_decoder.mask_tokens.weight"}
        for i in range(self.n_points):
            m[f"prompt_encoder.point_embed.{i}.weight"] = \
                f"prompt_encoder.point_embeddings.{i}.weight"
        for port, ours in (("conv1", "0"), ("layer_norm1", "1"),
                           ("conv2", "3"), ("layer_norm2", "4"),
                           ("conv3", "6")):
            for t in ("weight", "bias"):
                m[f"prompt_encoder.mask_embed.{port}.{t}"] = \
                    f"prompt_encoder.mask_downscaling.{ours}.{t}"
        attn = [f"{a}.{p}" for a in ("self_attn", "cross_attn_token_to_image",
                                     "cross_attn_image_to_token")
                for p in ("q_proj", "k_proj", "v_proj", "out_proj")]
        t = "mask_decoder.transformer"
        for i in range(self.depth):
            pairs = [(a, a) for a in attn] + [
                ("mlp.lin1", "mlp.lin1"), ("mlp.lin2", "mlp.lin2")] + [
                (f"layer_norm{k}", f"norm{k}") for k in range(1, 5)]
            for port, ours in pairs:
                for w in ("weight", "bias"):
                    m[f"{t}.layers.{i}.{port}.{w}"] = \
                        f"{t}.layers.{i}.{ours}.{w}"
        pairs = [(f"{t}.final_attn_token_to_image.{p}",) * 2
                 for p in ("q_proj", "k_proj", "v_proj", "out_proj")]
        pairs += [(f"{t}.layer_norm_final_attn", f"{t}.norm_final_attn"),
                  ("mask_decoder.upscale_conv1",
                   "mask_decoder.output_upscaling.0"),
                  ("mask_decoder.upscale_layer_norm",
                   "mask_decoder.output_upscaling.1"),
                  ("mask_decoder.upscale_conv2",
                   "mask_decoder.output_upscaling.3")]
        for head, n in ([(f"mask_decoder.output_hypernetworks_mlps.{k}", 3)
                         for k in range(self.n_masks)]
                        + [("mask_decoder.iou_prediction_head",
                            self.iou_depth)]):
            port = (["proj_in"] + [f"layers.{j}" for j in range(n - 2)]
                    + ["proj_out"])
            pairs += [(f"{head}.{p}", f"{head}.layers.{j}")
                      for j, p in enumerate(port)]
        for port, ours in pairs:
            for w in ("weight", "bias"):
                m[f"{port}.{w}"] = f"{ours}.{w}"
        return m

    def draw(self, generator: torch.Generator, hyper_out_scale: float = 1.0,
             iou_out_shift: float = 0.0) -> "SamDecoder":
        """Every parameter drawn from ``generator``, on its device, in
        ``shapes()``'s order, kept on the host as float32; then the two
        factors of the module's docstring. No entry is zero."""
        params = {}
        gauss = "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"
        for name, shape in self.shapes().items():
            t = torch.empty(shape, device=generator.device)
            if name == gauss:
                t.normal_(0.0, 1.0, generator=generator)
            elif len(shape) >= 2:
                t.normal_(0.0, (t.numel() / shape[0]) ** -0.5,
                          generator=generator)
            elif name.endswith("weight"):
                t.normal_(1.0, NORM_STD, generator=generator)
            else:
                t.normal_(0.0, VECTOR_STD, generator=generator)
            params[name] = t.cpu()
        for k in range(self.n_masks):
            for w in ("weight", "bias"):
                params[f"mask_decoder.output_hypernetworks_mlps.{k}.layers.2."
                       f"{w}"] *= hyper_out_scale
        params[f"mask_decoder.iou_prediction_head.layers."
               f"{self.iou_depth - 1}.bias"] += iou_out_shift
        self.params = params
        return self

    def port_state(self, part: str | None = None) -> dict:
        """These weights as the port's state dict (the inverse of
        ``name_map``); with ``part`` ("shared_image_embedding",
        "prompt_encoder" or "mask_decoder") that module's own, its prefix
        left off, for its strict ``load_state_dict``."""
        out = {port: self.params[ours]
               for port, ours in self.name_map().items()}
        if part is None:
            return out
        n = len(part) + 1
        return {k[n:]: v for k, v in out.items() if k.startswith(part + ".")}

    def load(self, port_state: dict) -> "SamDecoder":
        """Take the port's weights, strictly: every key maps to a parameter
        of this shape, every parameter is set, and the two keys of the
        random-Fourier matrix agree."""
        names, shapes = self.name_map(), self.shapes()
        extra = sorted(set(port_state) - set(names))
        missing = sorted(set(names) - set(port_state))
        if extra or missing:
            raise KeyError(f"port weights: {len(extra)} keys not mapped "
                           f"{extra[:3]}, {len(missing)} missing "
                           f"{missing[:3]}")
        params = {}
        for key, t in port_state.items():
            ours = names[key]
            if tuple(t.shape) != shapes[ours]:
                raise ValueError(f"{key} -> {ours}: {tuple(t.shape)}, "
                                 f"expected {shapes[ours]}")
            t = t.detach().to("cpu", torch.float32)
            if ours in params and not torch.equal(params[ours], t):
                raise ValueError(f"{key}: differs from the other key of "
                                 f"{ours}")
            params[ours] = t
        self.params = params
        return self

    # ------------------------------------------------------------ forward

    def _pe(self, coords: torch.Tensor, p: dict) -> torch.Tensor:
        """PositionEmbeddingRandom._pe_encoding of coordinates in [0, 1]."""
        g = p["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
        coords = 2 * math.pi * ((2 * coords - 1) @ g)
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def dense_pe(self, p: dict) -> torch.Tensor:
        """The image's positional encoding [C, g, g]."""
        dev = p["mask_decoder.iou_token.weight"].device
        grid = torch.ones((self.grid, self.grid), device=dev)
        y = (grid.cumsum(dim=0) - 0.5) / self.grid
        x = (grid.cumsum(dim=1) - 0.5) / self.grid
        return self._pe(torch.stack([x, y], dim=-1), p).permute(2, 0, 1)

    def embed_points(self, points: torch.Tensor, p: dict) -> torch.Tensor:
        """Single positive points [P, 2] (float64, the input frame) ->
        [P, 2, C]: the point and the pad point (label -1) that
        ``_embed_points`` adds when no box is given."""
        n = points.shape[0]
        dev = points.device
        pts = torch.cat([points[:, None, :] + 0.5,
                         torch.zeros((n, 1, 2), dtype=points.dtype,
                                     device=dev)], 1)
        labels = torch.cat([torch.ones((n, 1), device=dev),
                            -torch.ones((n, 1), device=dev)], 1)
        coords = pts.clone()
        coords[..., 0] = coords[..., 0] / self.input_size
        coords[..., 1] = coords[..., 1] / self.input_size
        emb = self._pe(coords.to(torch.float), p)
        pad = labels == -1
        emb[pad] = 0.0
        emb[pad] += p["prompt_encoder.not_a_point_embed.weight"]
        emb[labels == 0] += p["prompt_encoder.point_embeddings.0.weight"]
        emb[labels == 1] += p["prompt_encoder.point_embeddings.1.weight"]
        return emb

    def _attention(self, q, k, v, p: dict, prefix: str, fault=None):
        """Attention with its inner width (the width over the downsample
        rate) split over the heads; ``fault == "no_downsample"`` splits it
        into heads of the undownsampled head size (C / heads)."""
        q = F.linear(q, p[f"{prefix}.q_proj.weight"],
                     p[f"{prefix}.q_proj.bias"])
        k = F.linear(k, p[f"{prefix}.k_proj.weight"],
                     p[f"{prefix}.k_proj.bias"])
        v = F.linear(v, p[f"{prefix}.v_proj.weight"],
                     p[f"{prefix}.v_proj.bias"])
        inner = q.shape[-1]
        heads = self.heads
        if fault == "no_downsample":
            heads = max(1, inner // (self.c // self.heads))

        def split(x):
            b, n, c = x.shape
            return x.reshape(b, n, heads, c // heads).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        attn = q @ k.permute(0, 1, 3, 2) / math.sqrt(q.shape[-1])
        out = torch.softmax(attn, dim=-1) @ v
        b, h, n, c = out.shape
        out = out.transpose(1, 2).reshape(b, n, h * c)
        return F.linear(out, p[f"{prefix}.out_proj.weight"],
                        p[f"{prefix}.out_proj.bias"])

    def _norm(self, x, p, name, eps=None):
        return layer_norm(x, p[f"{name}.weight"], p[f"{name}.bias"],
                          self.eps if eps is None else eps)

    def transformer(self, image, image_pe, tokens, p: dict, fault=None):
        """TwoWayTransformer: [B, C, g, g] image, its encoding, [B, T, C]
        tokens -> (tokens, image tokens [B, g*g, C])."""
        keys = image.flatten(2).permute(0, 2, 1)
        key_pe = image_pe.flatten(2).permute(0, 2, 1)
        if fault == "no_key_pe":
            key_pe = torch.zeros_like(key_pe)
        queries, query_pe = tokens, tokens
        t = "mask_decoder.transformer"
        for i in range(self.depth):
            b = f"{t}.layers.{i}"
            if i == 0:      # skip_first_layer_pe
                queries = self._attention(queries, queries, queries, p,
                                          f"{b}.self_attn")
            else:
                q = queries + query_pe
                queries = queries + self._attention(q, q, queries, p,
                                                    f"{b}.self_attn")
            queries = self._norm(queries, p, f"{b}.norm1")
            q, k = queries + query_pe, keys + key_pe
            queries = queries + self._attention(
                q, k, keys, p, f"{b}.cross_attn_token_to_image", fault)
            queries = self._norm(queries, p, f"{b}.norm2")
            h = F.relu(F.linear(queries, p[f"{b}.mlp.lin1.weight"],
                                p[f"{b}.mlp.lin1.bias"]))
            queries = queries + F.linear(h, p[f"{b}.mlp.lin2.weight"],
                                         p[f"{b}.mlp.lin2.bias"])
            queries = self._norm(queries, p, f"{b}.norm3")
            if fault != "no_image_to_token":
                q, k = queries + query_pe, keys + key_pe
                keys = keys + self._attention(
                    k, q, queries, p, f"{b}.cross_attn_image_to_token",
                    fault)
            keys = self._norm(keys, p, f"{b}.norm4")
        q, k = queries + query_pe, keys + key_pe
        queries = queries + self._attention(
            q, k, keys, p, f"{t}.final_attn_token_to_image", fault)
        queries = self._norm(queries, p, f"{t}.norm_final_attn", FINAL_EPS)
        return queries, keys

    def _mlp(self, x, p: dict, prefix: str, n: int):
        for i in range(n):
            x = F.linear(x, p[f"{prefix}.layers.{i}.weight"],
                         p[f"{prefix}.layers.{i}.bias"])
            if i < n - 1:
                x = F.relu(x)
        return x

    def _on(self, device) -> dict:
        return {k: v.to(device) for k, v in self.params.items()}

    @torch.no_grad()
    def decode(self, embedding: torch.Tensor, points: torch.Tensor,
               fault: str | None = None) -> tuple:
        """MaskDecoder.predict_masks for single positive points, multimask:
        the [C, g, g] (padded) embedding, [P, 2] float64 points in the
        input frame -> (low-resolution logits [P, M - 1, 4g, 4g], predicted
        IoUs [P, M - 1]), on the embedding's device. ``fault`` plants one
        of ``FAULTS`` (calibration): no image-to-token attention, no
        positional encoding on the image's keys, or the cross attentions
        split without their downsample."""
        if fault not in (None,) + FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        dev = embedding.device
        p = self._on(dev)
        n = points.shape[0]
        sparse = self.embed_points(points.to(dev, torch.float64), p)
        dense = p["prompt_encoder.no_mask_embed.weight"].reshape(
            1, -1, 1, 1).expand(n, -1, self.grid, self.grid)
        m = "mask_decoder"
        out_tokens = torch.cat([p[f"{m}.iou_token.weight"],
                                p[f"{m}.mask_tokens.weight"]], dim=0)
        tokens = torch.cat([out_tokens[None].expand(n, -1, -1), sparse],
                           dim=1)
        src = torch.repeat_interleave(embedding[None], n, dim=0) + dense
        pos = torch.repeat_interleave(self.dense_pe(p)[None], n, dim=0)
        b, c, h, w = src.shape
        hs, src = self.transformer(src, pos, tokens, p, fault)
        iou_out, mask_out = hs[:, 0, :], hs[:, 1:1 + self.n_masks, :]
        src = src.transpose(1, 2).reshape(b, c, h, w)
        up = F.conv_transpose2d(src, p[f"{m}.output_upscaling.0.weight"],
                                p[f"{m}.output_upscaling.0.bias"], stride=2)
        up = F.gelu(layer_norm_2d(up, p[f"{m}.output_upscaling.1.weight"],
                                  p[f"{m}.output_upscaling.1.bias"],
                                  NORM2D_EPS))
        up = F.gelu(F.conv_transpose2d(
            up, p[f"{m}.output_upscaling.3.weight"],
            p[f"{m}.output_upscaling.3.bias"], stride=2))
        hyper = torch.stack([self._mlp(mask_out[:, i, :], p,
                                       f"{m}.output_hypernetworks_mlps.{i}",
                                       3) for i in range(self.n_masks)], 1)
        b, c, h, w = up.shape
        masks = (hyper @ up.reshape(b, c, h * w)).reshape(b, -1, h, w)
        iou = self._mlp(iou_out, p, f"{m}.iou_prediction_head",
                        self.iou_depth)
        return masks[:, 1:], iou[:, 1:]


# ------------------------------------------------------- the generator


def build_point_grid(n_per_side: int) -> np.ndarray:
    """amg.py: [n^2, 2] points evenly spaced in [0, 1]^2, x fastest."""
    offset = 1 / (2 * n_per_side)
    one_side = np.linspace(offset, 1 - offset, n_per_side)
    xs = np.tile(one_side[None, :], (n_per_side, 1))
    ys = np.tile(one_side[:, None], (1, n_per_side))
    return np.stack([xs, ys], axis=-1).reshape(-1, 2)


def preprocess_shape(h: int, w: int, long_side: int) -> tuple:
    """ResizeLongestSide.get_preprocess_shape."""
    scale = long_side * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def image_points(gen: dict, image_hw: tuple) -> np.ndarray:
    """The generator's points in the original frame (x, y), float64."""
    h, w = image_hw
    return build_point_grid(gen["points_per_side"]) * np.array([[w, h]])


def input_points(points: np.ndarray, image_hw: tuple, long_side: int
                 ) -> torch.Tensor:
    """ResizeLongestSide.apply_coords: original-frame points -> the input
    frame, float64."""
    h, w = image_hw
    nh, nw = preprocess_shape(h, w, long_side)
    out = points.astype(np.float64).copy()
    out[..., 0] = out[..., 0] * (nw / w)
    out[..., 1] = out[..., 1] * (nh / h)
    return torch.from_numpy(out)


def postprocess_masks(low_res, input_hw, image_hw, size: int):
    """Sam.postprocess_masks: upsample to the input size, crop to the
    resized image, resize to the original."""
    x = F.interpolate(low_res, (size, size), mode="bilinear",
                      align_corners=False)
    x = x[..., :input_hw[0], :input_hw[1]]
    return F.interpolate(x, image_hw, mode="bilinear", align_corners=False)


def stability_score(masks, threshold: float, offset: float):
    """calculate_stability_score: the IoU of the masks thresholded at
    ``threshold`` +/- ``offset``."""
    inter = (masks > threshold + offset).sum(-1, dtype=torch.int16).sum(
        -1, dtype=torch.int32)
    union = (masks > threshold - offset).sum(-1, dtype=torch.int16).sum(
        -1, dtype=torch.int32)
    return inter / union


def batched_mask_to_box(masks):
    """[N, H, W] bool -> [N, 4] XYXY boxes, inclusive right and bottom;
    an empty mask gives [0, 0, 0, 0]."""
    h, w = masks.shape[-2:]
    rows = torch.max(masks, dim=-1).values
    rows_at = rows * torch.arange(h, device=masks.device)[None, :]
    bottom = torch.max(rows_at, dim=-1).values
    top = torch.min(rows_at + h * (~rows), dim=-1).values
    cols = torch.max(masks, dim=-2).values
    cols_at = cols * torch.arange(w, device=masks.device)[None, :]
    right = torch.max(cols_at, dim=-1).values
    left = torch.min(cols_at + w * (~cols), dim=-1).values
    empty = (right < left) | (bottom < top)
    out = torch.stack([left, top, right, bottom], dim=-1)
    return out * (~empty).unsqueeze(-1)


def near_crop_edge(boxes, crop_box, orig_box, atol: float = 20.0):
    """is_box_near_crop_edge for boxes of the full-image crop (the uncrop
    is the identity)."""
    crop = torch.as_tensor(crop_box, dtype=torch.float, device=boxes.device)
    orig = torch.as_tensor(orig_box, dtype=torch.float, device=boxes.device)
    boxes = boxes.float()
    near_crop = torch.isclose(boxes, crop[None, :], atol=atol, rtol=0)
    near_image = torch.isclose(boxes, orig[None, :], atol=atol, rtol=0)
    return torch.any(near_crop & ~near_image, dim=1)


def box_nms(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> list:
    """Greedy NMS: the kept indices, highest score first; a box falls to a
    kept one whose IoU with it passes ``thresh``."""
    order = np.argsort(-scores)
    b = boxes[order].astype(np.float64)
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    dropped = np.zeros(len(b), bool)
    keep = []
    for i in range(len(b)):
        if dropped[i]:
            continue
        keep.append(int(order[i]))
        x0 = np.maximum(b[i, 0], b[:, 0])
        y0 = np.maximum(b[i, 1], b[:, 1])
        x1 = np.minimum(b[i, 2], b[:, 2])
        y1 = np.minimum(b[i, 3], b[:, 3])
        inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
        iou = inter / np.maximum(area[i] + area - inter, 1e-9)
        dropped |= iou > thresh
    return keep


def batch_records(low_res, iou, points, gen: dict, image_hw: tuple,
                  input_hw: tuple, size: int, fault: str | None = None,
                  passed: list | None = None) -> list:
    """_process_batch of one point batch on the full-image crop: [P, M, h,
    w] low-resolution logits, [P, M] IoUs and the [P, 2] original-frame
    points -> the candidates past the IoU and stability filters and the
    crop-edge test, each (x, y, predicted IoU, stability, area, box); the
    number past both filters is appended to ``passed``. ``fault`` plants
    one of ``SELECTION_FAULTS`` (calibration): the IoU filter left out, or
    the stability score taken at offset 0."""
    masks = postprocess_masks(low_res, input_hw, image_hw, size)
    m = masks.shape[1]
    masks, iou = masks.flatten(0, 1), iou.flatten(0, 1)
    pts = np.repeat(points, m, axis=0)
    keep = torch.ones(len(iou), dtype=torch.bool, device=iou.device)
    if gen["pred_iou_thresh"] > 0.0 and fault != "no_iou_filter":
        keep &= iou > gen["pred_iou_thresh"]
    offset = (0.0 if fault == "no_stability_offset"
              else gen["stability_score_offset"])
    stab = stability_score(masks, MASK_THRESHOLD, offset)
    if gen["stability_score_thresh"] > 0.0:
        keep &= stab >= gen["stability_score_thresh"]
    idx = torch.nonzero(keep)[:, 0]
    if passed is not None:
        passed.append(len(idx))
    binary = masks[idx] > MASK_THRESHOLD
    boxes = batched_mask_to_box(binary)
    h, w = image_hw
    inside = ~near_crop_edge(boxes, [0, 0, w, h], [0, 0, w, h])
    idx, binary, boxes = idx[inside], binary[inside], boxes[inside]
    areas = binary.sum((1, 2)).tolist()
    ious, stabs = iou[idx].tolist(), stab[idx].tolist()
    idx, boxes = idx.tolist(), boxes.tolist()
    return [(float(pts[i][0]), float(pts[i][1]), ious[j], stabs[j],
             int(areas[j]), tuple(int(v) for v in boxes[j]))
            for j, i in enumerate(idx)]


def select(candidates: list, gen: dict, fault: str | None = None) -> list:
    """The crop's box NMS on the predicted IoUs, then the records sorted
    by area, largest first (a stable sort); ``fault == "no_nms"`` leaves
    the NMS out (calibration)."""
    if not candidates:
        return []
    boxes = np.array([c[5] for c in candidates], np.float64)
    scores = np.array([c[2] for c in candidates])
    order = (box_nms(boxes, scores, gen["box_nms_thresh"])
             if fault != "no_nms" else list(np.argsort(-scores)))
    kept = [candidates[i] for i in order]
    return sorted(kept, key=lambda c: -c[4])
