"""LSeg's image network (a ViT-L/16 trunk and a DPT head, backbone
``clip_vitl16_384``) in plain torch and float32, written from the published
description: isl-org/lang-seg ``modules/models/lseg_vit.py``
(``_make_pretrained_clip_vitl16_384``, ``_make_vit_b16_backbone``,
``forward_vit``, ``forward_flex``, ``_resize_pos_embed``,
``ProjectReadout``), ``lseg_blocks.py`` (``_make_scratch``,
``FeatureFusionBlock_custom``, ``ResidualConvUnit_custom``,
``Interpolate``), ``lseg_net.py`` (``LSeg``, ``LSegNet``: 256 features,
batch-norm on, the "project" readout, hooks at blocks 5, 11, 17, 23) and
timm's ``vit_large_patch16_384`` block (pre-norm, LayerNorm eps 1e-6, qkv
bias, GELU MLP of 4x the width). It imports neither ``timm`` nor the
program, and runs every product and convolution in full float32 (TF32 off;
the control turns it on around a call).

What it computes: the teacher map of Feature 3DGS's export
(``encoders/lseg_encoder/encode_images.py``, the network's
``return_feature`` path): ``head1``'s channels upsampled 2x by
``scratch.output_conv`` (bilinear, aligned corners), with no text tower and
no per-pixel normalisation. ``encode`` runs it as the port's export does:
the [0, 1] image normalised with mean and std 0.5, resized per scale to
multiples of 32, the output resized back and averaged over the scales;
``export`` then casts to fp16, resizes by the stride in float32 and casts
again.

Departures from the paper's export, shared with both packages: the
reference evaluator averages scales 0.75/1.0/1.25/1.75 over sliding
480-crops with flips (encode_images.py:353); the packages resize the whole
image per scale instead, and the benchmark runs one scale, the CLI's
default. Two parts of the checkpoint do no work on this path and are drawn
all the same: the trunk's final LayerNorm (``forward_vit`` reads the hooked
blocks' outputs) and ``refinenet4``'s first residual unit (the deepest
fusion block has no skip input).

Weights: ``draw`` fills every parameter and batch-norm statistic, by
LSeg's names, from a seeded generator; ``port_state`` hands them to the
port through ``name_map``, the identity, since the port keeps the
checkpoint's names. The weights come from here, not from the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NORM_MEAN = (0.5, 0.5, 0.5)     # lseg_module.py's input normalisation
NORM_STD = (0.5, 0.5, 0.5)
BASE = 32                       # each scale's size: a multiple of this
BN_EPS = 1e-5                   # nn.BatchNorm2d's
FAULTS = ("nearest_pos_embed", "ignore_readout", "early_hooks",
          "bn_no_stats", "fusion_no_corners")
EXPORT_FAULT = "stride_corners"
# the drawn weights' spreads: the position embedding, the cls token and
# the biases; layer-norm scales about 1; batch-norm's affine terms and
# running means
VECTOR_STD = 0.02
NORM_STD_DRAW = 0.1
RUNNING_VAR = (0.5, 2.0)


def scaled_hw(h: int, w: int, scale: float) -> tuple:
    """The network's input size for an h x w image at ``scale``: each side
    rounded to a multiple of ``BASE``, at least ``BASE``."""
    return (max(BASE, int(round(h * scale / BASE)) * BASE),
            max(BASE, int(round(w * scale / BASE)) * BASE))


def batch_norm(x, p: dict, pre: str, stats: bool = True):
    """Inference batch-norm with running statistics (with ``stats`` False,
    a planted fault: mean 0 and variance 1 in their place)."""
    c = x.shape[1]
    mean, var = ((p[pre + "running_mean"], p[pre + "running_var"]) if stats
                 else (torch.zeros(c, device=x.device),
                       torch.ones(c, device=x.device)))
    return F.batch_norm(x, mean, var, p[pre + "weight"], p[pre + "bias"],
                        training=False, eps=BN_EPS)


def residual_unit(x, p: dict, pre: str, stats: bool = True):
    """ResidualConvUnit_custom with batch-norm: ReLU, 3x3 convolution (no
    bias), batch-norm, twice, plus the input."""
    out = batch_norm(F.conv2d(F.relu(x), p[pre + "conv1.weight"],
                              padding=1), p, pre + "bn1.", stats)
    out = batch_norm(F.conv2d(F.relu(out), p[pre + "conv2.weight"],
                              padding=1), p, pre + "bn2.", stats)
    return out + x


class LSegDPT:
    """The network at the given widths (the port's ``build_lseg`` keywords,
    lower-cased); ``params`` holds its weights by LSeg's names, on the
    host."""

    def __init__(self, *, vit_dim, vit_depth, vit_heads, patch, hooks,
                 reassemble, features, out_c, img_size, mlp_ratio=4,
                 layer_norm_eps=1e-6):
        self.d, self.depth, self.heads = vit_dim, vit_depth, vit_heads
        self.patch, self.hooks = patch, tuple(hooks)
        self.f, self.feat, self.out_c = tuple(reassemble), features, out_c
        self.grid = img_size // patch
        self.mlp, self.eps = mlp_ratio * vit_dim, layer_norm_eps
        self.params: dict = {}

    def shapes(self) -> dict:
        """Every parameter's and batch-norm statistic's shape, by LSeg's
        name (``num_batches_tracked`` a 0-d integer)."""
        d, p, f, c = self.d, self.patch, self.f, self.feat
        m = "pretrained.model."
        s = {m + "cls_token": (1, 1, d),
             m + "pos_embed": (1, self.grid ** 2 + 1, d),
             m + "patch_embed.proj.weight": (d, 3, p, p),
             m + "patch_embed.proj.bias": (d,)}
        for i in range(self.depth):
            for k, shape in (("norm1.weight", (d,)), ("norm1.bias", (d,)),
                             ("attn.qkv.weight", (3 * d, d)),
                             ("attn.qkv.bias", (3 * d,)),
                             ("attn.proj.weight", (d, d)),
                             ("attn.proj.bias", (d,)),
                             ("norm2.weight", (d,)), ("norm2.bias", (d,)),
                             ("mlp.fc1.weight", (self.mlp, d)),
                             ("mlp.fc1.bias", (self.mlp,)),
                             ("mlp.fc2.weight", (d, self.mlp)),
                             ("mlp.fc2.bias", (d,))):
                s[f"{m}blocks.{i}.{k}"] = shape
        s[m + "norm.weight"], s[m + "norm.bias"] = (d,), (d,)
        # the resamples: 4x4/s4 and 2x2/s2 transposed, none, 3x3/s2
        resample = {1: (f[0], f[0], 4, 4), 2: (f[1], f[1], 2, 2),
                    4: (f[3], f[3], 3, 3)}
        for k in range(1, 5):
            a = f"pretrained.act_postprocess{k}."
            s[a + "0.project.0.weight"] = (d, 2 * d)
            s[a + "0.project.0.bias"] = (d,)
            s[a + "3.weight"], s[a + "3.bias"] = (f[k - 1], d, 1, 1), (
                f[k - 1],)
            if k in resample:
                s[a + "4.weight"] = resample[k]
                s[a + "4.bias"] = (f[k - 1],)
        for k in range(1, 5):
            s[f"scratch.layer{k}_rn.weight"] = (c, f[k - 1], 3, 3)
        for r in range(1, 5):
            pre = f"scratch.refinenet{r}."
            s[pre + "out_conv.weight"], s[pre + "out_conv.bias"] = (
                (c, c, 1, 1), (c,))
            for u in (1, 2):
                unit = f"{pre}resConfUnit{u}."
                for j in (1, 2):
                    s[f"{unit}conv{j}.weight"] = (c, c, 3, 3)
                    for t in ("weight", "bias", "running_mean",
                              "running_var"):
                        s[f"{unit}bn{j}.{t}"] = (c,)
                    s[f"{unit}bn{j}.num_batches_tracked"] = ()
        s["scratch.head1.weight"], s["scratch.head1.bias"] = (
            (self.out_c, c, 1, 1), (self.out_c,))
        return s

    def name_map(self) -> dict:
        """The port's state-dict key -> this network's name: the identity,
        since the port keeps LSeg's checkpoint names."""
        return {k: k for k in self.shapes()}

    def draw(self, generator: torch.Generator) -> "LSegDPT":
        """Every entry drawn from ``generator``, on its device, in
        ``shapes()``'s order, and kept on the host: matrices and kernels
        ~ N(0, 1/fan_in) (fan_in = numel / shape[0]); the position
        embedding, the cls token and every bias outside batch-norm ~ N(0,
        VECTOR_STD^2); layer-norm scales ~ 1 + N(0, NORM_STD_DRAW^2);
        batch-norm scales ~ 1 + N(0, NORM_STD_DRAW^2), shifts and running
        means ~ N(0, NORM_STD_DRAW^2), running variances ~ U(RUNNING_VAR);
        ``num_batches_tracked`` 0, not drawn. No drawn entry is zero, and
        batch-norm's statistics are not the identity's, so a term a
        network leaves out moves its answer."""
        dev = generator.device
        params = {}
        for name, shape in self.shapes().items():
            if name.endswith("num_batches_tracked"):
                params[name] = torch.zeros((), dtype=torch.long)
                continue
            t = torch.empty(shape, device=dev)
            bn = ".bn" in name
            if name.endswith("running_var"):
                t.uniform_(*RUNNING_VAR, generator=generator)
            elif name.endswith("running_mean") or (bn and
                                                   name.endswith("bias")):
                t.normal_(0.0, NORM_STD_DRAW, generator=generator)
            elif len(shape) >= 2 and not name.endswith(("pos_embed",
                                                        "cls_token")):
                t.normal_(0.0, (t.numel() / shape[0]) ** -0.5,
                          generator=generator)
            elif len(shape) == 1 and name.endswith("weight"):
                t.normal_(1.0, NORM_STD_DRAW, generator=generator)
            else:
                t.normal_(0.0, VECTOR_STD, generator=generator)
            params[name] = t.cpu()
        self.params = params
        return self

    def port_state(self) -> dict:
        """These weights as the port's state dict (through ``name_map``),
        for its strict ``load_state_dict``."""
        return {port: self.params[ours]
                for port, ours in self.name_map().items()}

    # ------------------------------------------------------------ forward

    def _pos_embed(self, p: dict, gh: int, gw: int, nearest: bool):
        """_resize_pos_embed: the cls entry kept, the grid resized
        bilinearly (no aligned corners) to gh x gw; ``nearest`` plants a
        nearest-neighbour resize."""
        pos = p["pretrained.model.pos_embed"]
        tok, grid = pos[:, :1], pos[0, 1:]
        g = int(math.sqrt(grid.shape[0]))
        grid = grid.reshape(1, g, g, -1).permute(0, 3, 1, 2)
        if nearest:
            grid = F.interpolate(grid, size=(gh, gw), mode="nearest")
        else:
            grid = F.interpolate(grid, size=(gh, gw), mode="bilinear",
                                 align_corners=False)
        grid = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
        return torch.cat([tok, grid], dim=1)

    def _block(self, x, p: dict, pre: str):
        """timm's pre-norm block: global multi-head attention, then the
        GELU MLP, each added to the stream."""
        b, n, d = x.shape
        hd = d // self.heads
        y = F.layer_norm(x, (d,), p[pre + "norm1.weight"],
                         p[pre + "norm1.bias"], self.eps)
        qkv = F.linear(y, p[pre + "attn.qkv.weight"],
                       p[pre + "attn.qkv.bias"])
        q, k, v = qkv.reshape(b, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        a = torch.matmul(q, k.transpose(-2, -1)) * hd ** -0.5
        a = a.softmax(dim=-1)
        y = torch.matmul(a, v).transpose(1, 2).reshape(b, n, d)
        x = x + F.linear(y, p[pre + "attn.proj.weight"],
                         p[pre + "attn.proj.bias"])
        y = F.layer_norm(x, (d,), p[pre + "norm2.weight"],
                         p[pre + "norm2.bias"], self.eps)
        y = F.linear(F.gelu(F.linear(y, p[pre + "mlp.fc1.weight"],
                                     p[pre + "mlp.fc1.bias"])),
                     p[pre + "mlp.fc2.weight"], p[pre + "mlp.fc2.bias"])
        return x + y

    def _trunk(self, x, p: dict, fault):
        """forward_flex with the hooks: the token sequences (cls first)
        after each hooked block."""
        m = "pretrained.model."
        b, _, h, w = x.shape
        gh, gw = h // self.patch, w // self.patch
        pos = self._pos_embed(p, gh, gw, fault == "nearest_pos_embed")
        x = F.conv2d(x, p[m + "patch_embed.proj.weight"],
                     p[m + "patch_embed.proj.bias"], stride=self.patch)
        x = x.flatten(2).transpose(1, 2)
        cls = p[m + "cls_token"].expand(b, -1, -1)
        x = torch.cat((cls, x), dim=1) + pos
        hooks = (tuple(i - 1 for i in self.hooks) if fault == "early_hooks"
                 else self.hooks)
        acts = {}
        for i in range(self.depth):
            x = self._block(x, p, f"{m}blocks.{i}.")
            if i in hooks:
                acts[i] = x
        return [acts[i] for i in hooks], (gh, gw)

    def _reassemble(self, acts: list, gh: int, gw: int, p: dict, fault):
        """Each hooked sequence: the readout (cls concatenated, Linear
        2d -> d, GELU; the "ignore" readout, cls dropped, as a fault), the
        tokens back to a gh x gw map, a 1x1 convolution, the resample."""
        outs = []
        for k, t in enumerate(acts, 1):
            a = f"pretrained.act_postprocess{k}."
            if fault == "ignore_readout":
                t = t[:, 1:]
            else:
                readout = t[:, :1].expand_as(t[:, 1:])
                t = F.gelu(F.linear(torch.cat((t[:, 1:], readout), -1),
                                    p[a + "0.project.0.weight"],
                                    p[a + "0.project.0.bias"]))
            t = t.transpose(1, 2).unflatten(2, (gh, gw))
            t = F.conv2d(t, p[a + "3.weight"], p[a + "3.bias"])
            if k == 1:
                t = F.conv_transpose2d(t, p[a + "4.weight"], p[a + "4.bias"],
                                       stride=4)
            elif k == 2:
                t = F.conv_transpose2d(t, p[a + "4.weight"], p[a + "4.bias"],
                                       stride=2)
            elif k == 4:
                t = F.conv2d(t, p[a + "4.weight"], p[a + "4.bias"], stride=2,
                             padding=1)
            outs.append(t)
        return outs

    def _fusion(self, x, skip, p: dict, r: int, fault):
        """FeatureFusionBlock_custom: the skip through the first residual
        unit added, the second unit, a 2x bilinear upsample with aligned
        corners (without them, a fault), a 1x1 convolution."""
        pre = f"scratch.refinenet{r}."
        stats = fault != "bn_no_stats"
        if skip is not None:
            x = x + residual_unit(skip, p, pre + "resConfUnit1.", stats)
        x = residual_unit(x, p, pre + "resConfUnit2.", stats)
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=fault != "fusion_no_corners")
        return F.conv2d(x, p[pre + "out_conv.weight"],
                        p[pre + "out_conv.bias"])

    @torch.no_grad()
    def forward(self, x, device, fault=None) -> torch.Tensor:
        """[1, 3, H, W] normalised pixels (H, W multiples of 32) -> [1,
        out_c, H, W]. ``fault`` plants one of ``FAULTS`` (calibration):
        the position embedding resized by nearest neighbour, the "ignore"
        readout, the hooks one block early, batch-norm without its running
        statistics, or the fusion upsample without aligned corners."""
        if fault not in (None,) + FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        p = {k: v.to(device) for k, v in self.params.items()}
        acts, (gh, gw) = self._trunk(x.to(device, torch.float32), p, fault)
        l1, l2, l3, l4 = self._reassemble(acts, gh, gw, p, fault)
        del acts
        rn = [F.conv2d(t, p[f"scratch.layer{k}_rn.weight"], padding=1)
              for k, t in enumerate((l1, l2, l3, l4), 1)]
        del l1, l2, l3, l4
        out = self._fusion(rn[3], None, p, 4, fault)
        out = self._fusion(out, rn[2], p, 3, fault)
        out = self._fusion(out, rn[1], p, 2, fault)
        out = self._fusion(out, rn[0], p, 1, fault)
        del rn
        out = F.conv2d(out, p["scratch.head1.weight"], p["scratch.head1.bias"])
        return F.interpolate(out, scale_factor=2, mode="bilinear",
                             align_corners=True)

    @torch.no_grad()
    def encode(self, image, device, scales=(1.0,), fault=None,
               outputs: list | None = None) -> torch.Tensor:
        """[H, W, 3] float32 image in [0, 1] -> the float32 map [out_c, H,
        W] on ``device``: normalised, resized per scale to
        ``scaled_hw``, ``forward``, then ``merge``. Each scale's
        ``forward`` output [out_c, ., .] is appended to ``outputs``."""
        x = image.to(device, torch.float32).permute(2, 0, 1)[None]
        mean = torch.tensor(NORM_MEAN, device=device).view(1, 3, 1, 1)
        std = torch.tensor(NORM_STD, device=device).view(1, 3, 1, 1)
        x = (x - mean) / std
        h, w = x.shape[2:]
        fs = [self.forward(F.interpolate(x, size=scaled_hw(h, w, s),
                                         mode="bilinear",
                                         align_corners=False),
                           device, fault)[0] for s in scales]
        if outputs is not None:
            outputs.extend(fs)
        return merge(fs, h, w)


def merge(outputs: list, h: int, w: int) -> torch.Tensor:
    """Each scale's ``forward`` output [out_c, ., .] resized back to h x w
    (bilinear, no aligned corners) and averaged: the map [out_c, h, w]."""
    acc = None
    for f in outputs:
        f = F.interpolate(f[None], size=(h, w), mode="bilinear",
                          align_corners=False)
        acc = f if acc is None else acc + f
    return (acc / len(outputs))[0]


def export(fmap: torch.Tensor, stride: int, fault=None) -> torch.Tensor:
    """The export's chain on a float32 map [C, H, W]: the fp16 cast; with
    ``stride`` > 1 a float32 bilinear resize to (H // stride, W // stride)
    without aligned corners (with them, the planted ``EXPORT_FAULT``) and
    a second cast."""
    if fault not in (None, EXPORT_FAULT):
        raise ValueError(f"unknown export fault {fault!r}")
    out = fmap.to(torch.float16)
    if stride > 1:
        hw = (fmap.shape[1] // stride, fmap.shape[2] // stride)
        out = F.interpolate(out.float()[None], size=hw, mode="bilinear",
                            align_corners=fault == EXPORT_FAULT
                            )[0].to(torch.float16)
    return out
