"""The LSeg teacher network on the card.

Port of ``feature3dgs_tpu/encoders/lseg_net.py``, the reimplementation of
the original fork (encoders/lseg_encoder/modules/models/lseg_net.py,
lseg_vit.py, lseg_blocks.py): a timm ``vit_large_patch16_384`` trunk
hooked at blocks [5, 11, 17, 23]; DPT "project" readout and reassemble to
strides /4 /8 /16 /32; four RefineNet fusion blocks (features=256,
batch-norm on); a 1x1 head to the 512-d CLIP-aligned feature space; a final
2x bilinear upsample. The feature-export path needs no text tower, so only
the ``net.pretrained.*`` / ``net.scratch.*`` weights of the official
checkpoint (demo_e200.ckpt) are loaded.

Parameter names are the reference's (``expected_state_dict_keys``), so a
checkpoint or the JAX package's state dict loads strictly. The network is
built on the device (``build_lseg(device=..., generator=...)``: a CPU
init of 300 M parameters costs seconds) and runs in float32.

``export_features`` is the feature export's chain for one image, as
``cli/encode_lseg.py`` runs it: ``encode_features``, the fp16 cast, the
``--stride`` resize and the copy to the host.

Spans (``tracing.py``): ``lseg.encode`` holds ``lseg.preprocess`` (the
upload, the normalisation and each scale's resize), one ``lseg.block`` a
trunk block, ``lseg.reassemble`` (the readouts, 1x1 convolutions and
resamples), ``lseg.fusion`` (the ``layer*_rn`` convolutions and the four
RefineNets) and ``lseg.head`` (``head1`` and the final upsample in the
network; the resize back to the image and the average over the scales);
the patch embedding runs in ``lseg.encode``'s own time. ``lseg.export`` is
the export's cast, resize and copy. Counters: ``lseg.images``,
``lseg.tokens`` (a forward's tokens, the cls token included) and
``host_wait.lseg_upload`` / ``host_wait.lseg_export``, the two places the
host waits on the card.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from feature3dgs_tpu_torch import default_device, tracing

VIT_DIM = 1024
VIT_DEPTH = 24
VIT_HEADS = 16
PATCH = 16
HOOKS = (5, 11, 17, 23)
REASSEMBLE = (256, 512, 1024, 1024)
FEATURES = 256
OUT_C = 512
IMG_SIZE = 384                # timm vit_large_patch16_384 native grid
NORM_MEAN = (0.5, 0.5, 0.5)   # lseg_module.py:37-38
NORM_STD = (0.5, 0.5, 0.5)


def _modules(VIT_DIM=VIT_DIM, VIT_DEPTH=VIT_DEPTH, VIT_HEADS=VIT_HEADS,
             PATCH=PATCH, HOOKS=HOOKS, REASSEMBLE=REASSEMBLE,
             FEATURES=FEATURES, OUT_C=OUT_C, IMG_SIZE=IMG_SIZE):
    """The module classes at the given dims (defaults: the clip_vitl16_384
    config of every reference experiment; tests build a tiny net)."""
    import torch.nn as nn
    import torch.nn.functional as F

    class Mlp(nn.Module):
        def __init__(self, dim, hidden):
            super().__init__()
            self.fc1 = nn.Linear(dim, hidden)
            self.act = nn.GELU()
            self.fc2 = nn.Linear(hidden, dim)

        def forward(self, x):
            return self.fc2(self.act(self.fc1(x)))

    class Attention(nn.Module):
        def __init__(self, dim, heads):
            super().__init__()
            self.num_heads = heads
            self.scale = (dim // heads) ** -0.5
            self.qkv = nn.Linear(dim, dim * 3, bias=True)
            self.proj = nn.Linear(dim, dim)

        def forward(self, x):
            b, n, c = x.shape
            qkv = self.qkv(x).reshape(b, n, 3, self.num_heads,
                                      c // self.num_heads)
            q, k, v = qkv.permute(2, 0, 3, 1, 4)
            attn = (q @ k.transpose(-2, -1)) * self.scale
            attn = attn.softmax(dim=-1)
            x = (attn @ v).transpose(1, 2).reshape(b, n, c)
            return self.proj(x)

    class Block(nn.Module):
        def __init__(self, dim, heads):
            super().__init__()
            # timm builds LayerNorm(eps=1e-6), not torch's default 1e-5
            self.norm1 = nn.LayerNorm(dim, eps=1e-6)
            self.attn = Attention(dim, heads)
            self.norm2 = nn.LayerNorm(dim, eps=1e-6)
            self.mlp = Mlp(dim, dim * 4)

        def forward(self, x):
            x = x + self.attn(self.norm1(x))
            x = x + self.mlp(self.norm2(x))
            return x

    class PatchEmbed(nn.Module):
        def __init__(self):
            super().__init__()
            self.proj = nn.Conv2d(3, VIT_DIM, kernel_size=PATCH,
                                  stride=PATCH)

        def forward(self, x):
            return self.proj(x)

    class ViT(nn.Module):
        """timm vit_large_patch16_384-compatible trunk (the subset
        forward_flex uses; lseg_vit.py:327-364)."""

        def __init__(self):
            super().__init__()
            self.patch_embed = PatchEmbed()
            self.cls_token = nn.Parameter(torch.zeros(1, 1, VIT_DIM))
            self.pos_embed = nn.Parameter(
                torch.zeros(1, (IMG_SIZE // PATCH) ** 2 + 1, VIT_DIM))
            self.blocks = nn.ModuleList(
                [Block(VIT_DIM, VIT_HEADS) for _ in range(VIT_DEPTH)])
            self.norm = nn.LayerNorm(VIT_DIM, eps=1e-6)

        def _resize_pos_embed(self, posemb, gs_h, gs_w):
            # lseg_vit.py:217-233 (start_index=1, bilinear, no corners)
            posemb_tok, posemb_grid = posemb[:, :1], posemb[0, 1:]
            gs_old = int(math.sqrt(posemb_grid.shape[0]))
            grid = posemb_grid.reshape(1, gs_old, gs_old, -1).permute(
                0, 3, 1, 2)
            grid = F.interpolate(grid, size=(gs_h, gs_w), mode="bilinear",
                                 align_corners=False)
            grid = grid.permute(0, 2, 3, 1).reshape(1, gs_h * gs_w, -1)
            return torch.cat([posemb_tok, grid], dim=1)

        def forward_flex(self, x, hooks=HOOKS):
            """The hooked block activations (token sequences with cls):
            forward_flex + the forward hooks of _make_vit_b16_backbone
            (lseg_vit.py:625-631)."""
            b, c, h, w = x.shape
            pos = self._resize_pos_embed(self.pos_embed, h // PATCH,
                                         w // PATCH)
            x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
            cls = self.cls_token.expand(b, -1, -1)
            x = torch.cat((cls, x), dim=1) + pos
            tracing.count("lseg.tokens", x.shape[1])
            acts = {}
            for i, blk in enumerate(self.blocks):
                with tracing.span("lseg.block"):
                    x = blk(x)
                if i in hooks:
                    acts[i] = x
            return [acts[i] for i in hooks]

    class ProjectReadout(nn.Module):
        # lseg_vit.py ProjectReadout: fuse the cls token into every patch
        def __init__(self):
            super().__init__()
            self.project = nn.Sequential(nn.Linear(2 * VIT_DIM, VIT_DIM),
                                         nn.GELU())

        def forward(self, x):
            readout = x[:, 0].unsqueeze(1).expand_as(x[:, 1:])
            return self.project(torch.cat((x[:, 1:], readout), -1))

    class ResidualConvUnit(nn.Module):
        # ResidualConvUnit_custom, bn=True (use_bn=True in LSegNet)
        def __init__(self, features):
            super().__init__()
            self.conv1 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
            self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(features)
            self.bn2 = nn.BatchNorm2d(features)
            self.activation = nn.ReLU(False)

        def forward(self, x):
            out = self.bn1(self.conv1(self.activation(x)))
            out = self.bn2(self.conv2(self.activation(out)))
            return out + x

    class FeatureFusionBlock(nn.Module):
        # FeatureFusionBlock_custom(features, ReLU, deconv=False, bn=True,
        # expand=False, align_corners=True)
        def __init__(self, features):
            super().__init__()
            self.out_conv = nn.Conv2d(features, features, 1, 1, 0, bias=True)
            self.resConfUnit1 = ResidualConvUnit(features)
            self.resConfUnit2 = ResidualConvUnit(features)

        def forward(self, *xs):
            output = xs[0]
            if len(xs) == 2:
                output = output + self.resConfUnit1(xs[1])
            output = self.resConfUnit2(output)
            output = F.interpolate(output, scale_factor=2, mode="bilinear",
                                   align_corners=True)
            return self.out_conv(output)

    class Transpose(nn.Module):
        def __init__(self, a, b):
            super().__init__()
            self.a, self.b = a, b

        def forward(self, x):
            return x.transpose(self.a, self.b)

    class Pretrained(nn.Module):
        """``pretrained`` of _make_vit_b16_backbone: the ViT + the four
        act_postprocess reassemble pipelines (readout -> transpose ->
        [unflatten at runtime] -> 1x1 conv -> resample)."""

        def __init__(self):
            super().__init__()
            self.model = ViT()
            f = REASSEMBLE
            self.act_postprocess1 = nn.Sequential(
                ProjectReadout(), Transpose(1, 2), nn.Identity(),
                nn.Conv2d(VIT_DIM, f[0], 1),
                nn.ConvTranspose2d(f[0], f[0], 4, stride=4))
            self.act_postprocess2 = nn.Sequential(
                ProjectReadout(), Transpose(1, 2), nn.Identity(),
                nn.Conv2d(VIT_DIM, f[1], 1),
                nn.ConvTranspose2d(f[1], f[1], 2, stride=2))
            self.act_postprocess3 = nn.Sequential(
                ProjectReadout(), Transpose(1, 2), nn.Identity(),
                nn.Conv2d(VIT_DIM, f[2], 1))
            self.act_postprocess4 = nn.Sequential(
                ProjectReadout(), Transpose(1, 2), nn.Identity(),
                nn.Conv2d(VIT_DIM, f[3], 1),
                nn.Conv2d(f[3], f[3], 3, stride=2, padding=1))

        def forward(self, x):
            """forward_vit (lseg_vit.py:107-214): hooked activations ->
            readout+transpose -> unflatten -> conv pipelines."""
            b, c, h, w = x.shape
            layers = self.model.forward_flex(x)
            posts = [self.act_postprocess1, self.act_postprocess2,
                     self.act_postprocess3, self.act_postprocess4]
            outs = []
            with tracing.span("lseg.reassemble"):
                for layer, post in zip(layers, posts):
                    t = post[0:2](layer)          # readout + transpose
                    t = t.unflatten(2, (h // PATCH, w // PATCH))
                    t = post[3:](t)               # conv (+ resample)
                    outs.append(t)
            return outs

    class Scratch(nn.Module):
        def __init__(self):
            super().__init__()
            f = FEATURES
            self.layer1_rn = nn.Conv2d(REASSEMBLE[0], f, 3, 1, 1, bias=False)
            self.layer2_rn = nn.Conv2d(REASSEMBLE[1], f, 3, 1, 1, bias=False)
            self.layer3_rn = nn.Conv2d(REASSEMBLE[2], f, 3, 1, 1, bias=False)
            self.layer4_rn = nn.Conv2d(REASSEMBLE[3], f, 3, 1, 1, bias=False)
            self.refinenet1 = FeatureFusionBlock(f)
            self.refinenet2 = FeatureFusionBlock(f)
            self.refinenet3 = FeatureFusionBlock(f)
            self.refinenet4 = FeatureFusionBlock(f)
            self.head1 = nn.Conv2d(f, OUT_C, kernel_size=1)

    class LSegNet(nn.Module):
        """The return_feature=True path of LSeg.forward
        (lseg_net.py:162-196): pixel-aligned 512-d CLIP-space features at
        input resolution (head at /2, output_conv upsamples 2x)."""

        def __init__(self):
            super().__init__()
            self.pretrained = Pretrained()
            self.scratch = Scratch()
            # the original's logit_scale is exp()'d at init into a plain
            # tensor, so it is NOT in checkpoints; constant by design
            self.register_buffer("logit_scale",
                                 torch.tensor(1.0 / 0.07), persistent=False)
            # the input normalisation's constants, made once on the net's
            # device (a tensor made from a list each call is an upload)
            self.register_buffer("norm_mean", torch.tensor(NORM_MEAN).view(
                1, 3, 1, 1), persistent=False)
            self.register_buffer("norm_std", torch.tensor(NORM_STD).view(
                1, 3, 1, 1), persistent=False)

        def forward(self, x):
            l1, l2, l3, l4 = self.pretrained(x)
            s = self.scratch
            with tracing.span("lseg.fusion"):
                l1, l2 = s.layer1_rn(l1), s.layer2_rn(l2)
                l3, l4 = s.layer3_rn(l3), s.layer4_rn(l4)
                p4 = s.refinenet4(l4)
                p3 = s.refinenet3(p4, l3)
                p2 = s.refinenet2(p3, l2)
                p1 = s.refinenet1(p2, l1)
            with tracing.span("lseg.head"):
                feat = s.head1(p1)
                # scratch.output_conv == Interpolate(x2, bilinear, corners)
                return F.interpolate(feat, scale_factor=2, mode="bilinear",
                                     align_corners=True)

    return LSegNet


def build_lseg(device=None, generator: torch.Generator | None = None,
               **dims):
    """LSegNet at the reference config (``dims`` override the architecture
    constants; tests build a tiny net), built on ``default_device(device)``
    in eval mode; with ``generator`` its weights are drawn from it
    (``encoders.seeded_init_``)."""
    dev = default_device(device)
    with torch.device(dev):
        net = _modules(**dims)()
    if generator is not None:
        from feature3dgs_tpu_torch.encoders import seeded_init_
        seeded_init_(net, generator)
    return net.eval()


def load_lseg_checkpoint(path: str | None = None, device=None):
    """LSegNet on ``default_device(device)`` with the ``net.pretrained.*``
    / ``net.scratch.*`` weights of an official LSeg lightning checkpoint
    (demo_e200.ckpt) or an exported state_dict (encode_images.py:329),
    read straight onto the device. None when no checkpoint is available
    (LSEG_WEIGHTS unset)."""
    dev = default_device(device)
    path = path or os.environ.get("LSEG_WEIGHTS")
    if not path or not os.path.exists(path):
        return None
    raw = torch.load(path, map_location=dev, weights_only=False)
    sd = raw.get("state_dict", raw)
    picked = {}
    for k, v in sd.items():
        k = k[4:] if k.startswith("net.") else k
        if k.startswith(("pretrained.", "scratch.")):
            picked[k] = v
    net = build_lseg(dev)
    missing, _ = net.load_state_dict(picked, strict=False)
    # every parameter of the net must come from the checkpoint; its other
    # keys (the CLIP text tower, timm's head) were filtered above
    if missing:
        raise ValueError(f"LSeg checkpoint missing {len(missing)} keys, "
                         f"e.g. {missing[:4]}")
    return net


@torch.no_grad()
def encode_features(img_hw3, net, scales=(1.0,), base: int = 32
                    ) -> torch.Tensor:
    """Image [H,W,3] in [0,1] (numpy or a tensor) -> the float32 512-d
    feature map [512, H, W] on the net's device: the image resized to
    multiples of ``base`` per scale, the net's output resized back and
    averaged over ``scales`` (the reference evaluator uses 0.75/1.0/1.25/
    1.75, encode_images.py:353; resizing stands in for its sliding
    480-crops, as in the JAX package)."""
    import torch.nn.functional as F
    dev = next(net.parameters()).device
    with tracing.span("lseg.encode"):
        tracing.count("lseg.images")
        with tracing.span("lseg.preprocess"):
            x = torch.as_tensor(np.asarray(img_hw3) if not isinstance(
                img_hw3, torch.Tensor) else img_hw3)
            tracing.count("host_wait.lseg_upload")
            x = x.to(dev, torch.float32)
            h, w = x.shape[:2]
            x = (x.permute(2, 0, 1)[None] - net.norm_mean) / net.norm_std
        acc = None
        for s in scales:
            with tracing.span("lseg.preprocess"):
                hs = max(base, int(round(h * s / base)) * base)
                ws = max(base, int(round(w * s / base)) * base)
                xs = F.interpolate(x, size=(hs, ws), mode="bilinear",
                                   align_corners=False)
            f = net(xs)
            with tracing.span("lseg.head"):
                f = F.interpolate(f, size=(h, w), mode="bilinear",
                                  align_corners=False)
                acc = f if acc is None else acc + f
        with tracing.span("lseg.head"):
            return (acc / len(scales))[0]


def encode_image(img_hw3, net=None, scales=(1.0,), base: int = 32,
                 device=None) -> torch.Tensor:
    """``encode_features`` cast to float16 (the reference's
    ``<name>_fmap_CxHxW.pt`` contract, encode_images.py:478-481), on the
    net's device; without ``net`` the LSEG_WEIGHTS checkpoint on
    ``default_device(device)``."""
    if net is None:
        net = load_lseg_checkpoint(device=device)
        if net is None:
            raise RuntimeError("no LSeg weights: set LSEG_WEIGHTS")
    return encode_features(img_hw3, net, scales, base).to(torch.float16)


def export_features(img_hw3, net, scales=(1.0,), stride: int = 1
                    ) -> torch.Tensor:
    """One image's teacher map as the export saves it, on the host:
    ``encode_image``'s fp16 map; with ``stride`` > 1 that map resized in
    float32 to (H // stride, W // stride) (bilinear, no aligned corners)
    and cast to fp16 again; contiguous. The copy waits on the card."""
    import torch.nn.functional as F
    fmap = encode_features(img_hw3, net, scales)
    with tracing.span("lseg.export"):
        fmap = fmap.to(torch.float16)
        if stride > 1:
            hw = (fmap.shape[1] // stride, fmap.shape[2] // stride)
            fmap = F.interpolate(fmap.float()[None], size=hw,
                                 mode="bilinear", align_corners=False
                                 )[0].to(torch.float16)
        tracing.count("host_wait.lseg_export")
        return fmap.contiguous().cpu()


def expected_state_dict_keys() -> list[str]:
    """Every parameter and buffer key of the net (the checkpoint's names),
    from a net built on the meta device (no memory, no init)."""
    return sorted(build_lseg("meta").state_dict())
