"""SAM's ViT image encoder (ViT-H at the published widths) in plain torch and
float32, written from the published description: segment-anything
``modeling/image_encoder.py`` (``ImageEncoderViT``, ``Block``,
``Attention``, ``window_partition``, ``window_unpartition``,
``get_rel_pos``, ``add_decomposed_rel_pos``), ``modeling/common.py``
(``LayerNorm2d``) and ``export_image_embeddings.py:74-83`` (the crop to the
image's aspect). It imports neither ``transformers`` nor the program, and
runs every product in full float32 (TF32 off; the control turns it on around
a call).

Where it starts: the benchmark hands it the padded, normalised pixel tensor
the program's processor produced, so that the check holds the network, not
two resizers, to each other. Its own ``preprocess`` (resize the long side to
the input size, normalise with SAM's pixel mean and std, pad at the bottom
right) is held against the processor separately, in tests.

Weights: ``draw`` fills every parameter, by segment-anything's names, from
a seeded generator, and ``port_state`` renames them through the inverse of
``name_map`` to the port's ``vision_encoder`` state dict, which the program
loads strictly; so the weights come from here, not from the program.
``load`` takes a port state dict the other way, as strictly: every key is
used and every parameter set. ``embed`` moves one block's weights to the
device at a time, so that it fits beside whatever else the device holds.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
FAULTS = ("no_rel_pos", "window_as_global", "skip_block")
# the drawn weights' spreads: the position embedding and every bias, and
# the norm scales about 1
VECTOR_STD = 0.02
NORM_STD = 0.1


def preprocess(image: torch.Tensor, size: int, mode: str = "bilinear"
               ) -> torch.Tensor:
    """[H,W,3] uint8 -> [1,3,size,size] float32: the long side resized to
    ``size`` (bilinear with antialiasing, rounded back to whole levels as an
    8-bit resize does), normalised, zero-padded at the bottom and right.
    ``mode="nearest"`` is a planted fault (calibration): a resize that
    takes the nearest pixel."""
    h, w = image.shape[:2]
    scale = size / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    x = image.permute(2, 0, 1)[None].float()
    if mode == "nearest":
        x = F.interpolate(x, size=(nh, nw), mode="nearest")
    else:
        x = F.interpolate(x, size=(nh, nw), mode="bilinear",
                          align_corners=False, antialias=True)
    x = x.round().clamp(0, 255)
    mean = torch.tensor(PIXEL_MEAN).view(1, 3, 1, 1)
    std = torch.tensor(PIXEL_STD).view(1, 3, 1, 1)
    x = (x - mean) / std
    return F.pad(x, (0, size - nw, 0, size - nh))


def crop_hw(h: int, w: int, grid: int) -> tuple:
    """The embedding rows and columns that cover an h x w image in a grid x
    grid embedding: grid * short/long along the short side."""
    if h > w:
        return grid, max(1, round(grid * w / h))
    if w > h:
        return max(1, round(grid * h / w)), grid
    return grid, grid


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def layer_norm_2d(x, w, b, eps):
    """LayerNorm over the channels of [B, C, H, W]."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return w[:, None, None] * x + b[:, None, None]


def window_partition(x, ws: int):
    """[B, H, W, C] -> [B * windows, ws, ws, C], zero-padded to whole
    windows; and the padded (H, W)."""
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(windows, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // ws // ws)
    x = windows.view(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w, :]


def get_rel_pos(q_size: int, k_size: int, rel_pos):
    """The relative-position rows for every (query, key) pair along one
    axis: [q_size, k_size, head_dim], the table linearly resized when its
    length is not 2 * max(q_size, k_size) - 1."""
    n = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != n:
        rel_pos = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1)
                                .permute(0, 2, 1), size=n, mode="linear")
        rel_pos = rel_pos.reshape(-1, n).permute(1, 0)
    dev = rel_pos.device
    q = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
    k = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
    rel = (q - k) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, hw):
    """Logits [B, HW, HW] plus the height and width terms of each query's
    (unscaled) product with its relative-position rows."""
    h, w = hw
    rh, rw = get_rel_pos(h, h, rel_pos_h), get_rel_pos(w, w, rel_pos_w)
    b, _, dim = q.shape
    r_q = q.reshape(b, h, w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    attn = (attn.view(b, h, w, h, w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :])
    return attn.view(b, h * w, h * w)


def attention(x, p: dict, heads: int, rel_pos: bool = True):
    """Multi-head self-attention over each [H, W] map of [B, H, W, C]."""
    b, h, w, _ = x.shape
    qkv = F.linear(x, p["attn.qkv.weight"], p["attn.qkv.bias"])
    qkv = qkv.reshape(b, h * w, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, b * heads, h * w, -1).unbind(0)
    scale = q.shape[-1] ** -0.5
    attn = torch.matmul(q * scale, k.transpose(-2, -1))
    if rel_pos:
        attn = add_decomposed_rel_pos(attn, q, p["attn.rel_pos_h"],
                                      p["attn.rel_pos_w"], (h, w))
    attn = attn.softmax(dim=-1)
    x = torch.matmul(attn, v).view(b, heads, h, w, -1)
    x = x.permute(0, 2, 3, 1, 4).reshape(b, h, w, -1)
    return F.linear(x, p["attn.proj.weight"], p["attn.proj.bias"])


class SamViT:
    """The encoder at the given SamVisionConfig widths; ``params`` holds its
    weights by segment-anything's names, on the host."""

    def __init__(self, *, hidden_size, num_hidden_layers, num_attention_heads,
                 global_attn_indexes, window_size, image_size, patch_size,
                 output_channels, mlp_dim, layer_norm_eps=1e-6):
        self.d, self.depth, self.heads = (hidden_size, num_hidden_layers,
                                          num_attention_heads)
        self.globals = set(global_attn_indexes)
        self.window, self.patch = window_size, patch_size
        self.grid = image_size // patch_size
        self.out, self.mlp, self.eps = output_channels, mlp_dim, layer_norm_eps
        self.params: dict = {}

    def window_of(self, i: int) -> int:
        """Block ``i``'s window side; 0 for a global block."""
        return 0 if i in self.globals else self.window

    def shapes(self) -> dict:
        """Every parameter's shape, by segment-anything's name."""
        d, g, c, hd = self.d, self.grid, self.out, self.d // self.heads
        s = {"patch_embed.proj.weight": (d, 3, self.patch, self.patch),
             "patch_embed.proj.bias": (d,), "pos_embed": (1, g, g, d)}
        for i in range(self.depth):
            side = self.window_of(i) or g
            for k, shape in (("norm1.weight", (d,)), ("norm1.bias", (d,)),
                             ("attn.qkv.weight", (3 * d, d)),
                             ("attn.qkv.bias", (3 * d,)),
                             ("attn.proj.weight", (d, d)),
                             ("attn.proj.bias", (d,)),
                             ("attn.rel_pos_h", (2 * side - 1, hd)),
                             ("attn.rel_pos_w", (2 * side - 1, hd)),
                             ("norm2.weight", (d,)), ("norm2.bias", (d,)),
                             ("mlp.lin1.weight", (self.mlp, d)),
                             ("mlp.lin1.bias", (self.mlp,)),
                             ("mlp.lin2.weight", (d, self.mlp)),
                             ("mlp.lin2.bias", (d,))):
                s[f"blocks.{i}.{k}"] = shape
        s.update({"neck.0.weight": (c, d, 1, 1), "neck.1.weight": (c,),
                  "neck.1.bias": (c,), "neck.2.weight": (c, c, 3, 3),
                  "neck.3.weight": (c,), "neck.3.bias": (c,)})
        return s

    def name_map(self) -> dict:
        """The port's ``vision_encoder`` state-dict key -> this encoder's
        parameter name."""
        m = {"patch_embed.projection.weight": "patch_embed.proj.weight",
             "patch_embed.projection.bias": "patch_embed.proj.bias",
             "pos_embed": "pos_embed",
             "neck.conv1.weight": "neck.0.weight",
             "neck.layer_norm1.weight": "neck.1.weight",
             "neck.layer_norm1.bias": "neck.1.bias",
             "neck.conv2.weight": "neck.2.weight",
             "neck.layer_norm2.weight": "neck.3.weight",
             "neck.layer_norm2.bias": "neck.3.bias"}
        for i in range(self.depth):
            for port, ours in (("layer_norm1", "norm1"),
                               ("layer_norm2", "norm2"),
                               ("attn.qkv", "attn.qkv"),
                               ("attn.proj", "attn.proj"),
                               ("mlp.lin1", "mlp.lin1"),
                               ("mlp.lin2", "mlp.lin2")):
                for t in ("weight", "bias"):
                    m[f"layers.{i}.{port}.{t}"] = f"blocks.{i}.{ours}.{t}"
            for t in ("rel_pos_h", "rel_pos_w"):
                m[f"layers.{i}.attn.{t}"] = f"blocks.{i}.attn.{t}"
        return m

    def draw(self, generator: torch.Generator) -> "SamViT":
        """Every parameter drawn from ``generator``, on its device, in
        ``shapes()``'s order, and kept on the host as float32: matrices,
        kernels and relative-position tables ~ N(0, 1/fan_in) (fan_in =
        numel / shape[0]), the position embedding and biases ~ N(0,
        VECTOR_STD^2), norm scales ~ 1 + N(0, NORM_STD^2). No entry is zero,
        so a term that a network leaves out moves its answer."""
        params = {}
        for name, shape in self.shapes().items():
            t = torch.empty(shape, device=generator.device)
            if len(shape) >= 2 and name != "pos_embed":
                t.normal_(0.0, (t.numel() / shape[0]) ** -0.5,
                          generator=generator)
            elif name.endswith("weight"):
                t.normal_(1.0, NORM_STD, generator=generator)
            else:
                t.normal_(0.0, VECTOR_STD, generator=generator)
            params[name] = t.cpu()
        self.params = params
        return self

    def port_state(self) -> dict:
        """These weights as the port's ``vision_encoder`` state dict (the
        inverse of ``name_map``), for its strict ``load_state_dict``."""
        return {port: self.params[ours]
                for port, ours in self.name_map().items()}

    def load(self, port_state: dict) -> "SamViT":
        """Take the port's weights, strictly: every key of ``port_state``
        maps to a parameter of this shape, and every parameter is set
        once. Kept on the host as float32."""
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
            params[ours] = t.detach().to("cpu", torch.float32)
        if set(params) != set(shapes):
            raise KeyError("parameters left unset: "
                           f"{sorted(set(shapes) - set(params))[:3]}")
        self.params = params
        return self

    def _on(self, prefix: str, device) -> dict:
        """The parameters under ``prefix``, on ``device``, without it."""
        n = len(prefix)
        return {k[n:]: v.to(device) for k, v in self.params.items()
                if k.startswith(prefix)}

    @torch.no_grad()
    def embed(self, pixels: torch.Tensor, device, fault: str | None = None
              ) -> torch.Tensor:
        """[1,3,S,S] normalised, padded pixels -> [C, g, g] embedding.
        ``fault`` plants one of ``FAULTS`` (calibration): the
        relative-position terms left out of every block, the first windowed
        block run as a global one, or the middle block skipped."""
        if fault not in (None,) + FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        first_windowed = min(i for i in range(self.depth)
                             if i not in self.globals)
        p = self._on("patch_embed.proj.", device)
        x = F.conv2d(pixels.to(device, torch.float32), p["weight"],
                     p["bias"], stride=self.patch).permute(0, 2, 3, 1)
        x = x + self.params["pos_embed"].to(device)
        for i in range(self.depth):
            if fault == "skip_block" and i == self.depth // 2:
                continue
            p = self._on(f"blocks.{i}.", device)
            ws = self.window_of(i)
            if fault == "window_as_global" and i == first_windowed:
                ws = 0
            shortcut = x
            x = layer_norm(x, p["norm1.weight"], p["norm1.bias"], self.eps)
            if ws:
                hw = x.shape[1:3]
                x, pad_hw = window_partition(x, ws)
            x = attention(x, p, self.heads, rel_pos=fault != "no_rel_pos")
            if ws:
                x = window_unpartition(x, ws, pad_hw, hw)
            x = shortcut + x
            y = layer_norm(x, p["norm2.weight"], p["norm2.bias"], self.eps)
            y = F.linear(F.gelu(F.linear(y, p["mlp.lin1.weight"],
                                         p["mlp.lin1.bias"])),
                         p["mlp.lin2.weight"], p["mlp.lin2.bias"])
            x = x + y
            del p, shortcut, y
        p = self._on("neck.", device)
        x = x.permute(0, 3, 1, 2)
        x = layer_norm_2d(F.conv2d(x, p["0.weight"]), p["1.weight"],
                          p["1.bias"], self.eps)
        x = layer_norm_2d(F.conv2d(x, p["2.weight"], padding=1),
                          p["3.weight"], p["3.bias"], self.eps)
        return x[0]

    def export(self, pixels, image_hw, device, fault=None) -> torch.Tensor:
        """``embed`` cropped to an image of ``image_hw`` (its size before
        the resize), as the export saves it before the fp16 cast."""
        rows, cols = crop_hw(*image_hw, self.grid)
        return self.embed(pixels, device, fault)[:, :rows, :cols]
