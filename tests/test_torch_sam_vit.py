"""SAM ViT-H's image encoder on the port's normal path
(``encoders/sam_encoder.py:build_sam``) against the benchmark's plain
reference (``port_bench/reference/sam_vit.py``, plain torch written from
segment-anything's description) at a tiny width on the CPU, with weights
the reference draws and the port loads strictly; the reference's name map,
preprocess and crop; the yardstick's
operation count (``port_bench/yardstick/vit.py``) against torch's own
count; and the encoder's spans and counters.

The tiny encoder: width 32, 4 heads, 4 blocks with 1 and 3 global, 3 x 3
windows over an 8 x 8 grid (padded to 9 x 9), a 128 x 128 input.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from feature3dgs_tpu_torch import tracing
from feature3dgs_tpu_torch.encoders import sam_encoder
from port_bench.reference import sam_vit as V
from port_bench.yardstick import vit

from tests.torch_helpers import CPU, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
            global_attn_indexes=[1, 3], window_size=3, image_size=128,
            patch_size=16, output_channels=16, mlp_dim=64)
BAR = 1e-5          # program against reference, max-normalised
# one 8-bit level in normalised units at the narrowest channel (std 0.224)
LEVEL = 1 / (255 * 0.224)


def _image(h=800, w=1216, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)
                                               ).astype(np.uint8)


def _err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def tiny():
    """(SamModel, processor, the reference with the weights it drew and
    the model loaded, the processor's pixels of a 1216 x 800 image), as
    the benchmark's ``encode`` entry pairs them."""
    net = V.SamViT(**TINY).draw(torch.Generator().manual_seed(7))
    model, proc = sam_encoder.build_sam(CPU, **TINY)
    model.vision_encoder.load_state_dict(net.port_state(), strict=True)
    pixels = proc(images=_image(), return_tensors="pt")["pixel_values"]
    return model, proc, net, pixels


def test_tiny_encoder_matches_the_reference(tiny):
    """The whole g x g embedding, and encode_image's crop of it, within
    1e-5 of the reference on the same pixels and weights."""
    model, proc, net, pixels = tiny
    with torch.no_grad():
        full = model.get_image_embeddings(pixels)[0]
    assert full.shape == (16, 8, 8)
    assert _err(full, net.embed(pixels, CPU)) <= BAR
    emb = sam_encoder.encode_image(_image(), (model, proc))
    ref = net.export(pixels, (800, 1216), CPU)
    assert emb.shape == ref.shape == (16, 5, 8)
    assert emb.dtype == torch.float32
    assert _err(emb, ref) <= BAR


@pytest.mark.parametrize("fault", V.FAULTS)
def test_the_comparison_fails_on_a_planted_fault(tiny, fault):
    """The relative-position terms left out, the first windowed block run
    as a global one, or the middle block skipped: each moves the embedding
    a thousand times past the bar."""
    model, _, net, pixels = tiny
    with torch.no_grad():
        full = model.get_image_embeddings(pixels)[0]
    assert _err(full, net.embed(pixels, CPU, fault)) > 1e3 * BAR


def test_drawn_weights_are_nonzero_and_load_strictly(tiny):
    """Every drawn entry is nonzero (biases and the position embedding
    too), the port's state after the load is the draw, the draw repeats
    from its seed, and the port's strict load refuses a state with a key
    left out."""
    model, _, net, _ = tiny
    assert all(bool((t != 0).all()) for t in net.params.values())
    state = model.vision_encoder.state_dict()
    for port, ours in net.name_map().items():
        assert torch.equal(state[port], net.params[ours]), port
    again = V.SamViT(**TINY).draw(torch.Generator().manual_seed(7))
    assert all(torch.equal(again.params[k], v)
               for k, v in net.params.items())
    short = net.port_state()
    del short["layers.1.attn.rel_pos_h"]
    fresh, _ = sam_encoder.build_sam(CPU, **TINY)
    with pytest.raises(RuntimeError, match="rel_pos_h"):
        fresh.vision_encoder.load_state_dict(short, strict=True)


def test_name_map_takes_every_port_key_to_one_parameter(tiny):
    model, _, net, _ = tiny
    names = net.name_map()
    assert set(names) == set(model.vision_encoder.state_dict())
    assert sorted(names.values()) == sorted(net.shapes())


@pytest.mark.parametrize("case", ["missing", "extra", "shape"])
def test_name_map_is_strict(tiny, case):
    """A key left out, a key the map does not know, or a shape that is not
    the reference's: the load raises."""
    model, *_ = tiny
    state = dict(model.vision_encoder.state_dict())
    if case == "missing":
        del state["layers.2.attn.rel_pos_w"]
    elif case == "extra":
        state["layers.2.attn.rel_pos_d"] = state["layers.2.attn.rel_pos_w"]
    else:   # a windowed block's tables given a global block's length
        state["layers.0.attn.rel_pos_h"] = state["layers.1.attn.rel_pos_h"]
    with pytest.raises((KeyError, ValueError)):
        V.SamViT(**TINY).load(state)


def test_build_sam_defaults_are_the_configuration(tiny):
    """``VIT_H`` is the benchmark configuration's widths, the tiny build
    took everything it was not given from it, and the reference's shapes at
    those widths count the configuration's parameters."""
    cfg = json.loads((ROOT / "port_bench/configs/sam_vith.json").read_text())
    assert sam_encoder.VIT_H == cfg["vision"]
    assert cfg["reduced"] == []
    vision = tiny[0].config.vision_config
    for k, v in cfg["vision"].items():
        assert getattr(vision, k) == TINY.get(k, v), k
    assert (vision.hidden_act, vision.layer_norm_eps, vision.qkv_bias,
            vision.use_abs_pos, vision.use_rel_pos) == ("gelu", 1e-6, True,
                                                        True, True)
    shapes = V.SamViT(**cfg["vision"]).shapes()
    assert sum(int(np.prod(s)) for s in shapes.values()) == cfg["parameters"]
    assert shapes["blocks.0.attn.rel_pos_h"] == (27, 80)
    assert shapes["blocks.7.attn.rel_pos_w"] == (127, 80)


def test_reference_preprocess_matches_the_processor():
    """The reference's resize, normalisation and padding against
    SamProcessor at 1024 on a 1216 x 800 image: every value within one
    8-bit level (PIL's fixed-point resize against torch's), at most 15% of
    them off at all, the padding exactly zero in both. The crop covering
    that image is 42 x 64."""
    img = _image()
    a = sam_encoder.processor(1024)(images=img,
                                    return_tensors="pt")["pixel_values"]
    b = V.preprocess(torch.from_numpy(img), 1024)
    assert a.shape == b.shape == (1, 3, 1024, 1024)
    d = (a - b).abs()
    assert float(d.max()) <= LEVEL * (1 + 1e-4)
    assert float((d > 1e-4).float().mean()) <= 0.15
    assert not a[..., 674:, :].any() and not b[..., 674:, :].any()
    assert V.crop_hw(800, 1216, 64) == (42, 64)
    assert V.crop_hw(1216, 800, 64) == (64, 42)


def test_yardstick_counts_the_reference_products(tiny):
    """yardstick/vit.py's count at the tiny width equals FlopCounterMode's
    count of the reference's matrix products and convolutions."""
    from torch.utils.flop_counter import FlopCounterMode
    _, _, net, pixels = tiny
    with FlopCounterMode(display=False) as fc:
        net.embed(pixels, CPU)
    assert fc.get_total_flops() == vit.image_ops(TINY)


def test_encode_records_its_spans_and_counters(tiny):
    """Under ``recording()``: one encode and one export give sam.encode,
    sam.preprocess, a span a block by its kind and the neck's, and the
    image and wait counters."""
    model, proc, *_ = tiny
    with tracing.recording() as session:
        emb = sam_encoder.encode_image(_image(), (model, proc))
        host = sam_encoder.export_embedding(emb)
    assert host.dtype == torch.float16 and host.device.type == "cpu"
    s = session.summary()
    counts = {k: v["count"] for k, v in s["spans"].items()}
    assert counts == {"sam.encode": 1, "sam.preprocess": 1,
                      "sam.window_block": 2, "sam.global_block": 2,
                      "sam.neck": 1}
    assert s["counters"] == {"sam.images": 1, "host_wait.sam_upload": 1,
                             "host_wait.sam_embedding": 1}
    enc = s["spans"]["sam.encode"]
    assert enc["host_self_ms"] < enc["host_ms"]


def test_encode_records_nothing_off(tiny):
    model, proc, *_ = tiny
    before = tracing.last_session()
    sam_encoder.encode_image(_image(), (model, proc))
    assert tracing.last_session() is before
    assert tracing._stack() == []


def test_span_calls_closes_its_span_when_the_call_raises():
    class Fails(torch.nn.Module):
        def forward(self, x):
            raise RuntimeError("fails")

    m = Fails()
    handles = tracing.span_calls(m, "fails")
    with tracing.recording() as session:
        with pytest.raises(RuntimeError):
            m(torch.zeros(1))
        assert tracing._stack() == []
    assert session.summary()["spans"]["fails"]["count"] == 1
    for h in handles:
        h.remove()
