"""SAM's prompt encoder, two-way mask decoder and automatic mask generator
on the port's normal path (``encoders/sam_encoder.py:build_sam``,
``encoders/sam_decode.py``) against the benchmark's plain reference
(``port_bench/reference/sam_mask_decoder.py``, plain torch written from
segment-anything's code) at a tiny width on the CPU, with weights the
reference draws and the port loads strictly; the reference's name map and
planted faults; the yardstick's operation count
(``port_bench/yardstick/sam_decoder.py``) against torch's own count; and
the decoder's spans and counters.

The tiny model: a 2-block vision encoder of width 32 (never run), a 16 x 16
embedding grid (input 256), decoder width 32 with 2 heads, MLP 64, the
published depth, downsample and heads of the outputs; 4 x 4 points on a
96 x 64 image.
"""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from feature3dgs_tpu_torch import tracing
from feature3dgs_tpu_torch.encoders import sam_decode, sam_encoder
from port_bench.reference import sam_mask_decoder as D
from port_bench.yardstick import sam_decoder as Y

from tests.torch_helpers import CPU, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "port_bench/configs/sam64_speedup.json")
                    .read_text())
VISION = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
              global_attn_indexes=[1], window_size=4, image_size=256,
              patch_size=16, output_channels=32, mlp_dim=64, num_pos_feats=16)
PROMPT = dict(CONFIG["prompt_encoder"], hidden_size=32, image_size=256)
DECODER = dict(CONFIG["mask_decoder"], hidden_size=32, mlp_dim=64,
               num_attention_heads=2, iou_head_hidden_dim=32)
DRAW = dict(hyper_out_scale=256.0, iou_out_shift=0.9)
GEN = dict(CONFIG["generator"], points_per_side=4, points_per_batch=8)
IMAGE_HW = (64, 96)
CROP = (11, 16)        # round(16 * 64 / 96) rows of the 16 x 16 grid
BAR = 1e-5             # program against reference, max-normalised
IOU_BAR = 1e-5


def _err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _embedding(seed=0) -> torch.Tensor:
    """A [32, 11, 16] embedding: a smooth field plus noise, as a decoded
    render is."""
    g = torch.Generator().manual_seed(seed)
    ys = torch.linspace(0, 1, CROP[0])[:, None]
    xs = torch.linspace(0, 1, CROP[1])[None, :]
    freq = torch.randn((32, 2), generator=g) * 3
    phase = torch.rand((32, 1, 1), generator=g) * 6.28
    field = torch.sin(freq[:, :1, None] * ys + freq[:, 1:, None] * xs
                      + phase)
    return field + 0.3 * torch.randn((32,) + CROP, generator=g)


@pytest.fixture(scope="module")
def tiny():
    """(SamModel, processor, the reference with the weights it drew, which
    the model loaded part by part)."""
    net = D.SamDecoder(PROMPT, DECODER).draw(
        torch.Generator().manual_seed(5), **DRAW)
    model, proc = sam_encoder.build_sam(CPU, prompt_encoder=PROMPT,
                                        mask_decoder=DECODER, **VISION)
    for part in ("shared_image_embedding", "prompt_encoder", "mask_decoder"):
        getattr(model, part).load_state_dict(net.port_state(part),
                                             strict=True)
    return model, proc, net


def _points(n_side=4):
    return D.image_points(dict(GEN, points_per_side=n_side), IMAGE_HW)


def _reference_batch(net, emb, pts):
    """The reference's (low-resolution logits, IoUs) of single points in
    the original frame."""
    inp = D.input_points(pts, IMAGE_HW, PROMPT["image_size"])
    padded = torch.zeros((32, net.grid, net.grid))
    padded[:, :CROP[0], :CROP[1]] = emb
    return net.decode(padded, inp)


def test_decode_point_batch_matches_the_reference(tiny):
    """_decode_point_batch's low-resolution logits (the model's own
    output), its logits at the image's size and its IoUs, within 1e-5 of
    the reference's on the same embedding, points and weights."""
    model, proc, net = tiny
    emb, pts = _embedding(), _points()
    seen = []
    hook = model.register_forward_hook(
        lambda m, a, o: seen.append(o.pred_masks[0]))
    try:
        logits, iou = sam_decode._decode_point_batch(emb, IMAGE_HW, pts,
                                                     (model, proc))
    finally:
        hook.remove()
    low, ref_iou = _reference_batch(net, emb, pts)
    assert seen[0].shape == low.shape == (16, 3, 64, 64)
    assert _err(seen[0], low) <= BAR
    input_hw = D.preprocess_shape(*IMAGE_HW, PROMPT["image_size"])
    ref = D.postprocess_masks(low, input_hw, IMAGE_HW, PROMPT["image_size"])
    assert logits.shape == ref.shape == (16, 3) + IMAGE_HW
    assert _err(logits, ref) <= BAR
    assert float((iou - ref_iou).abs().max()) <= IOU_BAR


def test_postprocess_is_segment_anythings_on_the_logits_device(tiny):
    """postprocess_masks equals the processor's post_process_masks at
    1024 (transformers' form on the CPU) and the reference's."""
    _, proc, _ = tiny
    low = torch.randn((4, 3, 256, 256),
                      generator=torch.Generator().manual_seed(1))
    ours = sam_decode.postprocess_masks(low, (674, 1024), (800, 1216), 1024)
    theirs = proc.image_processor.post_process_masks(
        low[None], [(800, 1216)], [(674, 1024)], binarize=False,
        pad_size={"height": 1024, "width": 1024})[0]
    ref = D.postprocess_masks(low, (674, 1024), (800, 1216), 1024)
    assert torch.equal(ours, theirs) and torch.equal(ours, ref)
    assert D.preprocess_shape(800, 1216, 1024) == (674, 1024)


def _program_records(recs):
    out = []
    for r in recs:
        x0, y0, w, h = r["bbox"]
        out.append((r["point_coords"][0][0], r["point_coords"][0][1],
                    r["area"], (x0, y0, x0 + w, y0 + h)))
    return out


def _reference_records(net, emb, gen):
    size = PROMPT["image_size"]
    input_hw = D.preprocess_shape(*IMAGE_HW, size)
    pts = D.image_points(gen, IMAGE_HW)
    ppb, cands, ious = gen["points_per_batch"], [], []
    for s in range(0, len(pts), ppb):
        low, iou = _reference_batch(net, emb, pts[s:s + ppb])
        cands += D.batch_records(low, iou, pts[s:s + ppb], gen, IMAGE_HW,
                                 input_hw, size)
    recs = D.select(cands, gen)
    return [(c[0], c[1], c[4], c[5]) for c in recs], [c[2] for c in recs]


@pytest.mark.parametrize("thresholds", [(0.88, 0.95), (-10.0, 0.0)],
                         ids=["published", "unfiltered"])
def test_auto_masks_records_match_the_reference_generator(tiny, thresholds):
    """auto_masks on one embedding: the records, in order, with the
    reference generator's on the same embedding and weights: the same
    points, areas and boxes, IoUs within 1e-5. With the published filters
    some candidates pass and NMS drops some of them; unfiltered, every
    candidate reaches NMS."""
    model, proc, net = tiny
    emb = _embedding()
    gen = dict(GEN, pred_iou_thresh=thresholds[0],
               stability_score_thresh=thresholds[1])
    recs = sam_decode.auto_masks(
        emb, IMAGE_HW, points_per_side=gen["points_per_side"],
        points_per_batch=gen["points_per_batch"],
        pred_iou_thresh=gen["pred_iou_thresh"],
        stability_thresh=gen["stability_score_thresh"],
        box_nms_thresh=gen["box_nms_thresh"], sam=(model, proc))
    ref, ref_iou = _reference_records(net, emb, gen)
    assert _program_records(recs) == ref
    assert max(abs(r["predicted_iou"] - i)
               for r, i in zip(recs, ref_iou)) <= IOU_BAR
    assert 0 < len(recs) < 48
    for r in recs:
        assert r["segmentation"].shape == IMAGE_HW
        assert int(r["segmentation"].sum()) == r["area"]


def test_reference_selection_on_the_program_logits_is_exact(tiny):
    """The reference's filters, boxes and NMS run on the program's own
    low-resolution logits and IoUs give the program's records exactly:
    the decisions are discrete and the inputs the same."""
    model, proc, net = tiny
    emb, gen = _embedding(3), GEN
    seen = []
    hook = model.register_forward_hook(
        lambda m, a, o: seen.append((o.pred_masks[0], o.iou_scores[0])))
    try:
        recs = sam_decode.auto_masks(
            emb, IMAGE_HW, points_per_side=4, points_per_batch=8,
            sam=(model, proc))
    finally:
        hook.remove()
    size = PROMPT["image_size"]
    input_hw = D.preprocess_shape(*IMAGE_HW, size)
    pts = D.image_points(gen, IMAGE_HW)
    cands = []
    for b, (low, iou) in enumerate(seen):
        cands += D.batch_records(low, iou, pts[8 * b:8 * b + 8], gen,
                                 IMAGE_HW, input_hw, size)
    ref = D.select(cands, gen)
    assert [(r["point_coords"][0][0], r["point_coords"][0][1],
             r["predicted_iou"], r["area"]) for r in recs] == \
        [c[:3] + (c[4],) for c in ref]
    assert recs


@pytest.mark.parametrize("fault", D.FAULTS)
def test_a_planted_fault_moves_the_logits(tiny, fault):
    """No image-to-token attention, no positional encoding on the image's
    keys, or the cross attentions without their downsample: each moves
    the low-resolution logits a thousand times past the bar."""
    model, proc, net = tiny
    emb, pts = _embedding(), _points()
    low, _ = _reference_batch(net, emb, pts)
    inp = D.input_points(pts, IMAGE_HW, PROMPT["image_size"])
    padded = torch.zeros((32, net.grid, net.grid))
    padded[:, :CROP[0], :CROP[1]] = emb
    bad, _ = net.decode(padded, inp, fault)
    assert _err(bad, low) > 1e3 * BAR


def test_drawn_weights_load_strictly_and_repeat(tiny):
    """Every drawn entry is nonzero, the port's state after the load is the
    draw (both keys of the random-Fourier matrix), the draw repeats from
    its seed, the two factors touch only their layers, and a strict load of
    a state with a key left out raises."""
    model, _, net = tiny
    assert all(bool((t != 0).all()) for t in net.params.values())
    state = model.state_dict()
    for port, ours in net.name_map().items():
        assert torch.equal(state[port], net.params[ours]), port
    plain = D.SamDecoder(PROMPT, DECODER).draw(
        torch.Generator().manual_seed(5))
    changed = {k for k in plain.params
               if not torch.equal(plain.params[k], net.params[k])}
    assert changed == {f"mask_decoder.output_hypernetworks_mlps.{i}.layers."
                       f"2.{w}" for i in range(4) for w in ("weight", "bias")
                       } | {"mask_decoder.iou_prediction_head.layers.2.bias"}
    short = net.port_state("mask_decoder")
    del short["transformer.layers.1.cross_attn_image_to_token.k_proj.bias"]
    fresh, _ = sam_encoder.build_sam(CPU, prompt_encoder=PROMPT,
                                     mask_decoder=DECODER, **VISION)
    with pytest.raises(RuntimeError, match="k_proj.bias"):
        fresh.mask_decoder.load_state_dict(short, strict=True)


@pytest.mark.parametrize("case", ["missing", "extra", "shape", "split"])
def test_name_map_is_strict(tiny, case):
    """The map takes every port key of the three modules to a parameter and
    covers every parameter; ``load`` refuses a key left out, a key it does
    not know, a shape not the reference's, and the two keys of the
    random-Fourier matrix disagreeing."""
    model, _, net = tiny
    state = {k: v for k, v in model.state_dict().items()
             if not k.startswith("vision_encoder.")}
    assert set(net.name_map()) == set(state)
    assert set(net.name_map().values()) == set(net.shapes())
    D.SamDecoder(PROMPT, DECODER).load(state)
    if case == "missing":
        del state["mask_decoder.iou_token.weight"]
    elif case == "extra":
        state["mask_decoder.iou_token.bias"] = state[
            "mask_decoder.iou_token.weight"][0]
    elif case == "shape":
        state["mask_decoder.mask_tokens.weight"] = state[
            "mask_decoder.mask_tokens.weight"][:3]
    else:
        key = "prompt_encoder.shared_embedding.positional_embedding"
        state[key] = state[key] + 1
    with pytest.raises((KeyError, ValueError)):
        D.SamDecoder(PROMPT, DECODER).load(state)


def test_configuration_is_the_published_decoder():
    """The configuration's prompt encoder and mask decoder are
    transformers' defaults, segment-anything's published widths; its
    generator settings are SamAutomaticMaskGenerator's defaults; nothing is
    cut; the yardstick counts ~2.8 GFLOP a point and 0.8 GFLOP once a
    call, and the decoder is bound by its operations: the least it moves
    (its weights and the embedding read, every mask token's logits and the
    IoUs written) takes under 1% of their time."""
    from transformers import SamMaskDecoderConfig, SamPromptEncoderConfig
    for cls, key in ((SamPromptEncoderConfig, "prompt_encoder"),
                     (SamMaskDecoderConfig, "mask_decoder")):
        published = cls()
        for k, v in CONFIG[key].items():
            assert getattr(published, k) == v, (key, k)
    assert CONFIG["generator"] == dict(
        points_per_side=32, points_per_batch=64, pred_iou_thresh=0.88,
        stability_score_thresh=0.95, stability_score_offset=1.0,
        box_nms_thresh=0.7, crop_n_layers=0)
    assert CONFIG["reduced"] == [] and CONFIG["teacher_grid"] == [42, 64]
    pe, md = CONFIG["prompt_encoder"], CONFIG["mask_decoder"]
    per_point = Y.point_ops(pe, md)
    assert 2.7e9 < per_point < 2.9e9
    assert Y.shared_ops(pe, md) == 3 * 2 * 4096 * 256 * 128
    assert Y.view_ops(CONFIG) == 1024 * per_point + 16 * Y.call_ops(pe, md)
    from port_bench.yardstick.peaks import PEAK_BYTES, PEAK_F32_FLOPS
    params = sum(math.prod(s) for s in D.SamDecoder(pe, md).shapes().values())
    assert 4.0e6 < params < 4.1e6
    least_bytes = 4 * (params + 256 * 4096 + 64 * 4 * (16 * 4096 + 1))
    assert least_bytes / PEAK_BYTES < \
        0.01 * Y.decode_ops(pe, md, 64) / PEAK_F32_FLOPS


def test_yardstick_counts_the_reference_products(tiny):
    """yardstick/sam_decoder.py's count of one call at the tiny width,
    with the work it counts once a call added for every other prompt (the
    reference, as the port, repeats it a prompt), equals FlopCounterMode's
    count of the reference's products and transposed convolutions."""
    from torch.utils.flop_counter import FlopCounterMode
    _, _, net = tiny
    emb, pts = _embedding(), _points()
    with FlopCounterMode(display=False) as fc:
        _reference_batch(net, emb, pts)
    assert fc.get_total_flops() == Y.decode_ops(PROMPT, DECODER, len(pts)) \
        + (len(pts) - 1) * Y.shared_ops(PROMPT, DECODER)


def test_auto_masks_records_its_spans_and_counters(tiny, monkeypatch):
    """Under ``recording()``, one call over 4 x 4 points in batches of 8:
    ``sam.decode`` once a batch, ``sam.postprocess`` once a batch and once
    for the masks the crop's NMS kept, ``sam.select`` once a batch, once a
    crop and once a call; ``sam.prompts`` 16, ``sam.candidates`` the
    candidates past both filters, ``sam.masks`` the records; each
    ``host_wait`` site once a read: the candidates' table once a batch,
    the NMS once a round and once more, its kept indices once (on the CPU
    nothing is uploaded)."""
    model, proc, _ = tiny
    rounds = []
    real_equal = torch.equal

    def equal(a, b):
        rounds.append(1)
        return real_equal(a, b)

    monkeypatch.setattr(sam_decode.torch, "equal", equal)
    with tracing.recording() as session:
        recs = sam_decode.auto_masks(_embedding(), IMAGE_HW,
                                     points_per_side=4, points_per_batch=8,
                                     sam=(model, proc))
    s = session.summary()
    counts = {k: v["count"] for k, v in s["spans"].items()}
    assert counts == {"sam.decode": 2, "sam.postprocess": 2 + 1,
                      "sam.select": 2 + 1 + 1}
    ctr = s["counters"]
    assert ctr["sam.prompts"] == 16
    _, ref_iou = _reference_records(tiny[2], _embedding(), GEN)
    assert ctr["sam.candidates"] >= len(ref_iou) > 0
    assert ctr["sam.masks"] == len(recs) == len(ref_iou)
    waits = {k: v for k, v in ctr.items() if k.startswith("host_wait.")}
    assert waits == {"host_wait.sam_candidates": 2,
                     "host_wait.sam_nms": len(rounds) + 1,
                     "host_wait.sam_nms_keep": 1}


def test_candidates_count_the_reference_filters(tiny):
    """``sam.candidates`` is the reference's count of candidates past both
    filters on the same embedding and weights, at the published filters
    and with neither."""
    model, proc, net = tiny
    emb = _embedding()
    size = PROMPT["image_size"]
    input_hw = D.preprocess_shape(*IMAGE_HW, size)
    pts = _points()
    for iou_t, stab_t in ((0.88, 0.95), (-10.0, 0.0)):
        gen = dict(GEN, pred_iou_thresh=iou_t, stability_score_thresh=stab_t)
        passed = []
        for s in range(0, 16, 8):
            low, iou = _reference_batch(net, emb, pts[s:s + 8])
            D.batch_records(low, iou, pts[s:s + 8], gen, IMAGE_HW, input_hw,
                            size, passed=passed)
        with tracing.recording() as session:
            sam_decode.auto_masks(emb, IMAGE_HW, points_per_side=4,
                                  points_per_batch=8, pred_iou_thresh=iou_t,
                                  stability_thresh=stab_t, sam=(model, proc))
        assert session.summary()["counters"]["sam.candidates"] == sum(passed)
    assert 0 < sum(passed) == 48


def test_decode_masks_records_one_decode_and_postprocess(tiny):
    model, proc, _ = tiny
    with tracing.recording() as session:
        masks, iou = sam_decode.decode_masks(_embedding(), IMAGE_HW,
                                             points=[[10, 20]],
                                             sam=(model, proc))
    s = session.summary()
    assert masks.shape == (3,) + IMAGE_HW and masks.dtype == torch.bool
    assert {k: v["count"] for k, v in s["spans"].items()} == {
        "sam.decode": 1, "sam.postprocess": 1}
    assert s["counters"] == {"sam.prompts": 1}


def test_pad_embedding_takes_the_models_grid(tiny):
    model, _, _ = tiny
    out = sam_decode.pad_embedding(_embedding(), CPU, 16)
    assert out.shape == (1, 32, 16, 16)
    assert not out[0, :, CROP[0]:].any() and not out[0, :, :, CROP[1]:].any()
    assert sam_decode._sizes(model) == (256, 16)
    assert math.isclose(float(out[0, 0, 0, 0]), float(_embedding()[0, 0, 0]))
    assert np.array_equal(sam_decode.pad_embedding(
        np.zeros((4, 2, 3), np.float32), CPU).shape, (1, 4, 64, 64))


@pytest.mark.parametrize("fault", D.SELECTION_FAULTS)
def test_a_planted_selection_fault_moves_the_selection(tiny, fault):
    """The IoU filter left out, the stability score at offset 0, or no
    NMS: each changes the reference's candidates past both filters or its
    records on the same logits, at the published filters."""
    _, _, net = tiny
    emb, pts = _embedding(), _points()
    size = PROMPT["image_size"]
    input_hw = D.preprocess_shape(*IMAGE_HW, size)
    low, iou = _reference_batch(net, emb, pts)
    readings = []
    for f in (None, fault):
        passed = []
        cands = D.batch_records(low, iou, pts, GEN, IMAGE_HW, input_hw, size,
                                f, passed)
        readings.append((passed, D.select(cands, GEN, f)))
    assert readings[0] != readings[1]
    assert 0 < readings[0][0][0] < 48
