"""SAM's prompt encoder, mask decoder and automatic mask generator on the
card at the published widths (``port_bench/configs/sam64_speedup.json``:
width 256, 2 two-way blocks of 8 heads at inner width 128, MLP 2048, a
64 x 64 embedding, 32 x 32 points in batches of 64), against the plain
reference (``port_bench/reference/sam_mask_decoder.py``) on the same card,
with the weights it draws loaded strictly (the configuration's draw
factors). The vision encoder is built with 2 blocks: it never runs.

Needs an NVIDIA GPU: marked ``cuda`` and skipped elsewhere. On the card,
run without the JAX-side conftest:

    python -m pytest --noconftest -m cuda \
        tests/test_torch_sam_decode_cuda.py -q
"""
import json
import os
import warnings
from collections import Counter
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "port_bench/configs/sam64_speedup.json")
                    .read_text())
IMAGE_HW = (CONFIG["height"], CONFIG["width"])
# the benchmark cell's limits on the same statistics (limits/
# segment_sam64su_auto.json), over f32 GEMMs and SDPA against plain products
LIMITS = json.loads((ROOT / "port_bench/limits/segment_sam64su_auto.json")
                    .read_text())


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def published(dev):
    """(SamModel, processor, the reference) at the published decoder
    widths, the reference's weights loaded part by part."""
    os.environ.setdefault("USE_TF", "0")
    from feature3dgs_tpu_torch.encoders import sam_encoder
    from port_bench.reference import sam_mask_decoder as D
    net = D.SamDecoder(CONFIG["prompt_encoder"], CONFIG["mask_decoder"]).draw(
        torch.Generator(dev).manual_seed(11), **CONFIG["draw"])
    model, proc = sam_encoder.build_sam(
        dev, prompt_encoder=CONFIG["prompt_encoder"],
        mask_decoder=CONFIG["mask_decoder"], num_hidden_layers=2,
        global_attn_indexes=[1])
    for part in ("shared_image_embedding", "prompt_encoder", "mask_decoder"):
        getattr(model, part).load_state_dict(net.port_state(part),
                                             strict=True)
    return model, proc, net


def _embedding(dev, seed=0):
    """A [256, 42, 64] embedding: a smooth field plus noise."""
    g = torch.Generator(dev).manual_seed(seed)
    h, w = CONFIG["teacher_grid"]
    ys = torch.linspace(0, 1, h, device=dev)[:, None]
    xs = torch.linspace(0, 1, w, device=dev)[None, :]
    freq = torch.randn((256, 2), generator=g, device=dev) * 3
    field = torch.sin(freq[:, :1, None] * ys + freq[:, 1:, None] * xs)
    return 0.1 * (field + 0.3 * torch.randn((256, h, w), generator=g,
                                            device=dev))


def _gap(a, r) -> float:
    d = (a.double() - r.double()).abs().flatten()
    rms = float(torch.sqrt(torch.mean(r.double() ** 2)))
    return float(torch.quantile(d.cpu(), 0.999)) / rms


def test_one_batch_at_published_widths_matches_the_reference(dev, published):
    """The first 64 points: the model's low-resolution logits [64, 3, 256,
    256] and IoUs against the reference within the cell's limits, and the
    program's post-processing of its own logits equal to the reference's,
    bit for bit."""
    from feature3dgs_tpu_torch.encoders import sam_decode
    from port_bench.reference import sam_mask_decoder as D
    model, proc, net = published
    emb = _embedding(dev)
    pts = D.image_points(CONFIG["generator"], IMAGE_HW)[:64]
    seen = []
    hook = model.register_forward_hook(
        lambda m, a, o: seen.append((o.pred_masks[0], o.iou_scores[0])))
    try:
        logits, iou = sam_decode._decode_point_batch(emb, IMAGE_HW, pts,
                                                     (model, proc))
    finally:
        hook.remove()
    low, own_iou = seen[0]
    padded = torch.zeros((256, 64, 64), device=dev)
    padded[:, :42] = emb
    ref, ref_iou = net.decode(padded, D.input_points(pts, IMAGE_HW, 1024))
    assert low.shape == ref.shape == (64, 3, 256, 256)
    assert _gap(low, ref) <= LIMITS["logit_gap"]
    assert float((iou - ref_iou).abs().max()) <= LIMITS["iou_gap"]
    assert torch.equal(iou, own_iou)
    input_hw = D.preprocess_shape(*IMAGE_HW, 1024)
    assert logits.device.type == "cuda"
    assert torch.equal(logits, D.postprocess_masks(low, input_hw, IMAGE_HW,
                                                   1024))


def test_a_view_counts_1024_prompts_and_its_host_reads(dev, published):
    """auto_masks over the published 32 x 32 points: 1,024 prompts in 16
    model calls, 16 post-processings and one for the kept masks, masks on
    the card, each of its record's area, and the
    ``host_wait`` counters' sum equal to the host calls that waited on the
    card (CUDA's sync debug mode) in the same call made again."""
    from feature3dgs_tpu_torch import tracing
    from feature3dgs_tpu_torch.encoders import sam_decode
    model, proc, _ = published
    emb = _embedding(dev, 1)
    g = CONFIG["generator"]
    kw = dict(points_per_side=g["points_per_side"],
              points_per_batch=g["points_per_batch"],
              pred_iou_thresh=g["pred_iou_thresh"],
              stability_thresh=g["stability_score_thresh"],
              box_nms_thresh=g["box_nms_thresh"], sam=(model, proc))
    sam_decode.auto_masks(emb, IMAGE_HW, **kw)        # warm
    with tracing.recording() as session:
        recs = sam_decode.auto_masks(emb, IMAGE_HW, **kw)
    s = session.summary()
    assert s["counters"]["sam.prompts"] == 1024
    assert s["spans"]["sam.decode"]["count"] == 16
    assert s["spans"]["sam.postprocess"]["count"] == 16 + bool(recs)
    assert s["counters"]["sam.masks"] == len(recs)
    for r in recs:
        assert r["segmentation"].device.type == "cuda"
        assert int(r["segmentation"].sum()) == r["area"]
    waits = sum(v for k, v in s["counters"].items()
                if k.startswith("host_wait."))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            again = sam_decode.auto_masks(emb, IMAGE_HW, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = Counter(f"{os.path.basename(w.filename)}:{w.lineno}"
                    for w in caught
                    if "synchronizing CUDA operation" in str(w.message))
    assert len(again) == len(recs)
    assert waits == sum(sites.values()), (s["counters"], sites)


def test_peak_memory_does_not_follow_the_candidates(dev, published):
    """The card's peak over a view is the same, to 64 MiB, whether the
    published filters pass some candidates or no filter drops any: only
    the low-resolution logits and the kept masks outlive a point batch."""
    from feature3dgs_tpu_torch.encoders import sam_decode
    model, proc, _ = published
    emb = _embedding(dev, 2)
    g = CONFIG["generator"]
    peaks, passed = [], []
    for iou_t, stab_t in ((g["pred_iou_thresh"],
                           g["stability_score_thresh"]), (-1e9, 0.0)):
        kw = dict(points_per_side=g["points_per_side"],
                  points_per_batch=g["points_per_batch"],
                  pred_iou_thresh=iou_t, stability_thresh=stab_t,
                  box_nms_thresh=g["box_nms_thresh"], sam=(model, proc))
        sam_decode.auto_masks(emb, IMAGE_HW, **kw)         # warm
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        from feature3dgs_tpu_torch import tracing
        with tracing.recording() as session:
            recs = sam_decode.auto_masks(emb, IMAGE_HW, **kw)
        peaks.append(torch.cuda.max_memory_allocated())
        passed.append(session.summary()["counters"]["sam.candidates"])
        del recs
    assert passed[1] == 3072 > passed[0]
    assert abs(peaks[1] - peaks[0]) < 64 * 2 ** 20, peaks
