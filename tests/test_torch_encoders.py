"""The port's teacher encoders against the JAX package's on the CPU, with
tiny seeded networks given to both (no weights exist here): LSeg
(``encoders/lseg_net.py``) through ``convert.encoder_state_from_numpy``,
its key audit and checkpoint loader; CLIP pixel features; SAM's encoder,
prompt decoding and automatic mask generator; the AMG geometry helpers;
and the encode_lseg, segment_time, sam_encoder and sam_decode CLIs against
the scripts.
"""
import os
import re

import numpy as np
import pytest
import torch

from feature3dgs_tpu_torch import convert
from feature3dgs_tpu_torch.encoders import lseg_net as plseg

from tests.torch_helpers import CPU, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# tests/test_encoders.py's tiny LSeg
TINY = dict(VIT_DIM=32, VIT_DEPTH=4, VIT_HEADS=2, PATCH=8, IMG_SIZE=32,
            HOOKS=(0, 1, 2, 3), REASSEMBLE=(8, 8, 8, 8), FEATURES=8,
            OUT_C=16)


def _numpy_state(module) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in
            module.state_dict().items()}


def _jax_tiny_lseg():
    """tests/test_encoders.py's seeded tiny net, built by the JAX package."""
    from feature3dgs_tpu.encoders import lseg_net as jlseg
    net = jlseg.build_lseg(**TINY)
    torch.manual_seed(0)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn_like(p) * 0.05)
    return net.eval()


def _port_tiny_lseg(jnet):
    net = plseg.build_lseg(CPU, **TINY)
    net.load_state_dict(convert.encoder_state_from_numpy(
        _numpy_state(jnet), CPU), strict=True)
    return net


def test_lseg_tiny_matches_jax():
    """The same seeded weights in both packages (strict load): the net's
    output and encode_image (fp16, one and two scales, a size that is not
    a multiple of 32) equal at 1e-6."""
    from feature3dgs_tpu.encoders import lseg_net as jlseg
    jnet = _jax_tiny_lseg()
    pnet = _port_tiny_lseg(jnet)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 3, 32, 48).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(pnet(x).numpy(), jnet(x).numpy(),
                                   atol=1e-6, rtol=0)
    img = rng.rand(40, 56, 3).astype(np.float32)
    for scales in ((1.0,), (0.75, 1.25)):
        a = jlseg.encode_image(img, jnet, scales=scales)
        b = plseg.encode_image(img, pnet, scales=scales)
        assert b.dtype == torch.float16 and b.shape == (16, 40, 56)
        np.testing.assert_allclose(b.numpy().astype(np.float32),
                                   a.astype(np.float32), atol=1e-6, rtol=0)


def test_lseg_keys_and_seeded_build():
    """The key audit equals the JAX package's (the reference's names); a
    seeded build is reproducible, differs between seeds and gives finite
    features."""
    from feature3dgs_tpu.encoders import lseg_net as jlseg
    keys = plseg.expected_state_dict_keys()
    assert keys == jlseg.expected_state_dict_keys()
    assert "pretrained.model.pos_embed" in keys and "logit_scale" not in keys

    def build(seed):
        return plseg.build_lseg(CPU, torch.Generator().manual_seed(seed),
                                **TINY)
    a, b, c = build(1), build(1), build(2)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["scratch.head1.weight"],
                           sc["scratch.head1.weight"])
    assert torch.equal(sa["scratch.refinenet1.resConfUnit1.bn1.running_var"],
                       torch.ones(8))
    f = plseg.encode_features(np.random.RandomState(0).rand(32, 32, 3), a)
    assert f.shape == (16, 32, 32) and bool(torch.isfinite(f).all())


def test_lseg_checkpoint_loader_matches_jax(tmp_path, monkeypatch):
    """A lightning-style checkpoint (``net.`` prefix, CLIP text-tower and
    timm head keys) loads in both packages to equal outputs; a missing key
    raises; no path and no LSEG_WEIGHTS gives None."""
    from feature3dgs_tpu.encoders import lseg_net as jlseg
    jbuild, pbuild = jlseg.build_lseg, plseg.build_lseg
    monkeypatch.setattr(jlseg, "build_lseg", lambda **d: jbuild(**TINY))
    monkeypatch.setattr(plseg, "build_lseg",
                        lambda device=None, generator=None, **d:
                        pbuild(device, generator, **TINY))
    monkeypatch.delenv("LSEG_WEIGHTS", raising=False)
    jnet = _jax_tiny_lseg()
    sd = {"net." + k: v for k, v in jnet.state_dict().items()}
    sd["net.clip_pretrained.token_embedding.weight"] = torch.zeros(2, 2)
    sd["net.pretrained.model.head.weight"] = torch.zeros(4)
    path = str(tmp_path / "demo.ckpt")
    torch.save({"state_dict": sd}, path)
    a, b = jlseg.load_lseg_checkpoint(path), plseg.load_lseg_checkpoint(
        path, CPU)
    x = torch.randn(1, 3, 32, 32)
    with torch.no_grad():
        assert torch.equal(a(x), b(x))
    del sd["net.scratch.head1.bias"]
    torch.save(sd, str(tmp_path / "broken.ckpt"))
    with pytest.raises(ValueError, match="missing 1 keys"):
        plseg.load_lseg_checkpoint(str(tmp_path / "broken.ckpt"), CPU)
    assert plseg.load_lseg_checkpoint(None, CPU) is None


def _tiny_clip():
    from transformers import (CLIPConfig, CLIPImageProcessor, CLIPModel,
                              CLIPTextConfig, CLIPVisionConfig)
    cfg = CLIPConfig(
        text_config=CLIPTextConfig(hidden_size=16, intermediate_size=32,
                                   num_hidden_layers=1, num_attention_heads=2,
                                   vocab_size=64).to_dict(),
        vision_config=CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                                       num_hidden_layers=2,
                                       num_attention_heads=2, image_size=224,
                                       patch_size=32).to_dict(),
        projection_dim=16)
    torch.manual_seed(0)
    model = CLIPModel(cfg).eval()
    return model, CLIPImageProcessor()


def test_clip_pixel_matches_jax(monkeypatch):
    """MaskCLIP pixel features of a tiny seeded CLIP ViT-B/32-shaped model
    (7x7 patches) given to both packages, with and without the resize."""
    from feature3dgs_tpu.encoders import clip_pixel as jclip
    from feature3dgs_tpu_torch.encoders import clip_pixel as pclip
    model, proc = _tiny_clip()
    monkeypatch.setattr(jclip, "_CACHE", {"model": model, "processor": proc})
    img = (np.random.RandomState(0).rand(60, 80, 3) * 255).astype(np.uint8)
    for hw in (None, (30, 40)):
        a = jclip.encode_image(img, hw)
        b = pclip.encode_image(img, hw, clip=(model, proc))
        assert b.shape == a.shape == ((16, 7, 7) if hw is None
                                      else (16, 30, 40))
        np.testing.assert_allclose(b.numpy(), a, atol=1e-6, rtol=0)
    # [0, 1] floats are quantised as the JAX package does
    np.testing.assert_array_equal(
        pclip.encode_image(img / 255.0, clip=(model, proc)).numpy(),
        jclip.encode_image(img / 255.0))


def _tiny_sam():
    """A seeded SamModel small enough for the CPU: 2 vision blocks of
    width 32 (one windowed, one global), 32 channels out."""
    from transformers import (SamConfig, SamImageProcessor,
                              SamMaskDecoderConfig, SamModel, SamProcessor,
                              SamPromptEncoderConfig, SamVisionConfig)
    cfg = SamConfig(
        vision_config=SamVisionConfig(
            hidden_size=32, output_channels=32, num_hidden_layers=2,
            num_attention_heads=2, global_attn_indexes=[1], window_size=8,
            num_pos_feats=16, mlp_dim=64).to_dict(),
        prompt_encoder_config=SamPromptEncoderConfig(
            hidden_size=32, mask_input_channels=4).to_dict(),
        mask_decoder_config=SamMaskDecoderConfig(
            hidden_size=32, mlp_dim=64, num_attention_heads=2,
            iou_head_hidden_dim=32).to_dict())
    torch.manual_seed(0)
    model = SamModel(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn_like(p) * 0.3)
    return model, SamProcessor(SamImageProcessor())


@pytest.fixture(scope="module")
def sam():
    return _tiny_sam()


@pytest.fixture
def jax_sam(sam, monkeypatch):
    """The tiny SAM in the JAX package's cache; its modules."""
    from feature3dgs_tpu.encoders import sam_decode as jdec
    from feature3dgs_tpu.encoders import sam_encoder as jenc
    monkeypatch.setattr(jenc, "_CACHE", {"model": sam[0],
                                         "processor": sam[1]})
    return jenc, jdec


def test_sam_encode_and_decode_match_jax(sam, jax_sam):
    """encode_image (both aspects), decode_masks (points with labels, a
    box, logits) and _decode_point_batch: masks equal, IoU scores at
    1e-6."""
    from feature3dgs_tpu_torch.encoders import sam_decode as pdec
    from feature3dgs_tpu_torch.encoders import sam_encoder as penc
    jenc, jdec = jax_sam
    rng = np.random.RandomState(0)
    for h, w in ((48, 64), (64, 40)):
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        a, b = jenc.encode_image(img), penc.encode_image(img, sam)
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), a, atol=1e-6, rtol=0)
        for kw in ({"points": [[10, 20], [30, 5]], "labels": [1, 0]},
                   {"points": [[w - 1.5, 2.0]]},
                   {"boxes": [[4, 6, w - 8, h - 3]]},
                   {"points": [[12, 9]], "return_logits": True}):
            ma, ia = jdec.decode_masks(a, (h, w), **kw)
            mb, ib = pdec.decode_masks(b, (h, w), sam=sam, **kw)
            assert mb.shape == ma.shape == (3, h, w)
            if kw.get("return_logits"):
                np.testing.assert_allclose(mb.numpy(), ma, atol=1e-6, rtol=0)
            else:
                np.testing.assert_array_equal(mb.numpy(), ma)
                assert 0 < ma.mean() < 1
            np.testing.assert_allclose(ib.numpy(), ia, atol=1e-6, rtol=0)
        pts = rng.uniform(0, 1, (5, 2)) * [w, h]
        la, ia = jdec._decode_point_batch(a, (h, w), pts)
        lb, ib = pdec._decode_point_batch(b, (h, w), pts, sam=sam)
        assert lb.shape == la.shape == (5, 3, h, w)
        np.testing.assert_allclose(lb.numpy(), la, atol=1e-6, rtol=0)
        np.testing.assert_allclose(ib.numpy(), ia, atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["one_crop", "crop_layer"])
def test_sam_auto_masks_match_jax(case, sam, jax_sam):
    """auto_masks on one embedding: the kept records, in order, equal the
    JAX package's (masks, areas, boxes, scores, points, crop boxes). One
    crop with a low IoU bar (many masks, per-crop NMS), and a crop layer
    (five crops, cross-crop NMS)."""
    from feature3dgs_tpu_torch.encoders import sam_decode as pdec
    jenc, jdec = jax_sam
    img = (np.random.RandomState(1).rand(48, 64, 3) * 255).astype(np.uint8)
    emb = jenc.encode_image(img)
    kw = (dict(points_per_side=4, pred_iou_thresh=-10.0,
               stability_thresh=0.0) if case == "one_crop" else
          dict(points_per_side=4, pred_iou_thresh=0.0, stability_thresh=0.0,
               crop_n_layers=1, points_per_batch=8))
    a = jdec.auto_masks(emb, (48, 64), **kw)
    b = pdec.auto_masks(torch.from_numpy(emb), (48, 64), sam=sam, **kw)
    assert len(a) == len(b) > 3
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(rb["segmentation"].numpy(),
                                      ra["segmentation"])
        for k in ("area", "bbox", "predicted_iou", "point_coords",
                  "stability_score", "crop_box"):
            assert rb[k] == ra[k], k


def test_amg_helpers_match_jax():
    """The AMG helpers on seeded inputs: point grids and crop boxes equal;
    mask boxes (with empty masks), crop-edge tests (boxes on the atol
    edge), stability scores and box NMS decisions (with tied scores) equal
    to the numpy versions."""
    from feature3dgs_tpu.encoders import sam_decode as jd
    from feature3dgs_tpu_torch.encoders import sam_decode as pd
    for n in (1, 4, 7):
        np.testing.assert_array_equal(pd.build_point_grid(n),
                                      jd.build_point_grid(n))
    for args in ((8, 1, 2), (16, 2, 2), (6, 0, 1)):
        for x, y in zip(pd.build_all_layer_point_grids(*args),
                        jd.build_all_layer_point_grids(*args)):
            np.testing.assert_array_equal(x, y)
    for size, layers in (((600, 800), 1), ((48, 64), 2), ((101, 77), 2)):
        assert pd.generate_crop_boxes(size, layers, 512 / 1500) == \
            jd.generate_crop_boxes(size, layers, 512 / 1500)

    rng = np.random.RandomState(0)
    masks = rng.rand(12, 20, 30) > 0.97
    masks[3] = False
    masks[5, 2:9, 4:11] = True
    np.testing.assert_array_equal(pd.batched_mask_to_box(masks).numpy(),
                                  jd.batched_mask_to_box(masks))
    boxes = rng.randint(0, 60, (40, 4)).astype(np.float64)
    boxes[:4] = [[20.0, 0, 30, 40], [0, 0, 45, 10], [5, 5, 25, 25],
                 [0, 0, 5, 5]]
    for crop, orig in (([0, 0, 25, 40], [0, 0, 50, 40]),
                       ([10, 10, 50, 50], [0, 0, 60, 60])):
        np.testing.assert_array_equal(
            pd.is_box_near_crop_edge(boxes, crop, orig, atol=5.0).numpy(),
            jd.is_box_near_crop_edge(boxes, crop, orig, atol=5.0))
    for _ in range(5):
        logits = rng.randn(16, 16).astype(np.float32) * 2
        assert pd.stability_score(logits) == jd.stability_score(logits)
        assert pd.stability_score(torch.from_numpy(logits)) == \
            jd.stability_score(logits)

    for n in (1, 2, 16, 40, 300):
        xy = rng.uniform(0, 40, (n, 2))
        wh = rng.uniform(2, 20, (n, 2))
        b = np.concatenate([xy, xy + wh], 1)
        scores = rng.choice([0.5, 0.7, 0.9], n)       # ties
        for thresh in (0.1, 0.3, 0.7):
            np.testing.assert_array_equal(
                pd.box_nms(b, scores, thresh).numpy(),
                jd.box_nms(b, scores, thresh))
            np.testing.assert_array_equal(
                pd.box_nms(b, torch.from_numpy(scores), thresh).numpy(),
                jd.box_nms(b, scores, thresh))
    keep = pd.box_nms(np.zeros((0, 4)), np.zeros(0), 0.5)
    assert keep.shape == (0,)


def _images(d, sizes, seed=0):
    from PIL import Image
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i, (h, w) in enumerate(sizes):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            os.path.join(d, f"im{i}.png"))
    return d


def _tree(base):
    return sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, fs in os.walk(base) for f in fs)


def _same_outputs(a, b):
    from PIL import Image
    assert _tree(a) == _tree(b)
    for rel in _tree(a):
        x, y = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".npy"):
            u, v = np.load(x), np.load(y)
            assert u.dtype == v.dtype == np.float16
            np.testing.assert_array_equal(u, v, err_msg=rel)
        elif rel.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(x)),
                                          np.asarray(Image.open(y)))
        elif rel == "pca_dict.pt":
            u, v = torch.load(x), torch.load(y)
            assert sorted(u) == sorted(v)
            for k in u:
                np.testing.assert_array_equal(np.asarray(u[k]),
                                              np.asarray(v[k]))
        else:
            assert torch.equal(torch.load(x), torch.load(y)), rel


@pytest.mark.parametrize("flags", [["--stride", "2"],
                                   ["--scales", "0.75", "1.0", "--no_vis"],
                                   ["--fallback_clip"]])
def test_encode_lseg_cli_matches_script(flags, tmp_path, monkeypatch):
    """cli.encode_lseg against scripts/encode_lseg.py with a tiny saved
    checkpoint (or, with --fallback_clip and no checkpoint, a tiny CLIP in
    both caches): the same file tree, arrays equal, PNGs equal."""
    import scripts.encode_lseg as jax_cli
    from feature3dgs_tpu.encoders import clip_pixel as jclip
    from feature3dgs_tpu.encoders import lseg_net as jlseg
    from feature3dgs_tpu_torch.cli import encode_lseg as port_cli
    from feature3dgs_tpu_torch.encoders import clip_pixel as pclip
    jbuild, pbuild = jlseg.build_lseg, plseg.build_lseg
    monkeypatch.setattr(jlseg, "build_lseg", lambda **d: jbuild(**TINY))
    monkeypatch.setattr(plseg, "build_lseg",
                        lambda device=None, generator=None, **d:
                        pbuild(device, generator, **TINY))
    monkeypatch.delenv("LSEG_WEIGHTS", raising=False)
    images = _images(str(tmp_path / "images"), [(40, 56), (32, 48)])
    argv = ["--input", images] + flags
    if "--fallback_clip" in flags:
        model, proc = _tiny_clip()
        monkeypatch.setattr(jclip, "_CACHE", {"model": model,
                                              "processor": proc})
        monkeypatch.setattr(pclip, "_CACHE", {CPU: (model, proc)})
    else:
        path = str(tmp_path / "demo.ckpt")
        torch.save({"state_dict": {"net." + k: v for k, v in
                                   _jax_tiny_lseg().state_dict().items()}},
                   path)
        argv += ["--checkpoint", path]
    jax_cli.main(argv + ["--outdir", str(tmp_path / "jax")])
    assert port_cli.main(argv + ["--outdir", str(tmp_path / "port"),
                                 "--device", "cpu"]) == 0
    _same_outputs(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert len(_tree(str(tmp_path / "port"))) == (
        4 if "--no_vis" in flags else 7)


@pytest.fixture
def saved_sam(sam, tmp_path, monkeypatch):
    """The tiny SAM saved into tmp_path as SAM_MODEL_PATH, both caches
    empty."""
    from feature3dgs_tpu.encoders import sam_encoder as jenc
    from feature3dgs_tpu_torch.encoders import sam_encoder as penc
    path = str(tmp_path / "sam")
    sam[0].save_pretrained(path)
    sam[1].save_pretrained(path)
    monkeypatch.setenv("SAM_MODEL_PATH", path)
    monkeypatch.setattr(jenc, "_CACHE", {})
    monkeypatch.setattr(penc, "_CACHE", {})
    return path


def test_segment_time_cli_matches_script(saved_sam, tmp_path, capsys):
    """cli.segment_time against scripts/segment_time.py on the saved tiny
    SAM: the same mask counts from rendered embeddings and through the
    encoder (times differ by nature)."""
    import scripts.segment_time as jax_cli
    from feature3dgs_tpu_torch.cli import segment_time as port_cli
    feats = tmp_path / "feats"
    feats.mkdir()
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate(((3, 4), (4, 3))):
        np.save(feats / f"{i:05d}_fmap_CxHxW.npy",
                rng.randn(32, h, w).astype(np.float16))
    images = _images(str(tmp_path / "images"), [(48, 64), (64, 48)])
    argv = ["--feature_dir", str(feats), "--image_dir", images,
            "--points", "2"]
    counts = []
    for main, extra in ((jax_cli.main, []),
                        (port_cli.main, ["--device", "cpu"])):
        assert main(argv + extra) == 0
        text = capsys.readouterr().out
        counts.append([int(n) for n in re.findall(r"(\d+) masks in", text)])
    assert counts[0] == counts[1] == [12, 12]


def test_sam_encoder_and_decode_clis_match_scripts(saved_sam, tmp_path):
    """sam_encoder.main and sam_decode.main (the package's CLIs) against
    the JAX package's on the saved tiny SAM: the same embedding files, the
    same best-mask PNG."""
    from PIL import Image

    from feature3dgs_tpu.encoders import sam_decode as jdec
    from feature3dgs_tpu.encoders import sam_encoder as jenc
    from feature3dgs_tpu_torch.encoders import sam_decode as pdec
    from feature3dgs_tpu_torch.encoders import sam_encoder as penc
    images = _images(str(tmp_path / "images"), [(48, 64), (40, 40)])
    jenc.main(["--input", images, "--output", str(tmp_path / "jax")])
    assert penc.main(["--input", images, "--output", str(tmp_path / "port"),
                      "--device", "cpu"]) == 0
    _same_outputs(str(tmp_path / "jax"), str(tmp_path / "port"))
    feature = str(tmp_path / "port" / "im0_fmap_CxHxW.npy")
    for main, out, extra in ((jdec.main, "j.png", []),
                             (pdec.main, "p.png", ["--device", "cpu"])):
        main(["--feature", feature, "--image_size", "48", "64", "--point",
              "10", "20", "--point", "30", "12", "--output",
              str(tmp_path / out)] + extra)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))


def test_importing_the_encoders_loads_no_transformers():
    """transformers (which may pull in other frameworks) is imported only
    inside the functions that load or run a model."""
    import subprocess
    import sys
    code = ("import sys\n"
            "import feature3dgs_tpu_torch.encoders.lseg_net, "
            "feature3dgs_tpu_torch.encoders.clip_pixel, "
            "feature3dgs_tpu_torch.encoders.sam_encoder, "
            "feature3dgs_tpu_torch.encoders.sam_decode, "
            "feature3dgs_tpu_torch.cli.encode_lseg, "
            "feature3dgs_tpu_torch.cli.segment_time\n"
            "print([m for m in sys.modules if m.startswith("
            "('transformers', 'tensorflow', 'jax'))])\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
