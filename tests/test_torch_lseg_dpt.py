"""LSeg's teacher network on the port's normal path
(``encoders/lseg_net.py:build_lseg``, ``export_features``) against the
benchmark's plain reference (``port_bench/reference/lseg_dpt.py``, plain
torch written from LSeg's description) at a tiny width on the CPU, with
weights the reference draws and the port loads strictly; the reference's
name map and planted faults; the yardstick's operation count
(``port_bench/yardstick/lseg.py``) against torch's own count; the
network's spans and counters; and the export chain against the CLI's.

The tiny network: test_torch_encoders.py's widths (32 wide, 2 heads,
8 x 8 patches, reassemble and features 8, 16 output channels) with five
blocks hooked at 1-4, so that the hooks can move one block early; 64 x 96
images (an 8 x 12 grid).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from feature3dgs_tpu_torch import tracing
from feature3dgs_tpu_torch.encoders import lseg_net
from port_bench.reference import lseg_dpt as L
from port_bench.yardstick import lseg

from tests.torch_helpers import CPU, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(vit_dim=32, vit_depth=5, vit_heads=2, patch=8, hooks=[1, 2, 3, 4],
            reassemble=[8, 8, 8, 8], features=8, out_c=16, img_size=32)
PORT_TINY = {k.upper(): tuple(v) if isinstance(v, list) else v
             for k, v in TINY.items()}
BAR = 1e-5          # program against reference, max-normalised


def _image(h=64, w=96, seed=0):
    """A float32 [0, 1] image as cli/encode_lseg.py reads one."""
    u8 = np.random.RandomState(seed).randint(0, 256, (h, w, 3))
    return np.asarray(u8.astype(np.uint8), np.float32) / 255.0


def _pixels(img):
    x = torch.from_numpy(img).permute(2, 0, 1)[None]
    return (x - 0.5) / 0.5


def _err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def tiny():
    """(the port's network with the reference's weights, the reference),
    as the benchmark's ``encode_lseg`` entry pairs them."""
    ref = L.LSegDPT(**TINY).draw(torch.Generator().manual_seed(7))
    net = lseg_net.build_lseg(CPU, **PORT_TINY)
    net.load_state_dict(ref.port_state(), strict=True)
    return net, ref


@pytest.mark.parametrize("scales", [(1.0,), (0.75, 1.0)])
def test_tiny_network_matches_the_reference(tiny, scales):
    """The network's output on the same pixels, and encode_features' map
    over the scales, within 1e-5 of the reference."""
    net, ref = tiny
    x = _pixels(_image())
    with torch.no_grad():
        out = net(x)
    assert out.shape == (1, 16, 128, 192)
    assert _err(out, ref.forward(x, CPU)) <= BAR
    fmap = lseg_net.encode_features(_image(), net, scales)
    want = ref.encode(torch.from_numpy(_image()), CPU, scales)
    assert fmap.shape == want.shape == (16, 64, 96)
    assert fmap.dtype == torch.float32
    assert _err(fmap, want) <= BAR


@pytest.mark.parametrize("fault", L.FAULTS + (L.EXPORT_FAULT,))
def test_the_comparison_fails_on_a_planted_fault(tiny, fault):
    """The position embedding resized by nearest neighbour, the "ignore"
    readout, the hooks one block early, batch-norm without its running
    statistics, the fusion upsample without aligned corners, or the
    export's stride resize with them: each moves its output a thousand
    times past the bar."""
    net, ref = tiny
    img = _image()
    if fault == L.EXPORT_FAULT:
        fmap = ref.encode(torch.from_numpy(img), CPU)
        sound = L.export(fmap, 2).float()
        assert _err(L.export(fmap, 2, fault).float(), sound) > 1e3 * BAR
        return
    x = _pixels(img)
    with torch.no_grad():
        out = net(x)
    assert _err(out, ref.forward(x, CPU, fault)) > 1e3 * BAR


def test_drawn_weights_are_nonzero_and_load_strictly(tiny):
    """Every drawn floating entry is nonzero (the position embedding, cls
    token and biases too), batch-norm's statistics are not the identity's,
    the port's state after the load is the draw, the draw repeats from its
    seed, and the port's strict load refuses a state with a key left
    out."""
    net, ref = tiny
    floats = {k: v for k, v in ref.params.items() if v.is_floating_point()}
    assert all(bool((t != 0).all()) for t in floats.values())
    var = ref.params["scratch.refinenet1.resConfUnit1.bn1.running_var"]
    assert float(var.min()) >= 0.5 and float(var.max()) <= 2.0
    assert float((var - 1).abs().min()) > 0
    state = net.state_dict()
    for port, ours in ref.name_map().items():
        assert torch.equal(state[port], ref.params[ours]), port
    again = L.LSegDPT(**TINY).draw(torch.Generator().manual_seed(7))
    assert all(torch.equal(again.params[k], v)
               for k, v in ref.params.items())
    short = ref.port_state()
    del short["scratch.refinenet2.resConfUnit1.bn2.running_mean"]
    fresh = lseg_net.build_lseg(CPU, **PORT_TINY)
    with pytest.raises(RuntimeError, match="running_mean"):
        fresh.load_state_dict(short, strict=True)


def test_name_map_takes_every_port_key_to_one_entry(tiny):
    net, ref = tiny
    names = ref.name_map()
    assert set(names) == set(net.state_dict())
    assert sorted(names.values()) == sorted(ref.shapes())
    for port, ours in names.items():
        assert tuple(net.state_dict()[port].shape) == ref.shapes()[ours]


def test_configuration_is_the_port_at_published_widths():
    """The benchmark configuration's widths are ``build_lseg``'s defaults,
    its parameter count the port's, and its token count the 1216 x 800
    image's 76 x 50 patches and the cls token."""
    cfg = json.loads((ROOT / "port_bench/configs/lseg_vitl16.json")
                     .read_text())
    assert cfg["reduced"] == [] and len(cfg["source"]) <= 200
    net = cfg["net"]
    assert (net["vit_dim"], net["vit_depth"], net["vit_heads"], net["patch"],
            tuple(net["hooks"]), tuple(net["reassemble"]), net["features"],
            net["out_c"], net["img_size"]) == (
        lseg_net.VIT_DIM, lseg_net.VIT_DEPTH, lseg_net.VIT_HEADS,
        lseg_net.PATCH, lseg_net.HOOKS, lseg_net.REASSEMBLE,
        lseg_net.FEATURES, lseg_net.OUT_C, lseg_net.IMG_SIZE)
    meta = lseg_net.build_lseg("meta")
    assert sum(p.numel() for p in meta.parameters()) == cfg["parameters"]
    ref = L.LSegDPT(**net)
    assert (ref.mlp, ref.eps, ref.d // ref.heads) == (
        cfg["mlp_dim"], cfg["layer_norm_eps"], cfg["head_dim"])
    h, w = cfg["image"]["height"], cfg["image"]["width"]
    assert (h // 16) * (w // 16) + 1 == cfg["tokens"]
    assert [h // cfg["stride"], w // cfg["stride"]] == cfg["export_hw"]
    assert cfg["feature_dim"] == net["out_c"]


@pytest.mark.parametrize("hw", [(64, 96), (96, 64)])
def test_yardstick_counts_the_reference_products(tiny, hw):
    """yardstick/lseg.py's count at the tiny width equals FlopCounterMode's
    count of the reference's matrix products and convolutions."""
    from torch.utils.flop_counter import FlopCounterMode
    _, ref = tiny
    x = _pixels(_image(*hw))
    with FlopCounterMode(display=False) as fc:
        ref.forward(x, CPU)
    assert fc.get_total_flops() == sum(lseg.image_ops(TINY, *hw).values())


def test_export_records_its_spans_and_counters(tiny):
    """Under ``recording()``: one export gives lseg.encode holding the
    preprocess, a span a block, the reassemble, the fusion and the head,
    and lseg.export beside it; the image, token and wait counters."""
    net, _ = tiny
    with tracing.recording() as session:
        host = lseg_net.export_features(_image(), net, (1.0,), 2)
    assert host.dtype == torch.float16 and host.device.type == "cpu"
    assert host.shape == (16, 32, 48)
    s = session.summary()
    counts = {k: v["count"] for k, v in s["spans"].items()}
    assert counts == {"lseg.encode": 1, "lseg.preprocess": 2,
                      "lseg.block": 5, "lseg.reassemble": 1,
                      "lseg.fusion": 1, "lseg.head": 3, "lseg.export": 1}
    assert s["counters"] == {"lseg.images": 1, "lseg.tokens": 8 * 12 + 1,
                             "host_wait.lseg_upload": 1,
                             "host_wait.lseg_export": 1}
    enc = s["spans"]["lseg.encode"]
    assert enc["host_self_ms"] < enc["host_ms"]


def test_export_records_nothing_off(tiny):
    net, _ = tiny
    before = tracing.last_session()
    lseg_net.export_features(_image(), net, (1.0,), 2)
    assert tracing.last_session() is before
    assert tracing._stack() == []


def _former_chain(img, net, scales, stride):
    """The CLI loop's chain before ``export_features``."""
    fmap = lseg_net.encode_image(img, net, scales=scales)
    if stride > 1:
        hw = (img.shape[0] // stride, img.shape[1] // stride)
        fmap = torch.nn.functional.interpolate(
            fmap.float()[None], size=hw, mode="bilinear",
            align_corners=False)[0].to(torch.float16)
    return fmap.contiguous().cpu()


@pytest.mark.parametrize("scales,stride", [((1.0,), 1), ((1.0,), 2),
                                           ((0.75, 1.0), 3)])
def test_export_features_is_the_former_chain(tiny, scales, stride):
    net, _ = tiny
    img = _image(40, 56, seed=3)
    got = lseg_net.export_features(img, net, scales, stride)
    want = _former_chain(img, net, scales, stride)
    assert got.dtype == want.dtype == torch.float16
    assert got.is_contiguous() and got.device.type == "cpu"
    assert torch.equal(got, want)


def test_cli_writes_the_former_chains_maps(tiny, tmp_path, monkeypatch):
    """cli.encode_lseg --stride 2 --no_vis on two images with a saved tiny
    checkpoint: each ``.pt`` and ``.npy`` is the former chain's map."""
    from PIL import Image
    from feature3dgs_tpu_torch.cli import encode_lseg as cli
    _, ref = tiny
    build = lseg_net.build_lseg
    monkeypatch.setattr(lseg_net, "build_lseg",
                        lambda device=None, generator=None, **d:
                        build(device, generator, **PORT_TINY))
    path = str(tmp_path / "demo.ckpt")
    torch.save({"state_dict": {"net." + k: v
                               for k, v in ref.port_state().items()}}, path)
    images = tmp_path / "images"
    images.mkdir()
    for j, (h, w) in enumerate([(40, 56), (32, 48)]):
        u8 = np.random.RandomState(j).randint(0, 256, (h, w, 3))
        Image.fromarray(u8.astype(np.uint8)).save(images / f"v{j}.png")
    out = tmp_path / "out"
    assert cli.main(["--input", str(images), "--outdir", str(out),
                     "--checkpoint", path, "--stride", "2", "--no_vis",
                     "--device", "cpu"]) == 0
    net = lseg_net.load_lseg_checkpoint(path, CPU)
    for j in range(2):
        img = np.asarray(Image.open(images / f"v{j}.png").convert("RGB"),
                         np.float32) / 255.0
        want = _former_chain(img, net, (1.0,), 2)
        base = out / f"v{j}_fmap_CxHxW"
        assert torch.equal(torch.load(str(base) + ".pt"), want)
        np.testing.assert_array_equal(np.load(str(base) + ".npy"),
                                      want.numpy())
    assert sorted(p.name for p in out.iterdir()) == [
        "v0_fmap_CxHxW.npy", "v0_fmap_CxHxW.pt", "v1_fmap_CxHxW.npy",
        "v1_fmap_CxHxW.pt"]
