"""The port's viewers against the JAX package's on the CPU: the SIBR wire
protocol (``viewer/network_gui.py``: the cameras it receives, the bytes it
sends, a loopback round trip through each server), the browser viewer
(``viewer/web.py``: orbit cameras, world-up, /render PNGs of one scene),
the view and web_view CLIs (every flag of scripts/view.py and
scripts/web_view.py parses; frames of a saved model), the videos CLI, and
the train CLI serving a client across sync windows while it trains.
"""
import json
import os
import socket
import struct
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from feature3dgs_tpu_torch.render import modes as pmodes
from feature3dgs_tpu_torch.viewer import network_gui as pgui
from feature3dgs_tpu_torch.viewer import web as pweb

from tests.test_torch_train_cli import _parser_of, _sample
from tests.torch_helpers import CPU, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def sibr_message(view, proj_full, width, height, *, fovx=1.0, fovy=0.8,
                 mode=0, train=True, scaling=1.0):
    """The camera message a SIBR client sends for a math-convention view
    and full projection: each transposed, with the client's column flips
    (which the server undoes)."""
    wvt = np.asarray(view, np.float32).T.copy()
    wvt[:, 1] = -wvt[:, 1]
    wvt[:, 2] = -wvt[:, 2]
    vpt = np.asarray(proj_full, np.float32).T.copy()
    vpt[:, 1] = -vpt[:, 1]
    return {"resolution_x": width, "resolution_y": height, "train": train,
            "fov_y": fovy, "fov_x": fovx, "z_near": 0.01, "z_far": 100.0,
            "keep_alive": True, "scaling_modifier": scaling,
            "view_matrix": wvt.ravel().tolist(),
            "view_projection_matrix": vpt.ravel().tolist(),
            "render_mode": mode}


class Client:
    """The client side of the protocol, recording every byte it reads."""

    def __init__(self, port, timeout=60.0):
        deadline = time.time() + timeout
        while True:
            try:
                self.sock = socket.create_connection(("127.0.0.1", port),
                                                     timeout=timeout)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.05)
        self.raw = b""

    def read(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            assert chunk, "server closed"
            buf += chunk
        self.raw += buf
        return buf

    def handshake(self):
        n = struct.unpack("I", self.read(4))[0]
        return json.loads(self.read(n).decode())

    def frame(self, msg):
        payload = json.dumps(msg).encode()
        self.sock.sendall(struct.pack("I", len(payload)) + payload)
        w, h = msg["resolution_x"], msg["resolution_y"]
        img = self.read(w * h * 3) if w and h else b""
        n = int.from_bytes(self.read(4), "little")
        source = self.read(n).decode()
        n = struct.unpack("I", self.read(4))[0]
        return img, source, json.loads(self.read(n).decode())

    def close(self):
        self.sock.close()


def _random_camera_message(seed, w=40, h=24, **kw):
    rng = np.random.RandomState(seed)
    return sibr_message(rng.randn(4, 4), rng.randn(4, 4), w, h,
                        fovx=float(rng.uniform(0.5, 1.5)),
                        fovy=float(rng.uniform(0.5, 1.5)), **kw)


def _exchange(gui_cls, msgs, reply):
    """Serve ``msgs`` (camera messages) from one client through a server of
    ``gui_cls``; ``reply(cam)`` gives (image, source, metrics) for each.
    Returns (the server's cameras, every byte the client read)."""
    gui = gui_cls("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]
    out = {}

    def client():
        c = Client(port)
        out["items"] = c.handshake()
        for m in msgs:
            c.frame(m)
        out["raw"] = c.raw
        c.close()

    t = threading.Thread(target=client)
    t.start()
    cams = []
    deadline = time.time() + 30
    while not gui.try_connect(list(pmodes.RENDER_ITEMS)):
        assert time.time() < deadline
        time.sleep(0.01)
    for _ in msgs:
        cam = gui.receive()
        cams.append(cam)
        gui.send(*reply(cam))
    t.join(timeout=30)
    assert not t.is_alive()
    gui.disconnect()
    gui.listener.close()
    return cams, out["raw"]


def test_receive_matches_jax():
    """The same JSON messages give equal cameras in both servers (the
    column flips and transposes byte for byte), and to_view equals the JAX
    CameraView at 1e-6; a 0 x 0 message is a keep-alive (None)."""
    from feature3dgs_tpu.viewer import network_gui as jgui
    msgs = [_random_camera_message(s, mode=s % 6, train=bool(s % 2),
                                   scaling=0.5 + s) for s in range(3)]
    msgs.append(dict(msgs[0], resolution_x=0, resolution_y=0))

    def reply(cam):
        img = (np.full((cam.height, cam.width, 3), 0.5, np.float32)
               if cam is not None else None)
        return img, "src", {"#": 1}

    jcams, jraw = _exchange(jgui.NetworkGUI, msgs, reply)
    pcams, praw = _exchange(pgui.NetworkGUI, msgs, reply)
    assert jraw == praw
    assert jcams[-1] is None and pcams[-1] is None
    for j, p in zip(jcams[:-1], pcams[:-1]):
        for f in ("width", "height", "fovx", "fovy", "znear", "zfar",
                  "do_training", "keep_alive", "scaling_modifier",
                  "render_mode"):
            assert getattr(j, f) == getattr(p, f), f
        for f in ("view", "proj_full"):
            a, b = getattr(j, f), getattr(p, f)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=f)
        jv, pv = j.to_view(), p.to_view(CPU)
        assert (jv.width, jv.height) == (pv.width, pv.height)
        for f in ("view", "proj", "campos", "tan_fovx", "tan_fovy"):
            np.testing.assert_allclose(getattr(pv, f).numpy(),
                                       np.asarray(getattr(jv, f)), rtol=1e-6,
                                       atol=1e-6, err_msg=f)
    # the math convention: identity in, diag(1, -1, -1, 1) out
    eye = dict(msgs[0], view_matrix=np.eye(4).ravel().tolist())
    cams, _ = _exchange(pgui.NetworkGUI, [eye], reply)
    np.testing.assert_array_equal(cams[0].view,
                                  np.diag([1, -1, -1, 1]).astype(np.float32))


def test_send_and_round_trip_match_jax():
    """The bytes each server sends for the same frames (float and uint8
    numpy; the port also a float and a uint8 tensor) are identical:
    handshake, raw RGB, source path and metrics JSON."""
    from feature3dgs_tpu.viewer import network_gui as jgui
    rng = np.random.RandomState(3)
    msg = _random_camera_message(0, w=40, h=24)
    images = [rng.uniform(-0.2, 1.2, (24, 40, 3)).astype(np.float32),
              rng.randint(0, 256, (24, 40, 3)).astype(np.uint8)]
    metrics = [{"#": 123, "loss": 0.25}, {"#": 7, "loss": 0.0}]
    msgs = [msg, msg]

    def replies(as_tensor):
        it = iter(range(2))

        def reply(cam):
            i = next(it)
            img = torch.from_numpy(images[i]) if as_tensor else images[i]
            return img, "/some/scene", metrics[i]
        return reply

    _, jraw = _exchange(jgui.NetworkGUI, msgs, replies(False))
    _, praw = _exchange(pgui.NetworkGUI, msgs, replies(False))
    _, traw = _exchange(pgui.NetworkGUI, msgs, replies(True))
    assert praw == jraw and traw == jraw
    assert len(jraw) > 2 * 24 * 40 * 3


def test_orbit_camera_and_estimate_up_match_jax():
    from feature3dgs_tpu.viewer import web as jweb
    rng = np.random.RandomState(0)
    for up in ([0, -1, 0], [0, 0, 1], rng.randn(3), [1e-3, 1.0, 0.0]):
        up = np.asarray(up, np.float64)
        for az, el in [(0.0, 0.0), (1.1, 0.4), (-2.0, -0.7),
                       (0.3, np.pi / 2)]:
            center = rng.randn(3)
            a = jweb.orbit_camera(center, 2.5, az, el, 64, 48, 0.9, up)
            b = pweb.orbit_camera(center, 2.5, az, el, 64, 48, 0.9, up)
            for f in ("R", "T", "view", "full_proj", "camera_center"):
                np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                           rtol=1e-12, atol=1e-12,
                                           err_msg=f)
            assert (a.fovx, a.fovy, a.width, a.height) == \
                (b.fovx, b.fovy, b.width, b.height)
    for n in (1, 3, 8):
        entries = []
        for _ in range(n):
            q, _ = np.linalg.qr(rng.randn(3, 3))
            entries.append({"rotation": q.tolist()})
        np.testing.assert_allclose(pweb.estimate_up(entries),
                                   jweb.estimate_up(entries), rtol=1e-12,
                                   atol=1e-12)
    opposite = [{"rotation": np.eye(3).tolist()},
                {"rotation": np.diag([1.0, -1.0, -1.0]).tolist()}]
    for e in (None, [], opposite):
        np.testing.assert_array_equal(pweb.estimate_up(e),
                                      jweb.estimate_up(e))


GAUSSIANS = dict(n=80, f_dim=4, seed=5, max_sh_degree=2)
QUERY = "az=0.5&el=0.3&r=4&w=64&h=48"


def _jax_viewer():
    """The JAX viewer of tests/test_web_viewer.py's scene (xla backend)."""
    from feature3dgs_tpu.ops import RasterConfig, rasterize
    from feature3dgs_tpu.viewer.web import WebViewer
    from tests.utils import random_gaussians
    g = random_gaussians(**GAUSSIANS)
    rcfg = RasterConfig(instance_capacity=1 << 12, tile_capacity=1 << 9,
                        chunk=16)

    def render_fn(cam, scaling_modifier):
        out = rasterize(g["means3d"], g["opacities"], g["feat"],
                        cam.to_view(), scales=g["scales"] * scaling_modifier,
                        rotations=g["rotations"], shs=g["shs"], sh_degree=2,
                        config=rcfg)
        return {"color": np.asarray(out.color),
                "feature": np.asarray(out.feature),
                "depth": np.asarray(out.depth)}
    return WebViewer(render_fn, center=[0, 0, 0], radius=4.0,
                     n_gaussians=80, feature_dim=4, port=0)


def _port_viewer():
    from feature3dgs_tpu_torch.ops.rasterize import RasterConfig, rasterize
    from tests.torch_helpers import scene
    g = {k: torch.from_numpy(v) for k, v in scene(**GAUSSIANS).items()}
    rcfg = RasterConfig(tile_w=16, tile_h=16, chunk=16)

    def render_fn(cam, scaling_modifier):
        out = rasterize(g["means3d"], g["opacities"], g["feat"],
                        cam.to_view(CPU),
                        scales=g["scales"] * scaling_modifier,
                        rotations=g["rotations"], shs=g["shs"], sh_degree=2,
                        config=rcfg)
        return {"color": out.color, "feature": out.feature,
                "depth": out.depth}
    return pweb.WebViewer(render_fn, center=[0, 0, 0], radius=4.0,
                          n_gaussians=80, feature_dim=4, port=0)


def _get(viewer, path):
    resp = urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}{path}")
    return resp.read(), resp.headers


def _png(data):
    import io

    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(data))).astype(int)


# share of pixels that may differ in each mode, measured on this scene at
# scaling 1.0 and 0.3: RGB 0 / 0.03% (1 LSB), Depth 0 / 0.03%, Edge
# 0 / 0.13%, Normal 7.2% / 3.5% (1 LSB but 0.03% / 0.4%), Curvature
# 2.0% / 2.4%, Feature Map 0 / 0.03%
DIFFERING = {"RGB": 0.001, "Depth": 0.005, "Edge": 0.005, "Normal": 0.1,
             "Curvature": 0.03, "Feature Map": 0.001}


def test_web_viewer_pngs_match_jax():
    """/, /info and /render of one scene in both viewers (the port on the
    CPU, the JAX package's xla backend), every mode at scaling 1.0 and 0.3.
    The renders agree to ~1e-6, so a pixel moves only at a rounding edge:
    RGB at most 1 LSB apart on at most 0.1% of the pixels. The colormapped
    modes (Depth, Edge, Curvature) index a 256-entry table, where a move at
    a bin edge is a table step of a few LSB; Normal unprojects depth
    through an f32 inverse (1 LSB on up to 10% of the pixels, more on at
    most 1%, the bottom-right pixel aside: both neighbours there are the
    zero padding, so its normal is rounding noise in either package);
    Curvature is the Sobel edge of those normals. Each stays under its
    share in DIFFERING."""
    jv = _jax_viewer().serve_background()
    pv = _port_viewer().serve_background()
    try:
        assert _get(jv, "/")[0] == _get(pv, "/")[0]
        assert json.loads(_get(jv, "/info")[0]) == \
            json.loads(_get(pv, "/info")[0])
        for mode, item in enumerate(pmodes.RENDER_ITEMS):
            for scaling in (1.0, 0.3):
                path = f"/render?{QUERY}&mode={mode}&scaling={scaling}"
                (jpng, _), (ppng, headers) = _get(jv, path), _get(pv, path)
                assert ppng[:8] == b"\x89PNG\r\n\x1a\n"
                assert float(headers["X-Render-Ms"]) > 0
                a, b = _png(jpng), _png(ppng)
                assert a.shape == b.shape == (48, 64, 3)
                diff = np.abs(a - b).max(-1)
                if item == "Normal":
                    diff[-1, -1] = 0
                    assert (diff > 1).mean() <= 0.01, (item, scaling)
                if item == "RGB":
                    assert diff.max() <= 1, (item, scaling)
                assert (diff > 0).mean() <= DIFFERING[item], (item, scaling)
        # the scaling modifier changes the image
        assert _get(pv, f"/render?{QUERY}&scaling=1.0")[0] != \
            _get(pv, f"/render?{QUERY}&scaling=0.3")[0]
    finally:
        jv.close()
        pv.close()


@pytest.fixture(scope="module")
def saved_model(tmp_path_factory):
    """A model folder: the port's PLY of a seeded scene at iteration 7 and
    a cameras.json of one camera (world-up +z)."""
    from feature3dgs_tpu_torch.model import gaussians as PG
    from feature3dgs_tpu_torch.model.ply_io import save_gaussians_ply
    from tests.torch_helpers import scene
    model = tmp_path_factory.mktemp("model")
    g = scene(n=120, f_dim=4, seed=2, max_sh_degree=1)
    pts = g["means3d"]
    params, state = PG.create_from_pcd(
        pts, np.clip(g["shs"][:, 0] + 0.5, 0, 1), max_sh_degree=1,
        feature_dim=4, knn_mean_dists=np.full(len(pts), 0.01), device=CPU)
    params.semantic_feature = torch.from_numpy(g["feat"][:, None])
    params.opacity = torch.full_like(params.opacity, 1.0)
    d = model / "point_cloud" / "iteration_7"
    d.mkdir(parents=True)
    save_gaussians_ply(str(d / "point_cloud.ply"), params, state)
    c2w = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]])
    with open(model / "cameras.json", "w") as f:
        json.dump([{"rotation": c2w.tolist()}], f)
    return str(model)


def _direct_frame(model, view, mode, scaling=1.0):
    """The frame a direct render of the saved model gives, the JAX way:
    render_net_image as numpy, then clip * 255 truncated to uint8."""
    from feature3dgs_tpu_torch.model.ply_io import load_gaussians_ply
    from feature3dgs_tpu_torch.render import renderer
    params, state = load_gaussians_ply(
        os.path.join(model, "point_cloud", "iteration_7", "point_cloud.ply"),
        max_sh_degree=1, device=CPU)
    out = renderer.render(params, state, view,
                          bg=torch.zeros(3), scaling_modifier=scaling)
    img = pmodes.render_net_image(
        {"color": out.color, "feature": out.feature, "depth": out.depth},
        pmodes.RENDER_ITEMS, mode, view.proj)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def test_view_cli_frames_equal_direct_renders(saved_model):
    """cli.view's serve loop on a saved model: every render mode's frame,
    and one at scaling 0.5, equals render_net_image of a direct render
    bit for bit; a keep-alive message gets metrics only; the loop stops on
    its event."""
    from feature3dgs_tpu_torch import config as C
    from feature3dgs_tpu_torch.cli import view as view_cli
    from feature3dgs_tpu_torch.core import transforms
    from feature3dgs_tpu_torch.render import renderer
    args = view_cli.build_parser().parse_args(["-m", saved_model,
                                               "--sh_degree", "1"])
    params, state, bg = view_cli.load_model(C.extract_model(args), -1, CPU)

    def render_fn(view, scaling_modifier):
        return renderer.render(params, state, view, bg=bg,
                               scaling_modifier=scaling_modifier)

    gui = pgui.NetworkGUI("127.0.0.1", 0)
    stop = threading.Event()
    server = threading.Thread(target=view_cli.serve, args=(
        gui, render_fn, "src", state.num_active, CPU, stop))
    server.start()
    try:
        view = transforms.world_to_view(np.eye(3), np.array([0.0, 0.0, 4.0]))
        proj = transforms.projection_matrix(0.01, 100.0, 1.0, 0.8) @ view
        c = Client(gui.listener.getsockname()[1])
        assert c.handshake() == pmodes.RENDER_ITEMS
        cases = [(m, 1.0) for m in range(6)] + [(0, 0.5)]
        for mode, scaling in cases:
            msg = sibr_message(view, proj, 40, 32, mode=mode, scaling=scaling)
            img, source, metrics = c.frame(msg)
            cam = pgui.camera_from_message(msg)
            expect = _direct_frame(saved_model, cam.to_view(CPU), mode,
                                   scaling)
            assert source == "src"
            assert metrics == {"#": 120, "loss": 0.0}
            assert img == expect.tobytes(), (mode, scaling)
        img, _, metrics = c.frame(dict(msg, resolution_x=0, resolution_y=0))
        assert img == b"" and metrics["#"] == 120
        c.close()
    finally:
        stop.set()
        server.join(timeout=30)
        gui.close()
    assert not server.is_alive()


def test_web_view_cli_serves_a_saved_model(saved_model):
    """cli.web_view's viewer of a saved model: /info from the PLY and
    cameras.json (the JAX script's centre, radius and up), and a /render
    PNG equal to render_net_image of a direct render of that orbit camera,
    in RGB and Normal mode."""
    from feature3dgs_tpu.viewer.web import estimate_up
    from feature3dgs_tpu_torch.cli import web_view
    from feature3dgs_tpu_torch.model.ply_io import load_gaussians_ply
    args = web_view.build_parser().parse_args(
        ["-m", saved_model, "--sh_degree", "1", "--port", "0"])
    assert web_view.build_parser().parse_args([]).port == 8090
    viewer = web_view.make_viewer(args, CPU).serve_background()
    try:
        info = json.loads(_get(viewer, "/info")[0])
        params, state = load_gaussians_ply(
            os.path.join(saved_model, "point_cloud", "iteration_7",
                         "point_cloud.ply"), max_sh_degree=1, device=CPU)
        xyz = params.xyz.numpy()
        center = xyz.mean(axis=0)
        radius = float(np.percentile(np.linalg.norm(xyz - center, axis=1),
                                     90))
        with open(os.path.join(saved_model, "cameras.json")) as f:
            up = estimate_up(json.load(f))
        assert info["n_gaussians"] == 120 and info["feature_dim"] == 4
        np.testing.assert_allclose(info["center"], center, rtol=1e-12)
        assert info["radius"] == pytest.approx(radius, rel=1e-12)
        np.testing.assert_allclose(info["up"], up)
        for mode in (0, 3):
            q = {"az": "0.4", "el": "0.2", "w": "40", "h": "32",
                 "mode": str(mode)}
            png, _ = _get(viewer, "/render?" + "&".join(
                f"{k}={v}" for k, v in q.items()))
            cam, m, scaling = viewer.camera(q)
            expect = _direct_frame(saved_model, cam.to_view(CPU), m, scaling)
            np.testing.assert_array_equal(_png(png), expect)
    finally:
        viewer.close()


@pytest.mark.parametrize("script", ["view", "web_view"])
def test_every_script_flag_parses_in_the_port(script):
    """Each option string of scripts/<script>.py's parser parses in the
    port's CLI of the same name."""
    import importlib
    import importlib.util
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        f"_script_{script}", os.path.join(root, "scripts", f"{script}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    theirs = _parser_of(module.main)
    ours = importlib.import_module(
        f"feature3dgs_tpu_torch.cli.{script}").build_parser()
    options = [(a, o) for a in theirs._actions for o in a.option_strings
               if o not in ("-h", "--help")]
    assert len(options) > 20
    for action, option in options:
        argv = _sample(action, option)
        try:
            ours.parse_args(argv)
        except SystemExit:
            pytest.fail(f"port {script} CLI refuses {argv}")
        assert ours.get_default(action.dest) == action.default, option


def test_videos_cli_matches_script(tmp_path):
    """cli.videos and scripts/videos.py on the same frame folders: the
    same mp4 files, decoding to the same frames."""
    import cv2
    from PIL import Image

    import scripts.videos as jax_videos
    from feature3dgs_tpu_torch.cli import videos as port_videos
    rng = np.random.RandomState(0)
    outs = {}
    for name, main in (("jax", jax_videos.main), ("port", port_videos.main)):
        model = tmp_path / name
        for kind in ("renders", "feature_map"):
            d = model / "video" / "ours_7" / kind
            d.mkdir(parents=True)
            for i in range(3):
                Image.fromarray(rng.randint(0, 256, (32, 48, 3)).astype(
                    np.uint8)).save(d / f"{i:05d}.png")
        rng = np.random.RandomState(0)
        (model / "novel_views" / "ours_3" / "renders").mkdir(parents=True)
        main(["-m", str(model), "--fps", "10"])
        outs[name] = sorted(f for f in os.listdir(model) if f.endswith(".mp4"))
        assert outs[name] == ["video_ours_7_feature_map.mp4",
                              "video_ours_7_renders.mp4"]

    def frames(path):
        cap = cv2.VideoCapture(str(path))
        got = []
        while True:
            ok, f = cap.read()
            if not ok:
                return got
            got.append(f)

    for f in outs["jax"]:
        a, b = frames(tmp_path / "jax" / f), frames(tmp_path / "port" / f)
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_train_cli_serves_the_viewer_while_training(tmp_path):
    """The train CLI in process (--device cpu, a 48x48 scene, 30
    iterations, sync every 5) with the viewer on a free port: a client
    connects while it trains and gets 3 RGB frames of the model and the
    metrics across 3 sync windows (one frame a sync point: each message
    asks to train on); the CLI finishes, writes its PLY and TensorBoard's
    event file (where torch.utils.tensorboard imports)."""
    from feature3dgs_tpu_torch.cli import train as train_cli
    from feature3dgs_tpu_torch.data.dataset import load_scene
    from feature3dgs_tpu_torch.data.synthetic import write_blender_scene
    scene = write_blender_scene(str(tmp_path / "scene"), n_frames=2,
                                size=48, f_dim=4, n_pts=200, seed=0)
    out = str(tmp_path / "out")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    cam = load_scene(scene, foundation_model="lseg").train_cameras[0]
    msg = sibr_message(cam.view, cam.full_proj, 48, 32, fovx=cam.fovx,
                       fovy=cam.fovy)
    got = {"frames": [], "metrics": []}

    def client():
        c = Client(port, timeout=120)
        got["items"] = c.handshake()
        for _ in range(3):
            img, source, metrics = c.frame(msg)
            got["frames"].append(img)
            got["metrics"].append(metrics)
            got["source"] = source
        c.close()

    t = threading.Thread(target=client, daemon=True)
    t.start()
    rc = train_cli.main([
        "-s", scene, "-m", out, "-f", "lseg", "--iterations", "30",
        "--save_iterations", "30", "--test_iterations", "30",
        "--sync_every", "5", "--device", "cpu", "--tile_size", "16",
        "--chunk", "16", "--densify_from_iter", "3",
        "--densification_interval", "10", "--densify_grad_threshold", "1e-7",
        "--ip", "127.0.0.1", "--port", str(port), "--quiet"])
    t.join(timeout=60)
    assert rc == 0 and not t.is_alive()
    assert got["items"] == pmodes.RENDER_ITEMS
    assert len(got["frames"]) == 3
    assert got["source"] == os.path.abspath(scene)
    for img, metrics in zip(got["frames"], got["metrics"]):
        frame = np.frombuffer(img, np.uint8).reshape(32, 48, 3)
        assert frame.std() > 0
        assert metrics["#"] >= 200 and np.isfinite(metrics["loss"])
    assert os.path.exists(os.path.join(
        out, "point_cloud", "iteration_30", "point_cloud.ply"))
    try:
        import torch.utils.tensorboard  # noqa: F401
    except Exception:
        return
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(out))
