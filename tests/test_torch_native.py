"""The port's native host helpers and its framework-free CLIs.

``native/loader.py`` builds ``native/src/f3dgs_native.cc`` with the host's
C++ compiler. Its 3-NN (``ops/knn.py:mean_sq_dist_3nn``) is held against
``scipy.spatial.cKDTree`` (exact) and the JAX package's
``mean_sq_dist_3nn`` at tests/test_data.py:63-79's rtol 1e-5 / atol 1e-7,
its points3D.bin scanner (``data/colmap.py:read_points3d_binary``) bit for
bit against the JAX reader. ``cli.convert`` and ``cli.jpg2png`` run beside
``scripts/convert.py`` and ``scripts/jpg2png.py`` on the same inputs, COLMAP
being a stub that records its command lines.
"""
import importlib
import importlib.util
import os
import stat
import struct
import subprocess
import sys

import numpy as np
import pytest
from scipy.spatial import cKDTree

from feature3dgs_tpu.data import colmap as jcolmap
from feature3dgs_tpu.ops import knn as jknn
from feature3dgs_tpu_torch.data import colmap as pcolmap
from feature3dgs_tpu_torch.native import loader
from feature3dgs_tpu_torch.ops import knn as pknn

from tests.test_torch_train_cli import _parser_of, _sample

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cloud(name: str) -> np.ndarray:
    rng = np.random.RandomState(3)
    if name == "cluster_halo":
        # a dense cluster and a sparse halo exercise the grid's ring sweep
        return np.concatenate([
            rng.randn(8000, 3).astype(np.float32) * 0.1,
            rng.uniform(-5, 5, (2000, 3)).astype(np.float32)])
    if name == "duplicates":
        # every point three times or more: zero distances, ties
        base = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
        return np.concatenate([base, base, base, base[:100]])
    assert name == "planar"       # one axis of zero extent
    pts = rng.uniform(-2, 2, (3000, 3)).astype(np.float32)
    pts[:, 2] = 0.5
    return pts


CLOUDS = ["cluster_halo", "duplicates", "planar"]


@pytest.mark.parametrize("cloud", CLOUDS)
def test_knn_matches_kdtree(cloud):
    pts = _cloud(cloud)
    got = pknn.mean_sq_dist_3nn(pts)
    d, _ = cKDTree(pts).query(pts, k=4)
    want = (d[:, 1:] ** 2).mean(axis=1).astype(np.float32)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("cloud", CLOUDS)
def test_knn_matches_jax(cloud):
    pts = _cloud(cloud)
    np.testing.assert_allclose(pknn.mean_sq_dist_3nn(pts),
                               jknn.mean_sq_dist_3nn(pts), rtol=1e-5,
                               atol=1e-7)


def _points3d_file(path, n, track_lens, seed=0):
    """points3D.bin of n records with the given track lengths (cycled)."""
    rng = np.random.RandomState(seed)
    xyz = rng.randn(n, 3)
    rgb = rng.randint(0, 256, (n, 3)).astype(np.uint8)
    err = rng.rand(n)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            tl = track_lens[i % len(track_lens)]
            f.write(struct.pack("<Q", i + 1) + xyz[i].astype("<f8").tobytes()
                    + rgb[i].tobytes() + struct.pack("<dQ", err[i], tl)
                    + rng.randint(0, 1000, 2 * tl).astype("<i4").tobytes())
    return xyz, rgb, err


@pytest.mark.parametrize("tracks", ["writer", "variable"])
def test_points3d_bit_equal_to_jax_reader(tmp_path, tracks):
    """From data/colmap.py's writer (tracks of length 0) and with tracks
    of 0-5 entries: every field equal bit for bit to the JAX reader's and
    to what was written."""
    if tracks == "writer":
        rng = np.random.RandomState(1)
        xyz = rng.randn(300, 3)
        rgb = rng.randint(0, 256, (300, 3)).astype(np.uint8)
        cam = pcolmap.ColmapCamera(1, "PINHOLE", 32, 24,
                                   np.array([30.0, 30.0, 16.0, 12.0]))
        pcolmap.write_dummy_model(str(tmp_path), [cam], [], xyz, rgb)
        err = np.zeros(300)
    else:
        xyz, rgb, err = _points3d_file(tmp_path / "points3D.bin", 257,
                                       [0, 3, 1, 5, 2])
    path = str(tmp_path / "points3D.bin")
    got = pcolmap.read_points3d_binary(path)
    ref = jcolmap.read_points3d_binary(path)
    for name, a, b, w in zip(("xyz", "rgb", "error"), got, ref,
                             (xyz, rgb, err)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes() == np.asarray(w, a.dtype).tobytes(), \
            name


@pytest.mark.parametrize("cut", ["last_track", "last_record", "header"])
def test_points3d_truncated_file_raises(tmp_path, cut):
    path = tmp_path / "points3D.bin"
    _points3d_file(path, 40, [2])
    data = path.read_bytes()
    if cut == "last_track":
        data = data[:-4]
    elif cut == "last_record":
        data = data[:-30]
    else:               # a count no file of this size can hold
        data = struct.pack("<Q", 1 << 40) + data[8:]
    path.write_bytes(data)
    with pytest.raises(RuntimeError, match="truncated"):
        pcolmap.read_points3d_binary(str(path))


def _python_script(path, body: str) -> str:
    path.write_text(f"#!{sys.executable}\nimport os, subprocess, sys, time\n"
                    + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_loader_builds_once_under_concurrent_first_use(tmp_path):
    """Two processes load at once from an empty build directory: one
    compiles (the compiler wrapper logs each library build and sleeps to
    widen the race), both load and compute the same 3-NN, and no
    temporary file is left."""
    log = tmp_path / "builds.log"
    cxx = _python_script(tmp_path / "cxx", (
        "if '-shared' in sys.argv:\n"
        f"    open({str(log)!r}, 'a').write('build\\n')\n"
        "    time.sleep(1.0)\n"
        "sys.exit(subprocess.call(['g++'] + sys.argv[1:]))\n"))
    build_dir = tmp_path / "native"
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "from feature3dgs_tpu_torch.native import loader\n"
        "loader.BUILD_DIR = Path(sys.argv[1])\n"
        "pts = np.random.RandomState(0).rand(64, 3).astype(np.float32)\n"
        "print(loader.knn_mean_sq_dist(pts).sum())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CXX"] = cxx
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build_dir)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    assert outs[0][0] == outs[1][0]
    assert log.read_text() == "build\n"
    libs = sorted(p.name for p in build_dir.iterdir() if p.suffix == ".so")
    assert len(libs) == 1 and ".tmp" not in libs[0], libs


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_loader_raises_with_the_compilers_log(tmp_path, monkeypatch,
                                              compiler):
    if compiler == "missing":
        cxx, expect = str(tmp_path / "no-such-g++"), "no-such-g\\+\\+"
    else:
        cxx = _python_script(tmp_path / "cxx", (
            "if '-shared' in sys.argv:\n"
            "    print('f3dgs_native.cc:1: error: seeded failure')\n"
            "    sys.exit(1)\n"
            "sys.exit(subprocess.call(['g++'] + sys.argv[1:]))\n"))
        expect = "seeded failure"
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "native")
    with pytest.raises(RuntimeError, match=expect):
        loader.build()
    assert not any((tmp_path / "native").glob("*.so"))


# ---------------------------------------------------------------- the CLIs

def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tree(root) -> dict:
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _colmap_stub(tmp_path) -> tuple:
    """A COLMAP stand-in: records each command line, makes the mapper's
    and the undistorter's outputs (images copied, a sparse model)."""
    record = tmp_path / "colmap_calls.txt"
    stub = _python_script(tmp_path / "colmap", (
        "import shutil\n"
        "args = sys.argv[1:]\n"
        f"open({str(record)!r}, 'a').write(' '.join(args) + '\\n')\n"
        "opt = lambda k: args[args.index(k) + 1]\n"
        "if args[0] == 'mapper':\n"
        "    os.makedirs(os.path.join(opt('--output_path'), '0'), "
        "exist_ok=True)\n"
        "if args[0] == 'image_undistorter':\n"
        "    out = opt('--output_path')\n"
        "    shutil.copytree(opt('--image_path'), os.path.join(out, 'images'))\n"
        "    os.makedirs(os.path.join(out, 'sparse'), exist_ok=True)\n"
        "    for name in ('cameras.bin', 'images.bin', 'points3D.bin'):\n"
        "        open(os.path.join(out, 'sparse', name), 'wb').write("
        "name.encode())\n"))
    return stub, record


def _input_images(src):
    from PIL import Image
    os.makedirs(os.path.join(src, "input"))
    rng = np.random.RandomState(0)
    for i, (w, h) in enumerate([(64, 48), (50, 37), (64, 48)]):
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
                        ).save(os.path.join(src, "input", f"frame_{i}.png"))


@pytest.mark.parametrize("flags", [[], ["--skip_matching"], ["--no_gpu"],
                                   ["--resize", "--camera", "PINHOLE"]],
                         ids=["default", "skip_matching", "no_gpu", "resize"])
def test_convert_cli_matches_script(tmp_path, capsys, flags):
    from feature3dgs_tpu_torch.cli import convert as port_convert
    stub, record = _colmap_stub(tmp_path)
    runs = {}
    for name, main in (("jax", _script("convert").main),
                       ("port", port_convert.main)):
        src = str(tmp_path / name / "scene")
        _input_images(src)
        record.write_text("")
        main(["-s", src, "--colmap_executable", stub, *flags])
        runs[name] = (record.read_text().replace(src, "<src>"),
                      capsys.readouterr().out.replace(src, "<src>"),
                      _tree(src))
    assert runs["port"] == runs["jax"]
    calls, out, tree = runs["port"]
    assert len(calls.splitlines()) == (1 if "--skip_matching" in flags else 4)
    assert "sparse/0/points3D.bin" in tree and out.endswith("Done.\n")
    assert ("images_8/frame_1.png" in tree) == ("--resize" in flags)


def test_convert_cli_without_colmap(tmp_path, monkeypatch):
    from feature3dgs_tpu_torch.cli import convert as port_convert
    monkeypatch.setenv("PATH", str(tmp_path))
    codes = []
    for main in (_script("convert").main, port_convert.main):
        with pytest.raises(SystemExit) as e:
            main(["-s", str(tmp_path / "scene")])
        codes.append(e.value.code)
    assert codes[0] == codes[1] and "COLMAP binary not found" in codes[0]


@pytest.mark.parametrize("flags", [[], ["--delete"], ["--output"],
                                   ["--output", "--delete"]],
                         ids=["in_place", "delete", "output", "output_delete"])
def test_jpg2png_cli_matches_script(tmp_path, capsys, flags):
    from PIL import Image

    from feature3dgs_tpu_torch.cli import jpg2png as port_jpg2png
    runs = {}
    for name, main in (("jax", _script("jpg2png").main),
                       ("port", port_jpg2png.main)):
        src, out = tmp_path / name / "in", tmp_path / name / "out"
        os.makedirs(src)
        rng = np.random.RandomState(0)
        for i, fname in enumerate(["a.jpg", "b.JPG", "c.jpeg", "d.png"]):
            Image.fromarray(rng.randint(0, 256, (24 + i, 32, 3)).astype(
                np.uint8)).save(src / fname, format="JPEG" if i < 3 else "PNG")
        (src / "notes.txt").write_text("kept")
        argv = ["-i", str(src)] + [a for f in flags for a in (
            [f, str(out)] if f == "--output" else [f])]
        assert main(argv) == 0
        runs[name] = (_tree(src), _tree(out) if out.exists() else None,
                      capsys.readouterr().out.replace(str(tmp_path / name),
                                                      "<root>"))
    assert runs["port"] == runs["jax"]
    inputs, outputs, said = runs["port"]
    pngs = outputs if "--output" in flags else inputs
    assert {"a.png", "b.png", "c.png"} <= set(pngs)
    assert ("a.jpg" in inputs) == ("--delete" not in flags)
    assert said.startswith("converted 3 images -> ")


@pytest.mark.parametrize("script", ["parity_check", "convert", "jpg2png"])
def test_every_script_flag_parses_in_the_port(script):
    """Each option string of scripts/<script>.py's parser parses in the
    port's CLI of the same name, with the same default.
    scripts/parity_check.py takes no options (its main reads no argv); the
    port's adds only --device."""
    port_main = importlib.import_module(
        f"feature3dgs_tpu_torch.cli.{script}").main
    ours = _parser_of(port_main)
    if script == "parity_check":
        with open(os.path.join(ROOT, "scripts", "parity_check.py")) as f:
            assert "add_argument" not in f.read()
        assert [o for a in ours._actions for o in a.option_strings] == [
            "-h", "--help", "--device"]
        ours.parse_args([])
        return
    theirs = _parser_of(_script(script).main)
    options = [(a, o) for a in theirs._actions for o in a.option_strings
               if o not in ("-h", "--help")]
    assert len(options) >= 4
    required = [o for a in theirs._actions if a.required
                for o in (a.option_strings[0], "x")]
    for action, option in options:
        argv = _sample(action, option) + ([] if action.required else required)
        try:
            ours.parse_args(argv)
        except SystemExit:
            pytest.fail(f"port {script} CLI refuses {argv}")
        assert ours.get_default(action.dest) == action.default, option
