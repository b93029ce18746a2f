"""The PyTorch port stands alone: no JAX, flax or feature3dgs_tpu module is
imported by the port or by chip_smoke.py, and the port does not fall back
to the CPU when CUDA is missing."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "feature3dgs_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "feature3dgs_tpu")


def _port_sources():
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    return any(name == m or name.startswith(m + ".") for m in FORBIDDEN)


def test_port_sources_import_nothing_of_jax():
    """Every import statement, module level or inside a function."""
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{path}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad
    covered = {os.path.relpath(p, PORT) for p in _port_sources()}
    assert {"native/loader.py", "cli/parity_check.py", "cli/convert.py",
            "cli/jpg2png.py", "ops/oracle.py", "bench_utils.py",
            "cli/bench.py", "cli/bench_render.py", "cli/profile_step.py",
            "cli/bench_longrun.py", "cli/bench_scaling.py",
            "cli/micro_segsum.py", "cli/micro_expand.py",
            "cli/micro_pack.py"} <= covered


def test_native_loader_opens_nothing_of_the_jax_package(tmp_path):
    """From an empty build directory the loader compiles, loads and runs
    its own copy of the native source: an audit hook sees every file
    opened, process started and library loaded, and none is under
    feature3dgs_tpu/ (whose checked-in libf3dgs_native.so is the JAX
    package's)."""
    code = (
        "import sys\n"
        "seen = []\n"
        "sys.addaudithook(lambda ev, args: seen.append((ev, repr(args))) if ev "
        "in ('open', 'subprocess.Popen', 'ctypes.dlopen') else None)\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        "from feature3dgs_tpu_torch.native import loader\n"
        "loader.BUILD_DIR = Path(sys.argv[1])\n"
        "loader.knn_mean_sq_dist(np.random.rand(32, 3))\n"
        "import struct\n"
        "loader.colmap_scan_points3d(struct.pack('<Q', 0), 0)\n"
        "jax_dir = sys.argv[2]\n"
        "bad = [s for s in seen if jax_dir in s[1]]\n"
        "loads = [s for s in seen if s[0] == 'ctypes.dlopen' and 'f3dgs' in "
        "s[1]]\n"
        "assert not bad, bad\n"
        "assert len(loads) == 1 and sys.argv[1] in loads[0][1], loads\n"
        "print(sum(s[0] == 'subprocess.Popen' for s in seen))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "native"),
         os.path.join(ROOT, "feature3dgs_tpu") + os.sep], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) == 2     # the target query, the build


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import feature3dgs_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = [n for n in sys.modules if any(n == m or n.startswith(m + '.') "
        f"for m in {FORBIDDEN!r})]\n"
        "print(len([n for n in sys.modules if n.startswith('feature3dgs_tpu_torch')]))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20   # every module was imported


def test_first_threaded_cpu_math_is_exact():
    """In a fresh process the first multi-threaded torch.exp on the CPU can
    return values off by ~1e-4 relative (about one process in two without
    the warm-up in feature3dgs_tpu_torch/__init__.py); importing the port
    must make it exact. Six processes: all clean."""
    code = (
        "import numpy as np, torch\n"
        "import feature3dgs_tpu_torch\n"
        "torch.set_num_threads(8)\n"
        "(torch.ones(1 << 20) + 1).sum()\n"
        "x = torch.from_numpy(np.random.RandomState(0).rand(6, 24, 256)"
        ".astype(np.float32) * -3.0)\n"
        "print(int((torch.exp(x) != torch.exp(x)).sum()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert [int(o.split()[-1]) for o, _ in outs] == [0] * 6


def test_default_device_needs_cuda_unless_cpu_is_asked(monkeypatch):
    from feature3dgs_tpu_torch import default_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        default_device("cuda")
    assert default_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _ply(tmp_path) -> str:
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.model.ply_io import save_gaussians_ply
    pts = np.random.RandomState(0).rand(5, 3).astype(np.float32)
    params, state = G.create_from_pcd(pts, pts, knn_mean_dists=np.ones(5),
                                      feature_dim=4, device="cpu")
    path = str(tmp_path / "point_cloud.ply")
    save_gaussians_ply(path, params, state)
    return path


def _call_entry_point(name, tmp_path, **kw):
    from feature3dgs_tpu_torch import convert
    from feature3dgs_tpu_torch.data.cameras import Camera
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.model.decoder import init_decoder
    from feature3dgs_tpu_torch.model.ply_io import load_gaussians_ply
    from feature3dgs_tpu_torch.train.checkpoints import load_decoder_checkpoint
    pts = np.zeros((3, 3), np.float32)
    eye = np.eye(4, dtype=np.float32)
    if name == "load_gaussians_ply":
        return load_gaussians_ply(_ply(tmp_path), **kw)
    if name == "load_decoder_checkpoint":
        # the device is resolved before the file is opened
        return load_decoder_checkpoint(str(tmp_path / "missing.ckpt"), **kw)
    if name == "init_decoder":
        return init_decoder(4, 16, **kw)
    if name == "create_from_pcd":
        return G.create_from_pcd(pts, pts, knn_mean_dists=np.ones(3), **kw)
    if name == "Camera.to_view":
        cam = Camera(uid=0, colmap_id=0, R=np.eye(3), T=np.zeros(3),
                     fovx=1.0, fovy=0.8, image=None, image_name="x",
                     semantic_feature=None, width=8, height=6)
        return cam.to_view(**kw)
    fields = {k: np.zeros((3, 1)) for k in G.GaussianParams.FIELDS}
    if name == "gaussians_from_numpy":
        return convert.gaussians_from_numpy(fields, np.ones(3, bool), 0, **kw)
    if name == "train_state_from_numpy":
        z = np.zeros(3)
        return convert.train_state_from_numpy({
            "params": fields,
            "gstate": {"alive": np.ones(3, bool), "max_radii2d": z,
                       "xyz_gradient_accum": z, "denom": z,
                       "active_sh_degree": 0, "spatial_lr_scale": 1.0},
            "adam": {"mu": fields, "nu": fields, "step": 0}}, **kw)
    if name in ("init_adam", "TrainState.create"):
        from feature3dgs_tpu_torch.model.optim import init_adam
        from feature3dgs_tpu_torch.train.trainer import TrainState
        params, gstate = convert.gaussians_from_numpy(
            fields, np.ones(3, bool), 0, "cpu")
        if name == "init_adam":
            return init_adam(params, **kw)
        return TrainState.create(params, gstate, **kw)
    if name == "decoder_from_numpy":
        return convert.decoder_from_numpy({"w": eye, "b": eye[0]}, **kw)
    if name == "load_checkpoint":
        # the device is resolved before the file is opened
        from feature3dgs_tpu_torch.train.checkpoints import load_checkpoint
        return load_checkpoint(str(tmp_path / "missing.ckpt"), **kw)
    if name in ("Trainer", "DistributedTrainer", "DistributedTrainer.shard",
                "MultiHostTrainer"):
        from feature3dgs_tpu_torch.data.synthetic import synthetic_scene
        from feature3dgs_tpu_torch.parallel import (DistributedTrainer,
                                                    make_mesh)
        from feature3dgs_tpu_torch.parallel.multihost import MultiHostTrainer
        from feature3dgs_tpu_torch.train.trainer import Trainer
        sc = synthetic_scene(n_cams=2, w=16, h=16, n_pts=8, f_dim=4)
        if name == "Trainer":
            return Trainer(sc, **kw)
        if name == "MultiHostTrainer":
            return MultiHostTrainer(sc, mesh=make_mesh((1, 1)), **kw)
        return DistributedTrainer(
            sc, mesh=make_mesh((1, 1)), cameras_per_step=2,
            shard_gaussians=name.endswith("shard"),
            shard_instances=name.endswith("shard"), **kw)
    if name == "parallel.initialize":
        # a single process (no WORLD_SIZE): the device is resolved, no group
        from feature3dgs_tpu_torch.parallel.distributed import initialize
        assert "WORLD_SIZE" not in os.environ
        assert initialize(**kw) is False
        return None
    if name in ("cli.train.main", "cli.train.main.sharded"):
        from feature3dgs_tpu_torch.cli import train
        # the device is resolved before the scene is read
        argv = ["-s", str(tmp_path / "no_scene"), "-m", str(tmp_path / "out")]
        if name.endswith("sharded"):
            argv += ["--distributed", "--mesh", "1x1", "--shard_gaussians",
                     "--shard_instances"]
        return train.main(argv + (["--device", kw["device"]] if kw else []))
    if name == "build_lseg":
        from feature3dgs_tpu_torch.encoders.lseg_net import build_lseg
        return build_lseg(VIT_DIM=8, VIT_DEPTH=1, VIT_HEADS=2, PATCH=8,
                          IMG_SIZE=16, HOOKS=(0, 0, 0, 0),
                          REASSEMBLE=(4, 4, 4, 4), FEATURES=4, OUT_C=4, **kw)
    if name == "encoder_state_from_numpy":
        return convert.encoder_state_from_numpy({"w": eye}, **kw)
    if name == "ViewerCamera.to_view":
        from feature3dgs_tpu_torch.viewer.network_gui import ViewerCamera
        return ViewerCamera(8, 6, 1.0, 0.8, 0.01, 100.0, eye, eye, True,
                            True, 1.0, 0).to_view(**kw)
    if name == "load_lpips_weights":
        from feature3dgs_tpu_torch.metrics.lpips import load_lpips_weights
        return load_lpips_weights(str(tmp_path / "missing.npz"), **kw)
    if name in BENCH_CLIS:
        # the measuring CLIs resolve their device first; on the CPU they run
        # at a tiny scene (module constants shrunk where the scene is one)
        import importlib
        module = importlib.import_module(
            "feature3dgs_tpu_torch." + name.rsplit(".", 1)[0])
        argv, sizes = BENCH_CLIS[name]
        saved = {k: getattr(module, k) for k in sizes}
        try:
            for k, v in sizes.items():
                setattr(module, k, v)
            return module.main(argv + (["--device", kw["device"]] if kw
                                       else []))
        finally:
            for k, v in saved.items():
                setattr(module, k, v)
    if name.startswith("cli."):
        # each CLI resolves its device before it reads anything
        import importlib
        module = importlib.import_module(
            "feature3dgs_tpu_torch." + name.rsplit(".", 1)[0])
        missing = str(tmp_path / "missing")
        argv = {"cli.render.main": ["-m", missing],
                "cli.segmentation.main": [
                    "--feature_dir", missing, "--output", missing,
                    "--text_features", missing + ".npy"],
                "cli.segmentation_metric.main": [
                    "--student_dir", missing, "--teacher_dir", missing,
                    "--label_src", "a,b", "--text_features", missing + ".npy"],
                "cli.metrics.main": ["-m", missing],
                "cli.full_eval.main": ["--output_path", missing],
                "cli.view.main": ["-m", missing],
                "cli.web_view.main": ["-m", missing],
                "cli.encode_lseg.main": ["--input", missing,
                                         "--outdir", missing]}[name]
        return module.main(argv + (["--device", kw["device"]] if kw else []))
    assert name == "camera_from_numpy"
    return convert.camera_from_numpy(eye, eye, eye[0, :3], 0.5, 0.4, 8, 6,
                                     **kw)


_TINY = ["--n_gauss", "50", "--width", "32", "--height", "16"]
# the measuring CLIs: (argv, module constants) of a tiny CPU run
BENCH_CLIS = {
    "cli.bench.main": (["--f_dim", "4"], dict(N_GAUSS=50, W=32, H=16,
                                              ITERS=1)),
    "cli.bench_render.main": (_TINY + ["--f_dims", "4", "--iters", "1"], {}),
    "cli.profile_step.main": (_TINY + ["--f_dim", "4", "--n", "1",
                                       "--instance_capacity", "4096"], {}),
    "cli.bench_longrun.main": (["--iters", "12", "--warmup", "7",
                                "--densify_interval", "3", "--sync_every",
                                "2"], dict(N_GAUSS=50, W=32, H=16, F_DIM=4)),
    "cli.bench_scaling.main": (_TINY + ["--f_dim", "4", "--iters", "1",
                                        "--instance_capacity", "4096"], {}),
    "cli.micro_segsum.main": (["--l", "2048", "--n", "100", "--c", "4",
                               "--iters", "1"], {}),
    "cli.micro_expand.main": (["--l", "2048", "--n", "100", "--iters", "1"],
                              {}),
    "cli.micro_pack.main": (_TINY + ["--iters", "1"], dict(L=2048, N=100))}

ENTRY_POINTS = ["load_gaussians_ply", "load_decoder_checkpoint",
                "init_decoder", "create_from_pcd", "Camera.to_view",
                "gaussians_from_numpy", "decoder_from_numpy",
                "camera_from_numpy", "train_state_from_numpy", "init_adam",
                "TrainState.create", "load_checkpoint", "Trainer",
                "DistributedTrainer", "DistributedTrainer.shard",
                "MultiHostTrainer", "parallel.initialize",
                "load_lpips_weights", "cli.train.main",
                "cli.train.main.sharded", "cli.render.main",
                "cli.segmentation.main", "cli.segmentation_metric.main",
                "cli.metrics.main", "cli.full_eval.main", "build_lseg",
                "encoder_state_from_numpy", "ViewerCamera.to_view",
                "cli.view.main", "cli.web_view.main", "cli.encode_lseg.main",
                *BENCH_CLIS]
# the device is resolved first, then these fail on their missing input
NEEDS_A_FILE = {"load_decoder_checkpoint": FileNotFoundError,
                "load_checkpoint": FileNotFoundError,
                "cli.train.main": ValueError,
                "cli.train.main.sharded": ValueError,
                "cli.render.main": FileNotFoundError,
                "cli.segmentation.main": FileNotFoundError,
                "cli.segmentation_metric.main": FileNotFoundError,
                "cli.view.main": FileNotFoundError,
                "cli.web_view.main": FileNotFoundError,
                # no LSEG_WEIGHTS and no --fallback_clip
                "cli.encode_lseg.main": SystemExit}


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_the_card(name, tmp_path, monkeypatch):
    """Without a device argument every entry point that makes tensors asks
    for the CUDA card, so without CUDA it raises instead of quietly
    serving from the CPU; device='cpu' is honoured."""
    if name in NEEDS_A_FILE:
        with pytest.raises(NEEDS_A_FILE[name]):
            _call_entry_point(name, tmp_path, device="cpu")
    else:
        _call_entry_point(name, tmp_path, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _call_entry_point(name, tmp_path)


def test_parity_check_defaults_to_the_card(monkeypatch):
    """cli.parity_check resolves its device before it builds the scene."""
    from feature3dgs_tpu_torch.cli import parity_check
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parity_check.main([])


def test_backward_kernel_wrapper_raises_on_cpu_tensors():
    """No hidden fallback: the backward kernel's wrapper refuses CPU
    tensors (the plain version runs only through ops.rasterize's choice)."""
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.binning import TileGrid
    grid = TileGrid(32, 16, 32, 16)
    n, p = 4, grid.pixels_per_tile
    z = lambda *shape: torch.zeros(shape)
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_raster.raster_backward_cuda(
            z(n, 2), z(n, 3), z(n), z(n, 3), z(n), z(n, 4), i32(0), i32(1),
            i32(1), grid, z(1, p, 3), z(1, p, 4), z(1, p), z(1, p), z(1, p),
            i32(1, p))


def test_host_side_helpers_need_no_device():
    """The synthetic scene, the KNN and a densify round on CPU tensors run
    without CUDA and without asking for a device."""
    from feature3dgs_tpu_torch.data.synthetic import synthetic_scene
    from feature3dgs_tpu_torch.model import density, optim
    from feature3dgs_tpu_torch.model import gaussians as G
    from feature3dgs_tpu_torch.ops.knn import mean_sq_dist_3nn
    scene = synthetic_scene(n_cams=2, w=16, h=12, n_pts=10, f_dim=4)
    assert len(scene.train_cameras) == 2 and scene.points.shape == (10, 3)
    assert mean_sq_dist_3nn(scene.points).shape == (10,)
    params, state = G.create_from_pcd(scene.points, scene.colors,
                                      feature_dim=4, capacity=16, device="cpu")
    _, state, _, report = density.densify_and_prune(
        params, state, optim.init_adam(params, "cpu"), torch.zeros(2, 16, 3),
        max_grad=1.0, min_opacity=0.005, extent=4.0, percent_dense=0.01,
        use_screen_size_prune=False)
    assert int(report.num_active) == 10 == state.num_active


def test_alpha_mode_wrappers_raise_on_cpu_tensors():
    """No hidden fallback in the alpha_matmul mode either."""
    from feature3dgs_tpu_torch.ops import cuda_raster
    from feature3dgs_tpu_torch.ops.binning import TileGrid
    grid = TileGrid(32, 16, 32, 16)
    n = 4
    z = lambda *shape: torch.zeros(shape)
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    before = cuda_raster.FORWARD_MM_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_raster.raster_forward_cuda(
            z(n, 2), z(n, 3), z(n), z(n, 3), z(n), z(n, 4), i32(0), i32(1),
            i32(1), grid, alpha_matmul=True)
    assert cuda_raster.FORWARD_MM_LAUNCHES == before
