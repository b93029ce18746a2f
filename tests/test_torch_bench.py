"""The port's measuring layer against the JAX package's on the CPU:
``feature3dgs_tpu_torch/bench_utils.py`` and the bench CLIs ``cli.bench``,
``cli.bench_render``, ``cli.profile_step``, ``cli.bench_longrun`` and
``cli.bench_scaling`` against ``bench.py`` and ``scripts/``: the scenes'
arrays, the printed keys and table format at tiny scenes, the long run's
span rule, a 2-rank gloo scaling run, and every option of these five JAX
programs and of the three stage micro-benchmarks parsing in the port's
CLIs (tests/test_torch_micro.py holds the micro-benchmarks' numbers)."""
import ast
import importlib.util
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from feature3dgs_tpu_torch import bench_utils
from feature3dgs_tpu_torch.cli import bench as bench_cli
from feature3dgs_tpu_torch.cli import bench_longrun as longrun_cli
from feature3dgs_tpu_torch.cli import bench_render as render_cli
from feature3dgs_tpu_torch.cli import bench_scaling as scaling_cli
from feature3dgs_tpu_torch.cli import micro_expand as expand_cli
from feature3dgs_tpu_torch.cli import micro_pack as pack_cli
from feature3dgs_tpu_torch.cli import micro_segsum as segsum_cli
from feature3dgs_tpu_torch.cli import profile_step as profile_cli
from feature3dgs_tpu_torch.model.gaussians import GaussianParams

from tests.test_torch_train_cli import _parser_of, _sample
from tests.torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--n_gauss", "200", "--width", "64", "--height", "48"]


def _script(rel: str):
    """A JAX program of the repository (bench.py or scripts/*.py) loaded as
    a module."""
    name = "_jax_" + os.path.splitext(os.path.basename(rel))[0]
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _dumped_keys(rel: str) -> tuple:
    """(top-level keys, keys of "detail") of the dict literal that the
    program's ``json.dumps`` call prints."""
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and node.args and isinstance(node.args[0],
                                                        ast.Dict)):
            d = node.args[0]
            keys = {k.value for k in d.keys}
            detail = next((v for k, v in zip(d.keys, d.values)
                           if k.value == "detail"), None)
            return keys, {k.value for k in detail.keys} if detail else set()
    raise AssertionError(f"no json.dumps of a dict literal in {rel}")


class _Captured(Exception):
    pass


def test_bench_scene_draws_bench_py_arrays(monkeypatch):
    """bench_scene and bench_camera at bench.py's sizes hold what bench.py
    hands its first train_step (captured there, with jax.jit bypassed):
    the same numpy draws, parameters and camera."""
    import feature3dgs_tpu.train.trainer as jtrainer
    seen = {}

    def capture(ts, cam, gt_image, gt_feature, bg, it, **kw):
        seen.update(ts=ts, cam=cam, gt_image=gt_image, gt_feature=gt_feature)
        raise _Captured

    monkeypatch.setattr(jtrainer, "train_step", capture)
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    with pytest.raises(_Captured):
        _script("bench.py").main([])
    params, state, gt_image, gt_feature = bench_utils.bench_scene("cpu")
    jts = seen["ts"]
    for k in GaussianParams.FIELDS:
        np.testing.assert_allclose(getattr(params, k).numpy(),
                                   np.asarray(getattr(jts.params, k)),
                                   rtol=1e-6, atol=0, err_msg=k)
    assert state.active_sh_degree == int(jts.gstate.active_sh_degree) == 3
    np.testing.assert_array_equal(gt_image.numpy(),
                                  np.asarray(seen["gt_image"]))
    np.testing.assert_array_equal(gt_feature.numpy(),
                                  np.asarray(seen["gt_feature"]))
    cam, jcam = bench_utils.bench_camera(device="cpu"), seen["cam"]
    for k in ("view", "proj", "campos", "tan_fovx", "tan_fovy"):
        np.testing.assert_allclose(getattr(cam, k).numpy(),
                                   np.asarray(getattr(jcam, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert (cam.width, cam.height) == (jcam.width, jcam.height) == (1216, 800)


def test_build_inputs_equals_the_scripts():
    """cli.bench_scaling.build_inputs against scripts/bench_scaling.py's
    at --small sizes, two cameras."""
    jts, jcams, jgi, jgf = _script("scripts/bench_scaling.py").build_inputs(
        2000, 16, 256, 192, 2, 2000)
    ts, cams, gi, gf = scaling_cli.build_inputs(2000, 16, 256, 192, 2, 2000,
                                                "cpu")
    for k in GaussianParams.FIELDS:
        np.testing.assert_allclose(getattr(ts.params, k).numpy(),
                                   np.asarray(getattr(jts.params, k)),
                                   rtol=1e-6, atol=0, err_msg=k)
    assert ts.gstate.active_sh_degree == int(jts.gstate.active_sh_degree)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(jgi))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(jgf))
    assert len(cams) == len(jcams) == 2
    for cam, jcam in zip(cams, jcams):
        for k in ("view", "proj", "campos", "tan_fovx", "tan_fovy"):
            np.testing.assert_allclose(getattr(cam, k).numpy(),
                                       np.asarray(getattr(jcam, k)),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        assert (cam.width, cam.height) == (256, 192)


def _shrink(monkeypatch, module, **sizes):
    for k, v in sizes.items():
        monkeypatch.setattr(module, k, v)


def test_bench_prints_bench_py_keys(monkeypatch, capsys):
    """cli.bench and bench.py at the same tiny constants: the same keys,
    scene and instance count; the port's timing names its method and the
    CPU."""
    jbench = _script("bench.py")
    _shrink(monkeypatch, jbench, N_GAUSS=200, W=64, H=48, ITERS=2, F_DIM=128)
    jbench.main(["--f_dim", "4"])
    (theirs,) = _json_lines(capsys.readouterr().out)
    _shrink(monkeypatch, bench_cli, N_GAUSS=200, W=64, H=48, ITERS=2)
    bench_cli.main(["--f_dim", "4", "--device", "cpu"])
    (ours,) = _json_lines(capsys.readouterr().out)
    assert set(ours) == set(theirs) == _dumped_keys("bench.py")[0]
    assert set(ours["detail"]) == set(theirs["detail"])
    assert _dumped_keys("bench.py")[1] == set(theirs["detail"])
    assert ours["metric"] == theirs["metric"]
    for k in ("instances", "image", "n_gauss", "f_dim"):
        assert ours["detail"][k] == theirs["detail"][k], k
    assert ours["detail"]["timing_method"] == "host_clock"
    assert ours["detail"]["device"] == "cpu"
    assert np.isfinite(ours["detail"]["loss"]) and ours["value"] > 0


@pytest.mark.parametrize("batch", [1, 2])
def test_bench_render_prints_the_scripts_keys(batch, capsys):
    """cli.bench_render and scripts/bench_render.py at a tiny scene: the
    script's keys plus ``device``, the same sizes, platform cpu."""
    argv = TINY + ["--f_dims", "4", "--iters", "1", "--batch", str(batch)]
    _script("scripts/bench_render.py").main(argv)
    (theirs,) = _json_lines(capsys.readouterr().out)
    render_cli.main(argv + ["--device", "cpu"])
    (ours,) = _json_lines(capsys.readouterr().out)
    assert set(ours) == set(theirs) | {"device"}
    for k in ("metric", "f_dim", "batch", "image", "n_gauss", "platform"):
        assert ours[k] == theirs[k], k
    assert ours["platform"] == "cpu" and ours["device"] == "cpu"
    assert ours["render_ms"] > 0 and ours["fps"] > 0


ROW = re.compile(r"^ *\d+\.\d{3} +\d+  \S")


def test_profile_step_prints_the_scripts_table(tmp_path, capsys):
    """cli.profile_step and scripts/profile_step.py at a tiny scene: the
    step-span line and the med_ms / count / name table in the script's
    format; --save writes a Chrome trace, --dump_hlo writes nothing."""
    argv = TINY + ["--f_dim", "4", "--n", "2", "--top", "5",
                   "--instance_capacity", "4096"]
    _script("scripts/profile_step.py").main(argv)
    theirs = capsys.readouterr().out.splitlines()
    trace, hlo = tmp_path / "trace.json", tmp_path / "hlo"
    profile_cli.main(argv + ["--device", "cpu", "--save", str(trace),
                             "--dump_hlo", str(hlo)])
    ours = capsys.readouterr().out.splitlines()
    for lines in (theirs, ours):
        span = next(i for i, ln in enumerate(lines)
                    if ln.startswith("step span: "))
        assert re.fullmatch(r"step span: \d+\.\d{2} ms  \(median over 2\)",
                            lines[span])
        assert lines[span + 1] == f"{'med_ms':>9} {'count':>5}  name"
        rows = [ln for ln in lines[span + 2:] if ROW.match(ln)]
        assert 1 <= len(rows) <= 5
    assert "loss=" in ours[1] and "instances=" in ours[1]
    assert "not measured on the CPU" in ours[-1]
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
    assert not hlo.exists()
    assert any(str(hlo) in ln and "no HLO" in ln for ln in ours)


def _script_spans(sync_marks, warmup, densify_interval, densify_from_iter):
    """scripts/bench_longrun.py:129-150 as the script writes it."""
    spans = []
    for (i0, t0), (i1, t1) in zip(sync_marks, sync_marks[1:]):
        if i0 < warmup:
            continue
        ms_it = (t1 - t0) * 1000.0 / (i1 - i0)
        has_densify = any(
            k > densify_from_iter and k % densify_interval == 0
            for k in range(i0, i1))
        spans.append((i1, ms_it, has_densify))
    clean = sorted(ms for _, ms, d in spans if not d)
    dirty = sorted(ms for _, ms, d in spans if d)
    in_window = clean[len(clean) // 2] if clean else float("nan")
    i_base, t_base = next((i, t) for i, t in sync_marks if i >= warmup)
    total_it = spans[-1][0] - i_base
    overall = (sync_marks[-1][1] - t_base) * 1000.0 / total_it
    return spans, (overall, in_window, dirty[len(dirty) // 2] if dirty
                   else None, total_it, len(spans), len(dirty))


@pytest.mark.parametrize("iters,warmup,every,interval", [
    (1200, 500, 10, 100), (80, 50, 10, 20), (95, 41, 7, 15),
    (60, 25, 5, 10)])
def test_longrun_span_rule_is_the_scripts(iters, warmup, every, interval):
    """classify_spans and summarize against a transcription of the
    script's rule, on wall marks drawn at random."""
    rng = np.random.RandomState(iters)
    its = list(range(every, iters + 1, every))
    marks = list(zip(its, np.cumsum(rng.uniform(0.05, 0.5, len(its)))))
    from_iter = warmup - 2 * interval
    spans = longrun_cli.classify_spans(marks, warmup, interval, from_iter)
    want, (overall, in_win, dirty, total, n, n_dirty) = _script_spans(
        marks, warmup, interval, from_iter)
    assert spans == want
    s = longrun_cli.summarize(marks, spans, warmup)
    assert (s["overall"], s["in_window"], s["dirty"], s["total_it"],
            s["spans"], s["densify_spans"]) == (overall, in_win, dirty,
                                                total, n, n_dirty)


def test_longrun_prints_the_scripts_keys(monkeypatch, capsys):
    """cli.bench_longrun at tiny constants: the keys of the script's
    json.dumps plus ``device``; no capacity growth in the measured
    region."""
    _shrink(monkeypatch, longrun_cli, N_GAUSS=300, W=64, H=48, F_DIM=4)
    longrun_cli.main(["--iters", "40", "--warmup", "25",
                      "--densify_interval", "10", "--sync_every", "5",
                      "--device", "cpu"])
    (ours,) = _json_lines(capsys.readouterr().out)
    keys, detail = _dumped_keys("scripts/bench_longrun.py")
    assert set(ours) == keys
    assert set(ours["detail"]) == detail | {"device"}
    d = ours["detail"]
    assert d["measured_iters"] == 15 and d["spans"] == 3
    assert d["densify_spans"] == 1 and d["capacity_regrew"] is False
    assert d["device"] == "cpu" and ours["value"] > 0


SCALING_KEYS = {"devices", "mesh", "images_per_step", "platform", "backend",
                "device"}
SCALING_TIMES = {"step_ms", "step_ms_ratio_vs_1dev", "efficiency_vs_1dev"}


def test_bench_scaling_two_gloo_ranks():
    """torchrun with 2 CPU ranks on gloo: rows d = 1 and 2 with meshes
    [1, 1] and [2, 1] (the script's rule), the script's structure and
    timing keys plus ``device``, and the cost model's absence on stderr."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         "feature3dgs_tpu_torch.cli.bench_scaling", "--small", "--iters",
         "1", "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = _json_lines(proc.stdout)
    assert [(r["devices"], r["mesh"], r["images_per_step"]) for r in rows] \
        == [(1, [1, 1], 1), (2, [2, 1], 2)]
    for r in rows:
        assert set(r) == SCALING_KEYS | SCALING_TIMES
        assert (r["platform"], r["backend"], r["device"]) == ("cpu", "auto",
                                                             "cpu")
        assert r["step_ms"] > 0
    assert rows[0]["step_ms_ratio_vs_1dev"] == 1.0
    assert proc.stderr.count("# cost_analysis unavailable") == 2


def test_bench_scaling_cost_only_prints_the_structure(capsys):
    """One process, --cost_only: the 1-device row's structure fields
    alone (no XLA cost model to report)."""
    scaling_cli.main(TINY + ["--f_dim", "4", "--instance_capacity", "4096",
                             "--cost_only", "--device", "cpu"])
    out = capsys.readouterr()
    (row,) = _json_lines(out.out)
    assert row == {"devices": 1, "mesh": [1, 1], "images_per_step": 1,
                   "platform": "cpu", "backend": "auto", "device": "cpu"}
    assert "# cost_analysis unavailable" in out.err


PROGRAMS = {"bench.py": bench_cli, "scripts/bench_render.py": render_cli,
            "scripts/profile_step.py": profile_cli,
            "scripts/bench_longrun.py": longrun_cli,
            "scripts/bench_scaling.py": scaling_cli,
            "scripts/micro_segsum.py": segsum_cli,
            "scripts/micro_expand.py": expand_cli,
            "scripts/micro_pack.py": pack_cli}


@pytest.mark.parametrize("rel", sorted(PROGRAMS))
def test_every_script_flag_parses_in_the_port(rel):
    """Each option string of the JAX program's parser (caught at its
    parse_args) parses in the port's CLI of the same name, which also
    takes --device. scripts/micro_pack.py has no parser (its sizes are
    module constants): the port's takes --device and --iters (the
    script's n=3)."""
    ours = _parser_of(PROGRAMS[rel].main)
    if rel == "scripts/micro_pack.py":
        assert _script(rel).main.__code__.co_argcount == 0
        args = ours.parse_args(["--device", "cpu", "--iters", "5"])
        assert (args.device, args.iters) == ("cpu", 5)
        assert ours.parse_args([]).iters == 3
        return
    theirs = _parser_of(_script(rel).main)
    options = [(a, o) for a in theirs._actions for o in a.option_strings
               if o not in ("-h", "--help")]
    assert options
    for action, option in options:
        argv = _sample(action, option)
        try:
            ours.parse_args(argv)
        except SystemExit:
            pytest.fail(f"port CLI of {rel} refuses {argv}")
    assert ours.parse_args(["--device", "cpu"]).device == "cpu"
