"""Nothing the benchmark runs loads JAX or the JAX package (top-level names
compared whole), and the reference loads nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
import textwrap

from conftest import ROOT

BENCH = ROOT / "port_bench"


def imported_roots(path) -> set:
    """Top-level names of every module a file imports."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_reference_and_yardstick_import_nothing_of_the_program():
    for sub in ("reference", "yardstick"):
        for f in (BENCH / sub).glob("*.py"):
            roots = imported_roots(f)
            assert not roots & {"feature3dgs_tpu_torch", "feature3dgs_tpu",
                                "jax", "jaxlib", "flax"}, (f, roots)
            assert roots <= {"__future__", "math", "typing", "numpy",
                             "torch", "port_bench"}, (f, roots)


def test_no_source_of_the_benchmark_imports_jax():
    for f in BENCH.rglob("*.py"):
        roots = imported_roots(f)
        assert not roots & {"feature3dgs_tpu", "jax", "jaxlib", "flax"}, f


def test_a_run_loads_no_jax():
    """A whole tiny run on the CPU, then the run's own check of
    ``sys.modules``."""
    script = textwrap.dedent(f'''
        import sys, time, json
        sys.path.insert(0, {str(ROOT)!r})
        sys.path.insert(0, {str(BENCH / "tests")!r})
        import torch
        torch.set_num_threads(2)
        from port_bench import run
        from port_bench.harness import spec
        from conftest import run_tiny
        for name in ("train_lseg128su_steady", "serve_lseg128su_batch8"):
            r = run_tiny(spec.cell(name, spec.benchmark()), trace=True)
            assert r["correct"], r["checks"]
        print(json.dumps(run.forbidden_modules()))
        ''')
    done = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    from port_bench import run
    fake = type(sys)("fake")
    for name in ("feature3dgs_tpu_torch", "feature3dgs_tpu_torch.ops",
                 "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", fake)
    monkeypatch.setitem(sys.modules, "feature3dgs_tpu.ops", fake)
    assert run.forbidden_modules() == ["feature3dgs_tpu", "jax"]
