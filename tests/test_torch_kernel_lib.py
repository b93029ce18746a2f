"""The kernel-library layer, ``ops/kernel_lib.py``, as far as a CPU reaches
it: ``load`` on a tiny C library built with the host's g++ in place of an
nvcc build (signatures declared, one handle, the constant cross-check),
and the wrappers' signature tables against the ``extern "C"`` blocks of
their CUDA sources, read as text (no nvcc here).
"""
import ctypes
import re
import subprocess

import pytest

from feature3dgs_tpu_torch.ops import (cuda_adam, cuda_preprocess,
                                       cuda_raster, cuda_resize, cuda_segment,
                                       kernel_lib)

TINY = r"""
extern "C" {
const char* f3dgs_error_string(int code) {
  return code ? "tiny failure" : "no error";
}
int f3dgs_tiny_chunk() { return 32; }
double f3dgs_tiny_scale(double x, int k) { return x * k; }
}
"""
TINY_SIGNATURES = {
    "f3dgs_tiny_chunk": ([], ctypes.c_int),
    "f3dgs_tiny_scale": ([ctypes.c_double, ctypes.c_int], ctypes.c_double)}

WRAPPERS = (cuda_raster, cuda_adam, cuda_preprocess, cuda_resize,
            cuda_segment)
TABLES = [(name, *table) for module in WRAPPERS
          for name, table in module.LIBRARIES.items()]


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """``kernel_lib.build`` hands out the tiny library as "tiny", and no
    library is loaded yet."""
    src, lib = tmp_path / "tiny.cc", tmp_path / "tiny.so"
    src.write_text(TINY)
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    monkeypatch.setattr(kernel_lib, "build", lambda: {"tiny": lib})
    monkeypatch.setattr(kernel_lib, "_libs", {})
    return lib


@pytest.mark.parametrize("x,k", [(1.5, 3), (-0.25, 7), (1e300, 1)])
def test_load_declares_signatures_and_keeps_one_handle(tiny, x, k):
    lib = kernel_lib.load("tiny", TINY_SIGNATURES, {"f3dgs_tiny_chunk": 32})
    # a double in and out only works with the declared argtypes / restype
    assert lib.f3dgs_tiny_scale(x, k) == x * k
    assert kernel_lib.load("tiny", TINY_SIGNATURES, {}) is lib
    kernel_lib.raise_on(lib, "tiny_scale", 0)
    with pytest.raises(RuntimeError, match="tiny_scale launch failed: tiny "
                                           "failure"):
        kernel_lib.raise_on(lib, "tiny_scale", 3)


@pytest.mark.parametrize("want", [16, 33, 4096])
def test_load_refuses_a_constant_that_disagrees(tiny, want):
    with pytest.raises(RuntimeError, match=f"library tiny: f3dgs_tiny_chunk"
                                           rf"\(\) returns 32, its wrapper "
                                           f"expects {want}"):
        kernel_lib.load("tiny", TINY_SIGNATURES, {"f3dgs_tiny_chunk": want})
    # nothing is kept of a refused library
    lib = kernel_lib.load("tiny", TINY_SIGNATURES, {"f3dgs_tiny_chunk": 32})
    assert lib.f3dgs_tiny_chunk() == 32


def _extern_c(name: str) -> str:
    text = kernel_lib.SOURCES[name].read_text()
    block = re.search(r'extern "C" \{(.*)\}\s*// extern "C"', text, re.S)
    assert block, f"{name}: no extern \"C\" block"
    return block.group(1)


@pytest.mark.parametrize("name,signatures,constants", TABLES,
                         ids=[t[0] for t in TABLES])
def test_signature_tables_match_the_sources(name, signatures, constants):
    """Every symbol a wrapper declares, and ``f3dgs_error_string``, is
    defined in its source's ``extern "C"`` block with as many parameters
    as the table gives it; every constant is a declared function."""
    block = _extern_c(name)
    want = {**signatures, "f3dgs_error_string": ([ctypes.c_int], None)}
    for symbol, (argtypes, _) in want.items():
        found = re.search(rf"\b{symbol}\(([^)]*)\)\s*\{{", block)
        assert found, f"{name}: {symbol} is not defined extern \"C\""
        params = [p for p in found.group(1).split(",") if p.strip()]
        assert len(params) == len(argtypes), (
            f"{name}: {symbol} takes {len(params)} parameters, its table "
            f"{len(argtypes)}")
    assert set(constants) <= set(signatures)


def test_every_source_has_one_wrapper():
    assert sorted(t[0] for t in TABLES) == sorted(kernel_lib.SOURCES)
