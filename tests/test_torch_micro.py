"""The stage micro-benchmarks ``cli.micro_segsum``, ``cli.micro_expand``
and ``cli.micro_pack`` against ``scripts/micro_*.py`` on the CPU, at tiny
sizes.

Each script runs here unchanged: it imports JAX inside ``main``, so a
``jax.jit`` patched for the run records each jitted variant's arguments,
closure and first output. Against those: the port's input builders give
the scripts' arrays bit for bit; each port variant matches the script's
variant of the same name (segment sums within 1e-5, where the script holds
its own variants to 1e-3; expansion and gathers exactly); both port
expansion rows agree bit for bit on the slots they keep and match
``v0_current`` there; each CLI's ``main`` returns 0 on ``--device cpu`` and
prints every row."""
import importlib.util
import inspect
import os
import re

import jax
import numpy as np
import pytest
import torch

from feature3dgs_tpu_torch.cli import micro_expand, micro_pack, micro_segsum

from tests.torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEGSUM = dict(l=4096, n=500, c=8)
EXPAND = dict(l=4096, n=300, grid_x=76)
PACK = dict(L=4096, N=500)
PACK_SCENE = ["--n_gauss", "150", "--width", "64", "--height", "48"]

SEGSUM_ROWS = [name for name, _ in micro_segsum.VARIANTS]
EXPAND_ROWS = ["v0_current", "v1_reshape_cols", "v2_transpose",
               "v3_reshape3d", "v4_packed4", "v5_gather2d"]
PACK_ROWS = ["one_640", "split", "feat_only", "misc_only"]


def _argv(sizes: dict) -> list:
    return [x for k, v in sizes.items() for x in (f"--{k}", str(v))]


def _run_script(name: str, argv=None, consts=None) -> dict:
    """scripts/<name>.py's main on the CPU with ``jax.jit`` recording:
    {row name: {"fn", "args", "out"}} of each jitted variant, named by the
    order the script prints its rows in."""
    spec = importlib.util.spec_from_file_location(
        "_jax_" + name, os.path.join(ROOT, "scripts", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    real_jit, calls = jax.jit, []

    def recording_jit(fn, **kw):
        f = real_jit(fn, **kw)
        record = {"fn": fn}
        calls.append(record)

        def call(*args):
            out = f(*args)
            record.setdefault("args", args)
            record.setdefault("out", out)
            return out
        return call

    import feature3dgs_tpu.bench_utils as jbench
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", recording_jit)
        # micro_pack times through the profiler on any platform
        mp.setattr(jbench, "profiled_step_ms", lambda step, n=3: (step(),
                                                                  0.0)[1])
        for k, v in (consts or {}).items():
            mp.setattr(module, k, v)
        assert (module.main(argv) if argv is not None else module.main()) == 0
    rows = {"micro_segsum": SEGSUM_ROWS, "micro_expand": EXPAND_ROWS,
            "micro_pack": PACK_ROWS}[name]
    assert len(calls) == len(rows)
    return dict(zip(rows, calls))


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------- segsum

@pytest.fixture(scope="module")
def segsum():
    jax_rows = _run_script("micro_segsum", _argv(SEGSUM) + ["--iters", "1"])
    d_np, gid_np = micro_segsum.build_inputs(**SEGSUM)
    return jax_rows, d_np, gid_np


def test_segsum_inputs_are_the_scripts(segsum):
    jax_rows, d_np, gid_np = segsum
    for call in jax_rows.values():
        d, s = call["args"]
        np.testing.assert_array_equal(_np(d), d_np)
        np.testing.assert_array_equal(_np(s), gid_np)
    assert (gid_np == SEGSUM["n"]).any() and (gid_np < SEGSUM["n"]).any()


@pytest.mark.parametrize("name", SEGSUM_ROWS + ["segment_plan_sum"])
def test_segsum_variant_matches_the_scripts(segsum, name):
    """Each variant against the script's of that name (``segment_plan_sum``,
    the port's own, against ``plain_at_add``) at 1e-5."""
    jax_rows, d_np, gid_np = segsum
    d, s = torch.from_numpy(d_np), torch.from_numpy(gid_np)
    fn = dict(micro_segsum.variants(s, SEGSUM["n"]))[name]
    want = _np(jax_rows.get(name, jax_rows["plain_at_add"])["out"])
    got = fn(d, s).numpy()
    assert got.shape == (SEGSUM["n"], SEGSUM["c"])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------- expand

@pytest.fixture(scope="module")
def expand():
    jax_rows = _run_script("micro_expand", _argv(EXPAND) + ["--iters", "1"])
    return jax_rows, micro_expand.build_inputs(**EXPAND)


def test_expand_inputs_are_the_scripts(expand):
    """gid, both tables and the fit total equal the script's (its arrays
    reach the jitted variants as arguments and closure cells)."""
    jax_rows, x = expand
    for name, call in jax_rows.items():
        np.testing.assert_array_equal(_np(call["args"][0]), x.gid)
        cells = inspect.getclosurevars(call["fn"]).nonlocals
        key = "table4" if name == "v4_packed4" else "table"
        np.testing.assert_array_equal(_np(cells[key]), getattr(x, key))
        assert cells["fit_total"] == x.fit_total
    assert x.fit_total == EXPAND["l"]         # the script cuts at slot l


@pytest.mark.parametrize("name", EXPAND_ROWS)
def test_expand_variant_matches_the_scripts(expand, name):
    jax_rows, x = expand
    fn = micro_expand.script_variants(x, EXPAND["grid_x"], "cpu")[name]
    tk, dk = fn(torch.from_numpy(x.gid))
    want_tk, want_dk = (_np(a) for a in jax_rows[name]["out"])
    assert tk.dtype == torch.int32 and dk.dtype == torch.float32
    np.testing.assert_array_equal(tk.numpy(), want_tk)
    np.testing.assert_array_equal(dk.numpy(), want_dk)


def test_port_expansions_agree_and_match_v0(expand):
    """``port_expand`` (ops/binning.py) and the sync-free
    ``expand_sized`` give the same (row, tile) on the slots the port
    keeps, the sized one's other slots are empty, and the kept tiles are
    the script's ``v0_current`` tile keys; the port keeps whole Gaussians
    only, so it stops short of the script's cut at slot l."""
    jax_rows, x = expand
    rects = micro_expand.port_rects(x, EXPAND["grid_x"], "cpu")
    row, tile = micro_expand.port_expand(*rects, EXPAND["l"])
    row_s, tile_s = micro_expand.expand_sized(*rects, EXPAND["l"])
    k = row.shape[0]
    areas = x.w * x.h
    assert k == areas[np.cumsum(areas) <= EXPAND["l"]].sum()
    assert 0 < k < EXPAND["l"] and row_s.shape[0] == EXPAND["l"]
    np.testing.assert_array_equal(row_s[:k].numpy(), row.numpy())
    np.testing.assert_array_equal(tile_s[:k].numpy(), tile.numpy())
    assert (row_s[k:] == EXPAND["n"]).all()
    assert (tile_s[k:] == rects[3].num_tiles).all()
    np.testing.assert_array_equal(row.numpy(), x.gid[:k])
    want_tk = _np(jax_rows["v0_current"]["out"][0])
    np.testing.assert_array_equal(tile.numpy(), want_tk[:k])
    outs = {name: tuple(a.numpy() for a in fn(torch.from_numpy(x.gid)))
            for name, fn in micro_expand.script_variants(
                x, EXPAND["grid_x"], "cpu").items()}
    outs["port_expand"] = (row.numpy(), tile.numpy())
    outs["port_expand_sized"] = (row_s.numpy(), tile_s.numpy())
    micro_expand.check_agreement(outs, EXPAND["n"], rects[3].num_tiles)


def test_expand_refuses_a_length_off_1024():
    with pytest.raises(ValueError, match="multiple of 1024"):
        micro_expand.build_inputs(4000, 300, 76)


# ------------------------------------------------------------------ pack

@pytest.fixture(scope="module")
def pack():
    jax_rows = _run_script("micro_pack", consts=PACK)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in PACK.items():
            mp.setattr(micro_pack, k, v)
        seg, t640 = micro_pack.build_inputs()
    return jax_rows, seg, t640


def test_pack_inputs_are_the_scripts(pack):
    jax_rows, seg, t640 = pack
    jt640, jseg = jax_rows["one_640"]["args"]
    np.testing.assert_array_equal(_np(jt640), t640)
    np.testing.assert_array_equal(_np(jseg), seg)
    assert seg.shape == (PACK["L"],) and t640.shape == (PACK["N"] + 1, 640)


@pytest.mark.parametrize("name", PACK_ROWS)
def test_pack_gather_matches_the_scripts(pack, name):
    """Each gather's tables are the script's and its rows equal the
    script's bit for bit."""
    jax_rows, seg, t640 = pack
    fn, tables = micro_pack.gathers(torch.from_numpy(t640))[name]
    call = jax_rows[name]
    for got, want in zip(tables, call["args"][:-1]):
        np.testing.assert_array_equal(got.numpy(), _np(want))
    want = call["out"] if isinstance(call["out"], tuple) else (call["out"],)
    got = fn(torch.from_numpy(seg))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


# ------------------------------------------------------------ the CLIs

ROW = re.compile(r"^(\w+) +(\d+\.\d{4}) ms   \[(.+), cpu\]   "
                 r"bound (\d+\.\d{4}) ms$")


@pytest.mark.parametrize("cli", ["micro_segsum", "micro_expand",
                                 "micro_pack"])
def test_cli_prints_every_row_on_the_cpu(cli, capsys, monkeypatch):
    """``main`` returns 0 with ``--device cpu``: the device line, then one
    row a variant in order, each with its ms, sizes, platform and bound."""
    module = {"micro_segsum": micro_segsum, "micro_expand": micro_expand,
              "micro_pack": micro_pack}[cli]
    if cli == "micro_segsum":
        argv, rows = _argv(SEGSUM), SEGSUM_ROWS + ["segment_plan_sum"]
    elif cli == "micro_expand":
        argv, rows = _argv(EXPAND), EXPAND_ROWS + ["port_expand",
                                                   "port_expand_sized"]
    else:
        for k, v in PACK.items():
            monkeypatch.setattr(micro_pack, k, v)
        argv, rows = PACK_SCENE, PACK_ROWS + ["kernel_reads"]
    assert module.main(argv + ["--iters", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu"
    matches = [ROW.match(ln) for ln in lines[1:]]
    assert all(matches), lines
    assert [m.group(1) for m in matches] == rows
    assert all(float(m.group(2)) > 0 for m in matches)
    if cli == "micro_pack":
        assert re.fullmatch(r"\d+ instances, F=512", matches[-1].group(3))
        assert int(matches[-1].group(3).split()[0]) > 0
