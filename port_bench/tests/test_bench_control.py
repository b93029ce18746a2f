"""On the card: the control, the reference computed in TF32 in the
program's place, fails each cell's limits while the program passes them.
A quarter of the cell's Gaussians at a quarter of its pixels, three seeds.

    python -m pytest port_bench/tests/test_bench_control.py -q -m cuda
"""
from __future__ import annotations

import time

import pytest

from conftest import SEED

from port_bench import run
from port_bench.harness import spec

BENCH = spec.benchmark()
SMALL = dict(n_gaussians=250_000, width=608, height=400, n_views=8)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_where_the_program_passes(card, name):
    cell = spec.cell(name, BENCH)
    cell = cell._replace(config=dict(cell.config, **SMALL))
    for k in range(3):
        r = run.run_cell(cell, SEED + k, 1.0, False, card,
                         time.perf_counter(), control=True)
        assert r["correct"], r["checks"]
        control = r["control"]["tf32"]
        assert any(control[n] > cell.limits[n] for n in cell.limits), control
