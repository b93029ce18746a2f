"""The program's spans and counters (``feature3dgs_tpu_torch/tracing.py``).

On a tiny synthetic scene (64x48, 200 points, 16x16 tiles, the speed-up
decoder): tracing off, a step records nothing and enters no profiler range;
under ``recording()`` a step records the stages with their parents (the
backward's spans under ``train.backward``) and counts each place it makes
the host wait on the card; under a CPU profiler the spans are host ranges;
``raster.instances`` sums the binning's totals; and a step's outputs and
state are bit-equal with tracing on and off. Off the card no span has a
device time. This file imports no JAX, so that its card test runs on the
card:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""
import threading

import numpy as np
import pytest
import torch

from feature3dgs_tpu_torch import tracing
from feature3dgs_tpu_torch.data.synthetic import synthetic_scene
from feature3dgs_tpu_torch.ops.rasterize import RasterConfig
from feature3dgs_tpu_torch.train.trainer import Trainer

RCFG = RasterConfig(tile_w=16, tile_h=16, chunk=16, instance_capacity=1 << 13)

PARENTS = {
    "train.step": None, "train.maintenance": "train.step",
    "train.inputs": "train.step", "render": "train.step",
    "raster.preprocess": "render", "raster.binning": "render",
    "raster.forward": "render", "loss.rgb": "train.step",
    "loss.resize": "train.step", "decoder": "train.step",
    "train.backward": "train.step", "raster.backward": "train.backward",
    "raster.segment_sum": "train.backward",
    "raster.preprocess_backward": "train.backward", "optim.adam": "train.step",
    "train.sync": "train.step",
}
# host waits of one synced step of this scene, by site
STEP_WAITS = {"host_wait.camera_upload": 5, "host_wait.ndc_to_pixel": 1,
              "host_wait.tile_rect": 2, "host_wait.ndc_offset_scale": 1,
              "host_wait.expand_instances": 2, "host_wait.bincount": 2,
              "host_wait.ssim_taps": 1, "host_wait.host_values": 1}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(device="cpu"):
    scene = synthetic_scene(n_cams=3, w=64, h=48, n_pts=200, f_dim=8)
    return Trainer(scene, rcfg=RCFG, speedup=True, device=device)


def _state(tr) -> dict:
    ts = tr.ts
    out = {k: getattr(ts.params, k) for k in ts.params.FIELDS}
    out.update({f"mu.{k}": getattr(ts.adam.mu, k) for k in ts.params.FIELDS})
    out.update({f"nu.{k}": getattr(ts.adam.nu, k) for k in ts.params.FIELDS})
    out.update({f"dec.{k}": v for k, v in ts.decoder.items()})
    out.update({"grad_accum": ts.gstate.xyz_gradient_accum,
                "denom": ts.gstate.denom, "max_radii": ts.gstate.max_radii2d,
                "step": ts.adam.step})
    return out


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    tr = _trainer()
    tr.step(sync=False)              # ends whatever session another left
    before = tracing.last_session()
    n_before = len(before.spans) if before is not None else 0

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered while off")

    monkeypatch.setattr(tracing, "_record_function", refuse)
    tr.step(sync=True)
    tr.step(sync=False)
    assert tracing.last_session() is before
    assert (len(before.spans) if before is not None else 0) == n_before


def test_one_step_records_its_stages_with_parents():
    tr = _trainer()
    tr.step(sync=False)
    with tracing.recording() as session:
        tr.step(sync=True)
    names = {r[0] for r in session.spans}
    assert names == set(PARENTS)
    for name, parent, *_ in session.spans:
        assert (parent[0] if parent else None) == PARENTS[name], name
    summary = session.summary()
    assert summary["dropped"] == {"spans": 0, "tensors": 0}
    for name, s in summary["spans"].items():
        assert s["count"] == (2 if name == "train.inputs" else 1), name
        assert 0 <= s["host_self_ms"] <= s["host_ms"] + 1e-9, name
        assert s["device_ms"] is None and s["device_self_ms"] is None
    spans = summary["spans"]
    assert spans["train.step"]["host_ms"] >= spans["render"]["host_ms"]
    assert {k: v for k, v in summary["counters"].items()
            if k.startswith("host_wait.")} == STEP_WAITS


def test_profiler_sees_spans_as_host_ranges():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tr = _trainer()
    tr.step(sync=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step(sync=True)
    ranges = {e.name for e in prof.events()
              if e.device_type == DeviceType.CPU}
    assert set(PARENTS) <= ranges
    session = tracing.last_session()
    assert {r[0] for r in session.spans} == set(PARENTS)
    tr.step(sync=False)              # tracing off: the session has ended
    assert tracing._current is None and tracing.last_session() is session


def test_host_wait_sites_outside_the_step():
    from feature3dgs_tpu_torch.ops import binning, cuda_raster
    from feature3dgs_tpu_torch.train import losses
    starts = torch.tensor([0, 2, 2], dtype=torch.int32)
    counts = torch.tensor([2, 0, 3], dtype=torch.int32)
    gid = torch.tensor([0, 1, 1, 2, 0], dtype=torch.int32)
    losses._taps_in.cache_clear()
    with tracing.recording() as session:
        cuda_raster.check_tile_lists(gid, starts, counts, 3)
        cuda_raster.check_tile_partition(starts, counts, 5)
        binning.sort_instances(torch.tensor([1, 0, 3]),
                               torch.tensor([1.0, 2.0, float("inf")]),
                               torch.tensor([4, 5, -1]), 3)
        binning.tile_slices(gid, starts, counts, [(0, 1), (1, 3)])
        grid = binning.TileGrid(width=8, height=8, tile_w=4, tile_h=4)
        losses.resize_bilinear_from_tile_rows(
            torch.zeros(2, 16, 3), grid, 4, 4, 0, 1, 2)
    assert session.summary()["counters"] == {
        "host_wait.check_tile_lists": 1, "host_wait.check_tile_partition": 1,
        "host_wait.bincount": 2, "host_wait.sort_instances": 1,
        "host_wait.tile_slices": 2, "host_wait.resize_taps": 8}


def test_instances_counter_sums_the_binning_totals():
    from feature3dgs_tpu_torch.render.renderer import render_batch
    tr = _trainer()
    tr.step(sync=False)
    with tracing.recording() as session:
        totals = [tr.step(sync=False)["num_instances"] for _ in range(2)]
        cams = [c.to_view("cpu") for c in tr.scene.train_cameras[:2]]
        with torch.no_grad():
            out = render_batch(tr.ts.params, tr.ts.gstate, cams, config=RCFG)
    want = int(sum(int(t) for t in totals) + int(out.total_instances.sum()))
    assert want > 0
    assert session.summary()["counters"]["raster.instances"] == want


def test_step_bit_equal_with_tracing_on_and_off():
    off, on = _trainer(), _trainer()
    m_off = [off.step(sync=s) for s in (False, True, False)]
    with tracing.recording():
        m_on = [on.step(sync=s) for s in (False, True, False)]
    for a, b in zip(m_off, m_on):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    s_off, s_on = _state(off), _state(on)
    for k in s_off:
        assert torch.equal(s_off[k], s_on[k]), k


def test_adam_counts_the_tensors_of_the_plain_path():
    """CPU tensors take the plain Adam: 7 fields and the decoder's 2
    tensors a step, none counted as fused."""
    from feature3dgs_tpu_torch.model import optim
    tr = _trainer()
    with tracing.recording() as session:
        tr.step(sync=False)
        tr.step(sync=True)
        optim.tensor_adam_update(
            tr.ts.decoder, {k: torch.zeros_like(v)
                            for k, v in tr.ts.decoder.items()},
            tr.ts.decoder_adam, lr=1e-4)
    counters = session.summary()["counters"]
    assert counters["optim.adam_plain"] == 2 * 9 + 2
    assert "optim.adam_fused" not in counters


def test_self_time_subtracts_the_union_of_children():
    assert tracing.self_time((0.0, 10.0), []) == 10.0
    assert tracing.self_time((0.0, 10.0), [(2.0, 4.0), (3.0, 5.0),
                                           (9.0, 12.0)]) == 6.0
    assert tracing.self_time((5.0, 6.0), [(0.0, 10.0)]) == 0.0


def test_span_on_another_thread_takes_the_home_span_as_parent():
    with tracing.recording() as session:
        with tracing.span("outer"):
            worker = threading.Thread(target=lambda: tracing.span(
                "inner").__enter__().__exit__(None, None, None))
            worker.start()
            worker.join(timeout=30)
    assert not worker.is_alive()
    parents = {r[0]: r[1][0] if r[1] else None for r in session.spans}
    assert parents == {"outer": None, "inner": "outer"}


def test_session_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    monkeypatch.setattr(tracing, "MAX_KEPT", 1)
    with tracing.recording() as session:
        for _ in range(5):
            with tracing.span("s"):
                pass
        tracing.count_tensor("k", torch.tensor(4))
        tracing.count_tensor("k", torch.tensor([5, 6]))
    summary = session.summary()
    assert summary["spans"]["s"]["count"] == 3
    assert summary["counters"] == {"k": 4}
    assert summary["dropped"] == {"spans": 2, "tensors": 1}


@pytest.mark.cuda
def test_spans_launch_nothing_on_the_card(monkeypatch):
    """Under a profiler, a step with spans launches the same kernels, in
    the same order, as the same step with tracing held off, and the spans
    get device times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tr = _trainer("cuda")
    cam = tr.scene.train_cameras[0]
    for _ in range(3):
        tr.step(camera=cam, sync=True)

    def kernels(spans_on: bool) -> list:
        if not spans_on:
            monkeypatch.setattr(tracing, "_profiling", lambda: False)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tr.step(camera=cam, sync=True)
            torch.cuda.synchronize()
        monkeypatch.undo()
        return [e.name for e in sorted(prof.events(),
                                       key=lambda e: e.time_range.start)
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and e.name not in PARENTS]

    with_spans, without = kernels(True), kernels(False)
    assert with_spans and with_spans == without
    summary = tracing.last_session().summary()
    step = summary["spans"]["train.step"]
    assert step["device_ms"] > 0
    assert 0 <= summary["spans"]["raster.binning"]["device_self_ms"] \
        <= summary["spans"]["raster.binning"]["device_ms"] + 1e-6
    # the ended session, once read, gave its events back for reuse
    pooled = len(tracing._pool)
    assert pooled > 0
    with tracing.recording() as session:
        tr.step(camera=cam, sync=True)
    assert len(tracing._pool) < pooled
    assert session.summary()["spans"]["train.step"]["device_ms"] > 0
