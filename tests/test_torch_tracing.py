"""The program's spans (``voxtracer_torch.utils.profiling.span``) and the
benchmark's reader of them (``vtbench/spans.py``), on the CPU at tiny
sizes: under a CPU ``torch.profiler`` a path frame, a reordered path
frame, a reprojected frame and a fused training step record their
``vt.*`` spans, and each output is bit for bit the one made without a
profiler; without a profiler ``span`` is one shared null context; the
reader pairs launch calls with device operations, charges operations and
idle gaps to the spans that hold them, and refuses iterations whose
counts differ."""

import contextlib
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from voxtracer_torch.core import rng
from voxtracer_torch.diff import train
from voxtracer_torch.diff.volumetric import params_from_scene
from voxtracer_torch.render import integrator, reproject
from voxtracer_torch.scene import presets
from voxtracer_torch.utils import profiling
from vtbench import harness, spans, spec, trace

torch.set_num_threads(1)

MS = 1_000_000  # ns


def _recorded(fn):
    """(fn() without a profiler, fn() under a CPU profiler, the ``vt.*``
    names the profiler recorded)."""
    off = fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = fn()
    return off, on, {e.name for e in prof.events() if e.name.startswith("vt.")}


@pytest.fixture(scope="module")
def monu():
    return presets.monu_like_path(32, 16, gridsize=16, bounces=2)


@pytest.mark.parametrize("reorder, want", [
    ("none", {"vt.bounce", "vt.rng.hash"}),
    ("always", {"vt.bounce", "vt.rng.hash", "vt.reorder", "vt.reorder.undo"}),
])
def test_path_frame_records_its_spans(monu, reorder, want):
    scene, cfg = monu
    cfg = dataclasses.replace(cfg, bounce_reorder=reorder)
    off, on, names = _recorded(lambda: integrator.render_tiled(scene, cfg, rng.make_key(3), 1, 1))
    assert names == want
    assert torch.equal(off, on)


def test_reprojected_frame_records_its_spans():
    scene, cfg = presets.monu_like_path(128, 16, gridsize=16, bounces=1)
    cfg = dataclasses.replace(cfg, mode="reproject")
    hist = torch.rand((16, 128, 3), generator=torch.Generator().manual_seed(0))

    def frame():
        img, new_hist, _ = reproject.render_reproject_frame(scene, cfg, scene.camera, hist,
                                                            rng.make_key(4))
        return img, new_hist

    off, on, names = _recorded(frame)
    assert {"vt.rng.threefry", "vt.reproject.trace", "vt.resolve", "vt.bounce"} <= names
    assert all(torch.equal(a, b) for a, b in zip(off, on))


def test_fused_step_records_its_spans(monu):
    scene, cfg = monu
    target = torch.rand((cfg.height, cfg.width, 3), generator=torch.Generator().manual_seed(1))
    plan = train.prepare_bins(scene, cfg, target)
    key = rng.make_key(5)
    step, init = train.make_train_step(
        cfg, lr=1e-2, grad_fn=lambda p, s, t: train.fused_step(p, s, cfg, key, plan))

    def one_step():
        params = params_from_scene(scene)
        params, _, mean = step(params, init(params), scene, target)
        return (mean, params.density_logits.detach(), params.albedo_table.detach(),
                params.density_logits.grad, params.albedo_table.grad)

    off, on, names = _recorded(one_step)
    assert {"vt.train.fwd", "vt.train.grad", "vt.grad.march", "vt.grad.backward",
            "vt.train.adam", "vt.bounce", "vt.rng.hash"} <= names
    assert all(torch.equal(a, b) for a, b in zip(off, on))


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = profiling.span("vt.a"), profiling.span("vt.b")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass


def test_span_under_a_profiler_is_a_host_event():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("vt.test"):
            torch.ones(4).add_(1)
    ev = [e for e in prof.events() if e.name == "vt.test"]
    assert len(ev) == 1
    assert any(e.name == "aten::add_" and e.time_range.start >= ev[0].time_range.start
               and e.time_range.end <= ev[0].time_range.end for e in prof.events())


# --------------------------------------------------------------- vtbench/spans.py

def _it(host, device, index=0):
    return trace.Iteration(index=index, wall_s=0.1, device=device, host=host)


def test_pairing_across_two_host_threads():
    """The main thread waits in vt.grad.backward while the autograd
    thread launches; the calls and the operations come in any order."""
    host = [("vt.train.grad", 0, 100 * MS),
            ("vt.grad.march", 1 * MS, 30 * MS),
            ("cudaLaunchKernel", 2 * MS, 3 * MS),                # main thread
            ("vt.grad.backward", 30 * MS, 90 * MS),
            ("autograd::engine::evaluate_function: MulBackward0", 40 * MS, 46 * MS),
            ("cudaLaunchKernel", 41 * MS, 42 * MS),              # autograd thread
            ("cudaMemcpyAsync", 95 * MS, 96 * MS),               # main, after the backward
            ("aten::mul", 41 * MS, 43 * MS)]
    device = [("Memcpy DtoH (Device -> Pageable)", 96 * MS, 97 * MS),
              ("k_fwd", 4 * MS, 14 * MS),
              ("k_bwd", 43 * MS, 63 * MS)]
    t = spans.table([_it(host, device)])
    p, s = t["by_prefix"], t["by_span"]
    assert p["vt.grad.march"]["device_ms"] == 10 and p["vt.grad.march"]["launches"] == 1
    assert p["vt.grad.backward"]["device_ms"] == 20 and p["vt.grad.backward"]["launches"] == 1
    assert p["vt.train.grad"]["device_ms"] == 31 and p["vt.train.grad"]["launches"] == 3
    assert p["vt.grad"]["device_ms"] == 30
    assert s["vt.train.grad"]["device_ms"] == 1 and s["vt.grad.backward"]["launches"] == 1


def test_nested_spans_count_each_operation_once_a_prefix():
    host = [("vt.train.fwd", 0, 100 * MS),
            ("vt.bounce", 1 * MS, 60 * MS),
            ("vt.rng.hash", 2 * MS, 10 * MS),
            ("cudaLaunchKernel", 3 * MS, 4 * MS),
            ("vt.rng.threefry", 11 * MS, 20 * MS),
            ("cudaLaunchKernel", 12 * MS, 13 * MS),
            ("vt.reorder", 61 * MS, 90 * MS),
            ("vt.reorder.undo", 62 * MS, 70 * MS),
            ("cudaLaunchKernel", 63 * MS, 64 * MS)]
    device = [("a", 4 * MS, 6 * MS), ("b", 13 * MS, 16 * MS), ("c", 64 * MS, 69 * MS)]
    t = spans.table([_it(host, device)])
    p, s = t["by_prefix"], t["by_span"]
    assert p["vt"] == {"device_ms": 10, "launches": 3, "idle_ms": 55}  # gaps 7 + 48
    assert p["vt.train"]["device_ms"] == 10 and p["vt.train.fwd"]["launches"] == 3
    assert p["vt.rng"]["device_ms"] == 5 and p["vt.rng"]["launches"] == 2
    assert p["vt.rng.hash"]["device_ms"] == 2 and p["vt.rng.threefry"]["device_ms"] == 3
    assert p["vt.bounce"]["device_ms"] == 5
    assert p["vt.reorder"] == {"device_ms": 5, "launches": 1, "idle_ms": 0}
    assert s["vt.reorder.undo"]["device_ms"] == 5 and "vt.reorder" not in s
    assert s["vt.bounce"] == {"device_ms": 0, "launches": 0, "idle_ms": 48}
    assert set(s) == {"vt.rng.hash", "vt.rng.threefry", "vt.reorder.undo", "vt.bounce"}


def test_an_idle_gap_goes_to_the_spans_holding_its_midpoint():
    host = [("cudaLaunchKernel", 0, 1 * MS),
            ("vt.reorder", 2 * MS, 12 * MS),
            ("vt.bounce", 15 * MS, 25 * MS),
            ("cudaLaunchKernel", 24 * MS, 25 * MS)]
    device = [("a", 1 * MS, 10 * MS), ("b", 30 * MS, 40 * MS)]
    # the gap (10, 30) ms: its midpoint 20 lies in vt.bounce, not vt.reorder
    its = [_it(host, device, 0), _it(host, device, 1)]
    t = spans.table(its)
    assert t["iterations"] == 2
    assert t["by_prefix"]["vt.bounce"]["idle_ms"] == 20
    assert t["by_prefix"]["vt.bounce"]["device_ms"] == 10
    assert t["by_prefix"]["vt.reorder"] == {"device_ms": 0, "launches": 0, "idle_ms": 0}
    assert t["by_span"][spans.NO_SPAN]["device_ms"] == 9


def test_an_iteration_whose_counts_differ_is_left_out(capsys):
    """The profiler lost an operation's record: that iteration gives no
    figures (no pairing is guessed); with none left, there are none."""
    host = [("vt.bounce", 0, 10 * MS), ("cudaLaunchKernel", 1 * MS, 2 * MS),
            ("cudaMemsetAsync", 3 * MS, 4 * MS)]
    good = _it(host, [("a", 2 * MS, 3 * MS), ("Memset (Device)", 4 * MS, 5 * MS)], 0)
    bad = _it(host, [("a", 2 * MS, 8 * MS)], 1)
    t = spans.table([good, bad])
    assert t["iterations"] == 1 and t["left_out"] == [1]
    assert t["by_prefix"]["vt.bounce"]["device_ms"] == 2
    assert "iteration 1 has 2 launch calls and 1 device operations" in capsys.readouterr().err
    assert spans.table([bad]) is None
    assert spans.table([]) is None


def test_metric_readers_read_the_spans_or_nothing():
    host = [("vt.rng.hash", 0, 5 * MS), ("cudaLaunchKernel", 1 * MS, 2 * MS),
            ("vt.bounce", 6 * MS, 20 * MS), ("cudaLaunchKernel", 7 * MS, 8 * MS)]
    device = [("a", 2 * MS, 4 * MS), ("b", 12 * MS, 13 * MS)]

    def record(units, host):
        return harness.Record(units=units, work=1, iter_s=[0.1], window_s=0.1, setup_s=1.0,
                              trace=trace.Trace(iterations=[_it(host, device)]))

    frames = record("frames", host)
    assert spec.reader("rng.device_ms.frame")(frames) == 2
    assert spec.reader("bounce.idle_ms.frame")(frames) == 8
    assert spec.reader("rng.device_ms.train")(frames) is None      # a frame, not a step
    assert spec.reader("reorder.device_ms.frame")(frames) is None  # no such span
    assert spec.reader("resolve.device_ms.frame")(
        record("frames", host + [("vt.resolve", 21 * MS, 22 * MS)])) == 0  # holds nothing
    # a program without spans (the launches alone) reads nothing
    bare = record("frames", [h for h in host if not h[0].startswith("vt.")])
    assert spec.reader("rng.device_ms.frame")(bare) is None
    steps = record("steps", [("vt.train.grad", 0, 20 * MS)] + host)
    assert spec.reader("grad.idle_ms.train")(steps) == 8
    assert spec.reader("rng.device_ms.train")(steps) == 2
