"""The port's utilities against the JAX package's, on the CPU: the
running-average frame report, the npz checkpoints (each package reads
the other's files), the progressive accumulator, PNG input/output and
the profiler trace.  Mirrors tests/test_utils.py case for case (but the
JAX package's Timer and Counters, which the port does not have; its
spans are tests/test_torch_tracing.py's), then adds the cross-package
cases.

Tolerances: the report's stats equal JAX's exactly (host floats); a
checkpoint's leaves come back bit for bit; the accumulator is within
1e-5 of the mean (tests/test_utils.py's)."""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from voxtracer.diff.volumetric import DiffParams as JaxDiffParams
from voxtracer.render.camera import make_camera as jax_make_camera
from voxtracer.utils import checkpoint as jax_checkpoint
from voxtracer.utils.profiling import FrameReport as JaxFrameReport
from voxtracer_torch.diff.volumetric import DiffParams
from voxtracer_torch.io.image import read_png, write_png
from voxtracer_torch.render.accumulate import ProgressiveState
from voxtracer_torch.render.camera import make_camera
from voxtracer_torch.utils.checkpoint import (load_pytree, load_render_state, save_pytree,
                                              save_render_state)
from voxtracer_torch.utils.profiling import FrameReport, device_trace

torch.set_num_threads(1)


def test_frame_report_running_average():
    buf = io.StringIO()
    rep = FrameReport(256, 212, stream=buf)
    s1 = rep.frame(0.010)
    assert s1["ms"] == 10.0  # alpha starts at 1
    s2 = rep.frame(0.020)
    assert 10.0 < s2["ms"] < 20.0  # decayed blend
    assert "Mrays/s" in buf.getvalue()


def test_frame_report_stats_equal_jax():
    """The whole stats sequence and the printed lines, past the alpha floor."""
    secs = [0.05, 0.012, 0.2, 0.031, 0.0333, 0.1, 0.007, 0.02, 0.045, 0.06, 0.011, 0.3]
    mine, theirs = io.StringIO(), io.StringIO()
    a, b = FrameReport(256, 212, stream=mine), JaxFrameReport(256, 212, stream=theirs)
    assert [a.frame(s) for s in secs] == [b.frame(s) for s in secs]
    assert mine.getvalue() == theirs.getvalue() and a.times == b.times


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": torch.ones(4)}}
    p = str(tmp_path / "ck.npz")
    save_pytree(p, tree)
    back = load_pytree(p, tree)
    np.testing.assert_array_equal(back["a"], tree["a"])
    assert isinstance(back["b"]["c"], torch.Tensor)
    np.testing.assert_array_equal(back["b"]["c"].numpy(), np.ones(4))


def _trees(seed):
    """The same dict tree, DiffParams and render state for each package."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, 3)).astype(np.float32)
    c = rng.integers(0, 9, (4,)).astype(np.int32)
    dens = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    alb = rng.random((256, 3)).astype(np.float32)
    acc = rng.random((4, 5, 3)).astype(np.float32)
    jax_tree = {"z": jnp.asarray(a), "b": {"c": jnp.asarray(c), "list": [jnp.asarray(a[0])]}}
    port_tree = {"z": torch.from_numpy(a), "b": {"c": torch.from_numpy(c),
                                                 "list": [torch.from_numpy(a[0])]}}
    cams = (jax_make_camera(pos=(1, 2, -5), target=(0.5, 2, 0), aspect=1.3),
            make_camera(pos=(1, 2, -5), target=(0.5, 2, 0), aspect=1.3))
    return ((jax_tree, JaxDiffParams(density_logits=jnp.asarray(dens),
                                     albedo_table=jnp.asarray(alb)), cams[0], jnp.asarray(acc)),
            (port_tree, DiffParams(density_logits=torch.from_numpy(dens),
                                   albedo_table=torch.from_numpy(alb)), cams[1],
             torch.from_numpy(acc)))


def _leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _port_leaves(tree):
    from voxtracer_torch.utils.checkpoint import _flatten

    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in _flatten(tree)]


def test_port_reads_jax_checkpoints(tmp_path):
    (jt, jp, jcam, jacc), (pt, pp, pcam, pacc) = _trees(0)
    for name, jax_obj, like in (("tree", jt, pt), ("params", jp, pp)):
        p = str(tmp_path / f"{name}.npz")
        jax_checkpoint.save_pytree(p, jax_obj)
        back = load_pytree(p, like)
        for x, y in zip(_port_leaves(back), jax.tree_util.tree_leaves(jax_obj)):
            np.testing.assert_array_equal(x, np.asarray(y))
    p = str(tmp_path / "state.npz")
    jax_checkpoint.save_render_state(p, jcam, jacc, 7)
    cam, acc, frames = load_render_state(p, pcam, pacc)
    assert frames == 7 and isinstance(acc, torch.Tensor)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    for f in ("pos", "top_left", "ahead", "focal_distance"):
        np.testing.assert_array_equal(getattr(cam, f).numpy(), np.asarray(getattr(jcam, f)))


def test_jax_reads_port_checkpoints(tmp_path):
    (jt, jp, jcam, jacc), (pt, pp, pcam, pacc) = _trees(1)
    for name, port_obj, like in (("tree", pt, jt), ("params", pp, jp)):
        p = str(tmp_path / f"{name}.npz")
        save_pytree(p, port_obj)
        _leaves_equal(jax_checkpoint.load_pytree(p, like), like)
    p = str(tmp_path / "state.npz")
    save_render_state(p, pcam, pacc, 11)
    cam, acc, frames = jax_checkpoint.load_render_state(p, jcam, jacc)
    assert frames == 11
    np.testing.assert_array_equal(np.asarray(acc), np.asarray(jacc))
    _leaves_equal(cam, jcam)


def test_progressive_accumulator_matches_mean():
    rng = np.random.default_rng(0)
    frames = [rng.random((4, 4, 3)).astype(np.float32) for _ in range(5)]
    prog = ProgressiveState(4, 4, device="cpu")
    for f in frames:
        acc = prog.add(torch.from_numpy(f))
    np.testing.assert_allclose(acc.numpy(), np.mean(frames, axis=0), rtol=1e-5)
    prog.reset()
    assert prog.frames == 0 and float(prog.acc.sum()) == 0.0


def test_png_roundtrip(tmp_path):
    img = np.random.default_rng(1).integers(0, 255, (12, 17, 3)).astype(np.uint8)
    p = str(tmp_path / "x.png")
    write_png(p, img)
    np.testing.assert_array_equal(read_png(p), img)


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with device_trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64).cumsum(0)
    assert prof.key_averages()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
