"""The port's ``cli render`` frame loop and progressive accumulator against
the JAX CLI's, on the CPU.

``voxtracer/cli.py`` renders frame i as ``render(scene, cfg,
fold_in(key, i), spp)`` (scanline order) and keeps a ``ProgressiveState``
running mean; ``voxtracer_torch.cli.render_progressive`` must draw the same
samples.  The scene is glass_sphere_box in path mode at 16^2, seed 0, 2
frames of 1 spp, carried from the JAX package with ``scene_from_numpy``.
Glass amplifies the multiply-adds XLA's jit contracts, so the JAX loop
runs under ``jax.disable_jit()``.

Tolerances: the path tolerances of tests/test_torch_render.py (mean
absolute difference <= 1e-4, at most 1% of pixels off by more than 1e-3);
``accumulate`` within 1 ulp-scale (rtol 1e-6, atol 1e-7) of JAX's.

``cli render``'s set-up (``render_setup``) against the JAX CLI's, read
from the scene and config its ``cmd_render`` hands to ``render``: at
another aspect than the preset's (glassbox 32x16) the camera corners
within 1e-6 and the config's size and bounces equal; ``--bounces 0``
keeps the preset's bounces, as the JAX CLI's ``if args.bounces``.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.render import accumulate as jax_accumulate
from voxtracer.render import integrator as jax_integrator
from voxtracer.scene import presets as jax_presets
from voxtracer_torch import cli
from voxtracer_torch.core.rng import make_key
from voxtracer_torch.render import accumulate
from voxtracer_torch.scene import presets
from voxtracer_torch.scene.convert import scene_from_numpy

from test_torch_render import _flatten

torch.set_num_threads(1)


def test_cli_render_path_matches_the_jax_cli_loop():
    w = h = 16
    jscene, jcfg = jax_presets.glass_sphere_box(w, h)
    jcfg = dataclasses.replace(jcfg, mode="path")
    _, tcfg = presets.glass_sphere_box(w, h)
    tcfg = dataclasses.replace(tcfg, mode="path")
    assert tcfg.max_bounces == jcfg.max_bounces
    tscene = scene_from_numpy(_flatten(jscene), device="cpu")
    jscene = jax.tree.map(jnp.asarray, jscene)
    key = jax.random.PRNGKey(0)
    prog = jax_accumulate.ProgressiveState(h, w)
    with jax.disable_jit():
        for frame in range(2):
            want = prog.add(jax_integrator.render(jscene, jcfg, jax.random.fold_in(key, frame), 1))
    want = np.asarray(want)
    got = cli.render_progressive(tscene, tcfg, make_key(0), 2, 1).numpy()
    assert got.shape == (h, w, 3) and np.isfinite(got).all()
    diff = np.abs(got - want)
    assert diff.mean() <= 1e-4, diff.mean()
    assert (diff.max(-1) > 1e-3).mean() <= 0.01
    assert 0.02 < got.mean() < 10.0


@pytest.mark.parametrize("frames", [0, 1, 7])
def test_accumulate_matches_jax(frames):
    rng = np.random.default_rng(frames)
    acc, new = (rng.uniform(0.0, 3.0, (8, 6, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_accumulate.accumulate(jnp.asarray(acc), jnp.asarray(new),
                                                jnp.int32(frames)))
    got = accumulate.accumulate(torch.from_numpy(acc), torch.from_numpy(new), frames)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_progressive_state_is_the_running_mean():
    rng = np.random.default_rng(3)
    frames = [rng.uniform(0.0, 2.0, (4, 5, 3)).astype(np.float32) for _ in range(4)]
    prog = accumulate.ProgressiveState(4, 5, device="cpu")
    jprog = jax_accumulate.ProgressiveState(4, 5)
    for f in frames:
        got = prog.add(torch.from_numpy(f))
        want = jprog.add(jnp.asarray(f))
    assert prog.frames == jprog.frames == 4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.numpy(), np.mean(frames, axis=0), rtol=1e-5, atol=1e-6)
    prog.reset()
    assert prog.frames == 0 and not bool(prog.acc.any())


def test_progressive_state_defaults_to_the_card():
    """An entry point's state lives on the card unless the caller asks for
    the CPU, as scene_from_numpy's scenes do."""
    assert inspect.signature(accumulate.ProgressiveState).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            accumulate.ProgressiveState(2, 2)
    assert accumulate.ProgressiveState(2, 2, device="cpu").acc.device.type == "cpu"


def _jax_cli_setup(argv, monkeypatch, tmp_path):
    """The (scene, cfg) the JAX CLI's ``cmd_render`` renders for argv (its
    ``render`` swapped for one that records them and returns black)."""
    from voxtracer import cli as jax_cli

    got = []

    def record(scene, cfg, key, spp):
        got.append((scene, cfg))
        return jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)

    monkeypatch.setattr(jax_integrator, "render", record)
    jax_cli.main(argv + ["--output", str(tmp_path / "jax.png")])
    return got[0]


def _camera_corners(cam):
    return [np.asarray(getattr(cam, f)) for f in ("top_left", "top_right", "bottom_left")]


@pytest.mark.parametrize("argv", [
    ["render", "--preset", "glassbox", "--width", "32", "--height", "16"],
    ["render", "--preset", "glassbox", "--width", "32", "--height", "16", "--bounces", "0"],
    ["render", "--preset", "glassbox", "--width", "24", "--bounces", "3", "--mode", "path"],
])
def test_render_setup_is_the_jax_cli_setup(argv, monkeypatch, tmp_path):
    jscene, jcfg = _jax_cli_setup(argv, monkeypatch, tmp_path)
    scene, cfg = cli.render_setup(cli.parser().parse_args(argv))
    for got, want in zip(_camera_corners(scene.camera), _camera_corners(jscene.camera)):
        np.testing.assert_allclose(got.astype(np.float64), want, rtol=0, atol=1e-6)
    for f in ("width", "height", "max_bounces", "mode", "use_dof"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


def test_bounces_zero_keeps_the_preset_bounces():
    _, preset_cfg = presets.glass_sphere_box()
    _, cfg = cli.render_setup(cli.parser().parse_args(
        ["render", "--preset", "glassbox", "--width", "16", "--bounces", "0"]))
    assert preset_cfg.max_bounces == 5 and cfg.max_bounces == 5
