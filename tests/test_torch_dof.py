"""The port's thin-lens depth of field against the JAX package's, on the
CPU: ``primary_rays`` with lens samples, ``auto_focus_distance``, a
path-traced frame with ``use_dof`` and ``cli render --dof``'s autofocus
and frame against the JAX CLI's (voxtracer/cli.py:50-68).

Both packages render the very same arrays (``scene_from_numpy``) with the
same key.

Tolerances:
* lens rays: within 1e-6 (torch's CPU sin and cos of the disk angle may
  round an ulp apart from XLA's);
* frames: the path tolerances of tests/test_torch_render.py (mean absolute
  difference <= 1e-4, at most 1% of pixels off by more than 1e-3);
* the autofocus distance: equal.
The CLI's frame is the monu-like one of the DOF frame test, at the same
size and settings, so the JAX package's jitted ``render`` is compiled
once for both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_render import _flatten, _jax_scene
from voxtracer.config import RenderConfig as JaxConfig
from voxtracer.render import camera as jax_camera
from voxtracer.render import integrator as jax_integrator
from voxtracer_torch import cli
from voxtracer_torch.config import RenderConfig
from voxtracer_torch.core.rng import make_key
from voxtracer_torch.render import camera, integrator
from voxtracer_torch.scene.convert import scene_from_numpy

torch.set_num_threads(1)


def _focused(js, focal, jitter):
    """A JAX scene with the camera's focal distance and lens radius set,
    and the port's copy of it."""
    cam = dataclasses.replace(js.camera, focal_distance=np.float32(focal),
                              defocus_jitter=np.float32(jitter))
    js = dataclasses.replace(js, camera=cam)
    return jax.tree.map(jnp.asarray, js), scene_from_numpy(_flatten(js), device="cpu")


def test_primary_rays_with_lens_samples_match_jax():
    jscene, tscene = _focused(_jax_scene("monu_like", 64, 32), 2.3, 4.0)
    g = np.random.default_rng(0)
    px = g.uniform(0, 64, 4096).astype(np.float32)
    py = g.uniform(0, 32, 4096).astype(np.float32)
    lens = g.uniform(size=(4096, 2)).astype(np.float32)
    want_o, want_d = jax_camera.primary_rays(jscene.camera, 64, 32, jnp.asarray(px),
                                             jnp.asarray(py), jnp.asarray(lens), jnp)
    got_o, got_d = camera.primary_rays(tscene.camera, 64, 32, torch.from_numpy(px),
                                       torch.from_numpy(py), torch.from_numpy(lens))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6, atol=1e-6)
    # the lens moves the origins off the pinhole, within the disk's radius
    off = np.linalg.norm(got_o.numpy() - tscene.camera.pos.numpy(), axis=-1)
    assert off.max() <= 4.0 / 64 + 1e-6 and off.mean() > 0.01
    for t in (0.7, 3.0, 2e4):
        assert camera.auto_focus_distance(tscene.camera, 64, 32, t) == \
            jax_camera.auto_focus_distance(jscene.camera, 64, 32, t)


def test_dof_path_frame_matches_jax():
    w, h = 64, 32
    jscene, tscene = _focused(_jax_scene("monu_like", w, h), 2.6, 6.0)
    jcfg = JaxConfig(width=w, height=h, mode="path", max_bounces=2, use_dof=True)
    tcfg = RenderConfig(width=w, height=h, mode="path", max_bounces=2, use_dof=True)
    want = np.asarray(jax_integrator.render(jscene, jcfg, jax.random.PRNGKey(0), 1))
    got = integrator.render(tscene, tcfg, make_key(0), 1).numpy()
    assert got.shape == (h, w, 3) and np.isfinite(got).all()
    diff = np.abs(got - want)
    assert diff.mean() <= 1e-4, diff.mean()
    assert (diff.max(-1) > 1e-3).mean() <= 0.01
    # the lens changes the frame
    pinhole = integrator.render(tscene, dataclasses.replace(tcfg, use_dof=False), make_key(0),
                                1).numpy()
    assert np.abs(got - pinhole).max() > 1e-2


def test_cli_render_dof_matches_the_jax_cli(tmp_path):
    """The JAX CLI's --dof block (autofocus on the centre pixel, t clamped
    to [-1, 1e4], focal distance and lens radius set, use_dof), then its
    frame, against the port's ``cli.autofocus`` and frame loop."""
    w, h = 64, 32
    defocus = 3.0
    js = _jax_scene("monu_like", w, h)
    jcfg = JaxConfig(width=w, height=h, mode="path", max_bounces=2, use_dof=True)
    tcfg = RenderConfig(width=w, height=h, mode="path", max_bounces=2, use_dof=True)
    tscene = scene_from_numpy(_flatten(js), device="cpu")
    jscene = jax.tree.map(jnp.asarray, js)
    c = jnp.asarray([w / 2.0], jnp.float32), jnp.asarray([h / 2.0], jnp.float32)
    o, d = jax_camera.primary_rays(jscene.camera, w, h, *c, None, jnp)
    rec = jax_integrator.find_nearest_world(jscene, o, d, jnp.ones(1, bool))
    focal = float(np.clip(np.asarray(rec["t"])[0], -1.0, 1e4))
    jscene = jscene.replace(camera=jscene.camera.replace(
        focal_distance=jnp.float32(focal), defocus_jitter=jnp.float32(defocus)))
    want = np.asarray(jax_integrator.render(jscene, jcfg, jax.random.fold_in(
        jax.random.PRNGKey(0), 0), 1))

    tscene, got_focal = cli.autofocus(tscene, tcfg, defocus)
    assert got_focal == focal and 0.0 < focal < 1e4
    got = cli.render_progressive(tscene, tcfg, make_key(0), 1, 1).numpy()
    diff = np.abs(got - want)
    assert diff.mean() <= 1e-4, diff.mean()
    assert (diff.max(-1) > 1e-3).mean() <= 0.01
    out = tmp_path / "dof.png"
    cli.main(["render", "--preset", "glassbox", "--mode", "path", "--width", "16", "--dof",
              "--defocus", str(defocus), "--device", "cpu", "--output", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
