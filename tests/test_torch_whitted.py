"""The port's Whitted renderer and deterministic NEE against the JAX
package's, on the CPU.

Both packages render the very same scene arrays (the JAX SceneData
flattened to numpy and carried over with ``scene_from_numpy``).  XLA's
CPU jit contracts multiply-adds into FMAs, and whitted's glass branches
amplify that: on glassbox at 24^2, depth 3, the jitted JAX branch queue
differs from the same code run op by op by up to 0.1.  So the JAX
reference runs under ``jax.disable_jit()``, at 16^2.

Tolerances:
* ``_det_illumination`` on identical hits: 1e-5;
* the branch queue against JAX: at most 1% of pixels off by more than
  1e-4, median difference <= 1e-6, the same iteration count (adds into a
  pixel commute only to rounding);
* the port's queue against its recursive oracle: the same rule;
* ``render`` against the committed oracle golden: the JAX golden test's
  policy, at most 4% of pixels off by more than 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.config import RenderConfig as JaxConfig
from voxtracer.render import integrator as jax_integrator
from voxtracer.render.camera import primary_rays as jax_primary_rays
from voxtracer.scene import presets as jax_presets
from voxtracer.scene.lights import make_lights
from voxtracer_torch import cli
from voxtracer_torch.config import RenderConfig
from voxtracer_torch.core.rng import make_key
from voxtracer_torch.render import integrator
from voxtracer_torch.render.camera import primary_rays
from voxtracer_torch.scene import presets
from voxtracer_torch.scene.convert import scene_from_numpy

from test_torch_render import _flatten

torch.set_num_threads(1)


def _both(jscene):
    return jax.tree.map(jnp.asarray, jscene), scene_from_numpy(_flatten(jscene), device="cpu")


def _rays(cfg, cam):
    """Scanline primary rays through the pixel corners -> (JAX, port)."""
    py, px = np.meshgrid(np.arange(cfg.height, dtype=np.float32),
                         np.arange(cfg.width, dtype=np.float32), indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    jo, jd = jax_primary_rays(cam[0], cfg.width, cfg.height, jnp.asarray(px),
                              jnp.asarray(py), None, jnp)
    to, td = primary_rays(cam[1], cfg.width, cfg.height, torch.from_numpy(px),
                          torch.from_numpy(py))
    return (jo, jd), (to.contiguous(), td)


def _hold(got, want, bad=0.01, tol=1e-4, median=1e-6):
    diff = np.abs(np.asarray(got) - np.asarray(want)).reshape(-1, 3).max(-1)
    assert (diff > tol).mean() <= bad, f"{(diff > tol).mean():.2%} off (max {diff.max()})"
    assert np.median(diff) <= median


def test_config_has_the_jax_fields():
    """The whitted and NEE fields of the JAX RenderConfig, with its defaults."""
    for f in ("deterministic_lights", "whitted_cull_eps"):
        assert getattr(RenderConfig(), f) == getattr(JaxConfig(), f), f


def test_glassbox_preset_is_the_jax_config():
    _, want = jax_presets.glass_sphere_box(48, 32)
    _, got = presets.glass_sphere_box(48, 32)
    for f in ("width", "height", "mode", "max_bounces", "activate_sky",
              "deterministic_lights", "whitted_cull_eps"):
        assert getattr(got, f) == getattr(want, f), f


def _lit_scene(w, h):
    """glass_sphere_box under a point, an area, a spot and a directional
    light."""
    jscene, _ = jax_presets.glass_sphere_box(w, h)
    lights = make_lights(point=((0.83, 1.57, -1.21, 2.0, 2.0, 2.0),),
                         area=((-0.6, 1.2, -0.4, 1.0, 0.9, 0.7, 0.8, 0.15),),
                         spot=((0.9, 1.0, -0.9, -0.5, -0.6, 0.6, 1.5, 1.4, 1.3, 0.8),),
                         directional=((0.3, -1.0, 0.2), (0.2, 0.25, 0.3)))
    return jscene.replace(lights=lights)


def test_det_illumination_matches_jax():
    w = h = 16
    jscene, tscene = _both(_lit_scene(w, h))
    cfg = RenderConfig(width=w, height=h, mode="whitted", deterministic_lights=True)
    jcfg = JaxConfig(width=w, height=h, mode="whitted", deterministic_lights=True)
    _, (o, d) = _rays(cfg, (jscene.camera, tscene.camera))
    rec = integrator.find_nearest_world(tscene, o, d, torch.ones(w * h, dtype=torch.bool))
    hit = rec["hit"]
    assert 0 < int(hit.sum()) < w * h
    p = o + rec["t"][:, None] * d
    nrm = torch.stack([rec["nx"], rec["ny"], rec["nz"]], -1)
    alb = tscene.materials.albedo[rec["mat"].long()]
    got = integrator.illumination(tscene, cfg, integrator.cpack(p), integrator.cpack(nrm),
                                  hit, make_key(0), integrator.cpack(alb))
    jt = [tuple(jnp.asarray(a.numpy()[:, c]) for c in range(3)) for a in (p, nrm, alb)]
    with jax.disable_jit():
        want = jax_integrator._det_illumination(jscene, jcfg, *jt, jnp.asarray(hit.numpy()),
                                                jax.random.PRNGKey(0))
    got, want = integrator.cstack(got).numpy(), np.stack([np.asarray(c) for c in want], -1)
    assert float(np.abs(want).max()) > 0.05
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cull", [0.0, 1e-3])
def test_whitted_queue_matches_jax(cull):
    w = h = 16
    jscene, tscene = _both(jax_presets.glass_sphere_box(w, h)[0])
    cfg = RenderConfig(width=w, height=h, mode="whitted", max_bounces=3, activate_sky=False,
                       deterministic_lights=True, whitted_cull_eps=cull)
    jcfg = JaxConfig(width=w, height=h, mode="whitted", max_bounces=3, activate_sky=False,
                     deterministic_lights=True, whitted_cull_eps=cull)
    (jo, jd), (o, d) = _rays(cfg, (jscene.camera, tscene.camera))
    with jax.disable_jit():
        want, jit_iters = jax_integrator.trace_whitted_iter(jscene, jcfg, jo, jd, 3,
                                                            return_iters=True)
    got, iters = integrator.trace_whitted_iter(tscene, cfg, o, d, 3, return_iters=True)
    assert iters == int(jit_iters)
    _, q_iters, peak = integrator.whitted_queue(tscene, cfg, o, d, 3)
    assert q_iters == iters
    assert w * h <= peak <= 4 * w * h
    assert float(got.mean()) > 0.02
    _hold(got.numpy(), want)


def test_whitted_iterative_matches_recursive():
    """The branch queue reproduces the recursive 3^depth-tree estimator
    (test_golden.py::test_whitted_iterative_matches_recursive)."""
    scene, cfg = presets.glass_sphere_box(24, 24)
    cfg = dataclasses.replace(cfg, max_bounces=3, whitted_cull_eps=0.0)
    py, px = torch.meshgrid(torch.arange(24.0), torch.arange(24.0), indexing="ij")
    o, d = primary_rays(scene.camera, 24, 24, px.reshape(-1), py.reshape(-1))
    rec = integrator.trace_whitted(scene, cfg, o, d, 3)
    it = integrator.trace_whitted_iter(scene, cfg, o, d, 3)
    assert float(rec.mean()) > 0.02
    _hold(it.numpy(), rec.numpy())


def test_render_glassbox_matches_oracle_golden():
    """``render`` of glass_sphere_box at 32^2, depth 3, against the NumPy
    oracle's committed image (test_golden.py::test_whitted_glassbox_matches_oracle)."""
    scene, cfg = presets.glass_sphere_box(32, 32)
    cfg = dataclasses.replace(cfg, max_bounces=3)
    img = integrator.render(scene, cfg, make_key(0), 1).numpy()
    ref = np.load(__import__("pathlib").Path(__file__).parent / "goldens" / "glassbox_32.npz")["ref"]
    assert img.shape == ref.shape and np.isfinite(img).all()
    diff = np.abs(img - ref).max(-1)
    assert (diff > 1e-3).mean() <= 0.04, f"{(diff > 1e-3).mean():.2%} (max {diff.max()})"


def test_path_with_deterministic_lights_matches_jax():
    """cfg.deterministic_lights reaches path mode's NEE too."""
    w = h = 16
    jscene, tscene = _both(_lit_scene(w, h))
    jcfg = JaxConfig(width=w, height=h, mode="path", max_bounces=2, deterministic_lights=True)
    tcfg = RenderConfig(width=w, height=h, mode="path", max_bounces=2, deterministic_lights=True)
    with jax.disable_jit():
        want = np.asarray(jax_integrator._render_banded(jscene, jcfg, jax.random.PRNGKey(0), 1, 1))
    got = integrator.render_tiled(tscene, tcfg, make_key(0), 1, 1).numpy()
    diff = np.abs(got - want)
    assert diff.mean() <= 1e-4, diff.mean()
    assert (diff.max(-1) > 1e-3).mean() <= 0.01


def test_cli_render_glassbox_writes_png(tmp_path):
    out = tmp_path / "glassbox.png"
    cli.main(["render", "--preset", "glassbox", "--width", "16", "--bounces", "2",
              "--device", "cpu", "--output", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
