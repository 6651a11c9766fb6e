"""The port's forward frame against the JAX package's, on the CPU.

Both packages render the very same scene arrays (the JAX SceneData,
flattened to numpy and carried over with ``scene_from_numpy``) with the
same key: the monu-like scene at 128x32 with 16^3 noise volumes, and the
glass + smoke media scene at 64x64.

Tolerances:
* primary mode: 1e-6 — one traversal from the camera and table reads;
* path mode, 2 bounces: mean absolute difference <= 1e-4 and at most 1%
  of pixels off by more than 1e-3.  torch's and XLA's log, cos and rsqrt
  differ by about an ulp, which can flip a grazing hit.

Under jit, XLA's CPU backend contracts multiply-adds into FMAs.  In the
media scene the rotated, 0.2-thick mirror puts shadow-ray origins within
a few ulps of its cube face in object space, where one ulp flips the
inside test, so there the JAX reference runs op by op (``disable_jit``):
every primitive is then its own computation and nothing is contracted,
as in the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.config import RenderConfig as JaxConfig
from voxtracer.core.types import GLASS
from voxtracer.render import integrator as jax_integrator
from voxtracer.render.camera import make_camera as jax_camera
from voxtracer.scene import presets as jax_presets
from voxtracer.scene.instances import VolumeSpec, build_volumes
from voxtracer.scene.lights import make_lights
from voxtracer.scene.materials import default_materials
from voxtracer.scene.procgen import generate_noise_grid, generate_smoke_grid
from voxtracer.scene.volume import solid_grid
from voxtracer_torch import cli
from voxtracer_torch.config import RenderConfig
from voxtracer_torch.core.rng import make_key
from voxtracer_torch.render import integrator
from voxtracer_torch.scene import presets
from voxtracer_torch.scene.convert import scene_from_numpy

torch.set_num_threads(1)

SIZES = {"monu_like": (128, 32, 2), "media": (64, 64, 1)}  # width, height, bands


def _jax_scene(name, w, h):
    """The port's presets built with the JAX package's builders."""
    if name == "monu_like":
        specs = [VolumeSpec(position=(float(i) * 0.75 - 0.75, 0.0, 0.0), gridsize=16,
                            grid=generate_noise_grid(16, seed=s))
                 for i, s in enumerate((1, 2, 3))]
        specs.append(VolumeSpec(position=(0.0, -0.51, 0.0), gridsize=1,
                                scale=(8.0, 0.02, 8.0), grid=solid_grid(1, 7)))
        lights = make_lights(point=((0.0, 3.0, -2.0, 6.0, 6.0, 6.0),))
        cam = jax_camera(pos=(0.1, 1.1, -2.6), target=(0.2, 0.5, 0.5), aspect=w / h)
    else:
        specs = [
            VolumeSpec(position=(0, 0, 0), gridsize=8, grid=solid_grid(8, GLASS),
                       scale=(0.5, 0.5, 0.5), rotation=(0.13, 0.41, 0.07)),
            VolumeSpec(position=(0.0, -0.6, 0.0), gridsize=1, scale=(4.0, 0.3, 4.0),
                       grid=solid_grid(1, 1), rotation=(0.02, 0.11, 0.015)),
            VolumeSpec(position=(0.0, 0.0, 0.8), gridsize=1, scale=(3.0, 3.0, 0.2),
                       grid=solid_grid(1, 7), rotation=(0.06, -0.09, 0.03)),
            VolumeSpec(position=(0.3, -0.05, 0.0), gridsize=32,
                       grid=generate_smoke_grid(32, seed=5),
                       scale=(0.45, 0.45, 0.45), rotation=(0.0, 0.2, 0.0)),
        ]
        lights = make_lights(point=((0.83, 1.57, -1.21, 2.0, 2.0, 2.0),))
        cam = jax_camera(pos=(0.517, 0.703, -1.59), target=(0.49, 0.41, 0.5),
                         aspect=w / h)
    return jax_presets._assemble(build_volumes(specs), default_materials(),
                                 lights=lights, camera=cam)


def _flatten(scene):
    """A JAX SceneData as a nested dict of numpy arrays."""
    out = {}
    for part in ("volumes", "materials", "lights", "spheres", "triangles", "sky", "camera"):
        rec = getattr(scene, part)
        out[part] = {f.name: np.asarray(getattr(rec, f.name))
                     for f in dataclasses.fields(rec)
                     if isinstance(getattr(rec, f.name), (np.ndarray, np.generic))}
    if scene.volumes.pages is not None:  # a paged scene: each page's offset and arrays
        out["volumes"]["pages"] = [
            dict(vol_off=p.vol_off, **{f: np.asarray(getattr(p, f)) for f in ("gridsize", "inv")})
            for p in scene.volumes.pages]
    return out


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, (w, h, _) in SIZES.items():
        js = _jax_scene(name, w, h)
        out[name] = (jax.tree.map(jnp.asarray, js), scene_from_numpy(_flatten(js), device="cpu"))
    return out


def _render_both(scenes, name, mode, bounces, eager=False):
    w, h, bands = SIZES[name]
    jscene, tscene = scenes[name]
    jcfg = JaxConfig(width=w, height=h, mode=mode, max_bounces=bounces)
    tcfg = RenderConfig(width=w, height=h, mode=mode, max_bounces=bounces)
    if eager:
        with jax.disable_jit():
            want = np.asarray(jax_integrator._render_banded(
                jscene, jcfg, jax.random.PRNGKey(0), 1, bands))
    else:
        want = jax_integrator.render_tiled(jscene, jcfg, jax.random.PRNGKey(0), 1, bands)
    got = integrator.render_tiled(tscene, tcfg, make_key(0), 1, bands).numpy()
    assert got.shape == (h, w, 3) and np.isfinite(got).all()
    return want, got


def test_scene_from_numpy_matches_port_builders(scenes):
    """The carried-over JAX scene equals the port's own preset."""
    mine, _ = presets.monu_like_path(128, 32, gridsize=16)
    _, carried = scenes["monu_like"]
    for part in ("volumes", "materials", "lights", "sky", "camera"):
        a, b = getattr(mine, part), getattr(carried, part)
        for f in dataclasses.fields(a):
            if isinstance(getattr(a, f.name), torch.Tensor):
                np.testing.assert_array_equal(getattr(a, f.name).numpy(),
                                              getattr(b, f.name).numpy(), err_msg=f.name)
            else:  # an unpaged scene: pages None, vol_off 0
                assert getattr(a, f.name) == getattr(b, f.name), f.name


@pytest.mark.parametrize("name", ["monu_like", "media"])
def test_primary_matches_jax(scenes, name):
    want, got = _render_both(scenes, name, "primary", 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["monu_like", "media"])
def test_path_matches_jax(scenes, name):
    want, got = _render_both(scenes, name, "path", 2, eager=name == "media")
    diff = np.abs(got - want)
    assert diff.mean() <= 1e-4, diff.mean()
    assert (diff.max(-1) > 1e-3).mean() <= 0.01
    assert 0.02 < got.mean() < 10.0


def test_cli_render_writes_png(tmp_path):
    out = tmp_path / "media.png"
    cli.main(["render", "--preset", "media", "--width", "32", "--bounces", "1",
              "--device", "cpu", "--output", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_render_sample_matches_jax(scenes):
    """Scanline-order primary samples of the whole monu-like frame."""
    w, h, _ = SIZES["monu_like"]
    jscene, tscene = scenes["monu_like"]
    jcfg = JaxConfig(width=w, height=h, mode="primary", max_bounces=1)
    want = jax.jit(lambda s, k: jax_integrator.render_sample(s, jcfg, k))(
        jscene, jax.random.PRNGKey(3))
    got = integrator.render_sample(
        tscene, RenderConfig(width=w, height=h, mode="primary", max_bounces=1), make_key(3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
