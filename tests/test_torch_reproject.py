"""The port's static-camera reprojection against the JAX package's, on
the CPU, and its jax.random streams against jax.random.

Tolerances:
* ``threefry_uniform``: bit for bit;
* ``threefry_normal``: within 2e-6 relative + 1e-6 absolute (a few
  ulps): its uniform is bit-equal, and XLA evaluates the erf_inv
  polynomial with fused multiply-adds where torch rounds every step;
  ``erf_inv`` itself within 4 ulps of ``jax.lax.erf_inv``;
* ``point_to_uv`` and ``resolve`` on identical inputs: 1e-5;
* ``trace_reproject`` against JAX run op by op (``disable_jit``; XLA's jit
  contracts multiply-adds and glass amplifies that): first-hit material
  identical, every other output at most 1% of pixels off by more than
  1e-4;
* the converged pass 1 against the oracle's committed golden: mean
  tonemapped difference < 0.03 (test_reproject.py's policy).
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.core.types import GLASS
from voxtracer.render import reproject as jax_reproject
from voxtracer.render.camera import make_camera as jax_make_camera
from voxtracer.render.camera import primary_rays as jax_primary_rays
from voxtracer.scene import presets as jax_presets
from voxtracer.scene.instances import VolumeSpec, build_volumes
from voxtracer.scene.procgen import generate_smoke_grid
from voxtracer.scene.volume import solid_grid
from voxtracer_torch import cli
from voxtracer_torch.config import RenderConfig
from voxtracer_torch.core import rng
from voxtracer_torch.core.types import MAT_NONE
from voxtracer_torch.render import reproject
from voxtracer_torch.render.camera import make_camera, primary_rays
from voxtracer_torch.scene import presets
from voxtracer_torch.scene.convert import scene_from_numpy

from test_torch_render import _flatten

torch.set_num_threads(1)


def _jax_scene(name, w, h):
    """glass_sphere_box, or the port's media scene built with the JAX
    package's builders, and its path-mode config."""
    scene, cfg = jax_presets.glass_sphere_box(w, h)
    if name == "glassbox":
        return scene, dataclasses.replace(cfg, mode="path", max_bounces=2)
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
    scene = scene.replace(volumes=build_volumes(specs))
    return scene, dataclasses.replace(cfg, mode="path", max_bounces=2, activate_sky=True,
                                      deterministic_lights=False)


def _port_cfg(jcfg):
    return RenderConfig(**{f: getattr(jcfg, f) for f in (
        "width", "height", "mode", "max_bounces", "activate_sky", "deterministic_lights")})


def _both(name, w, h):
    js, jcfg = _jax_scene(name, w, h)
    return jax.tree.map(jnp.asarray, js), scene_from_numpy(_flatten(js)), jcfg, _port_cfg(jcfg)


def _scanline(w, h):
    py, px = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    return px.reshape(-1), py.reshape(-1)


@pytest.mark.parametrize("seed,path,shape", [
    (0, (6,), (1,)), (0, (8,), (7,)), (3, (2, 6), (1001, 2)), (12345, (4, 3), (257, 3)),
    (2 ** 31 - 1, (9,), (5, 3, 7)), (7, (0, 5), (65536,))])
def test_threefry_uniform_is_bit_equal(seed, path, shape):
    jk, tk = jax.random.PRNGKey(seed), rng.make_key(seed)
    for data in path:
        jk, tk = jax.random.fold_in(jk, data), rng.fold_in(tk, data)
    want = np.asarray(jax.random.uniform(jk, shape, jnp.float32))
    got = rng.threefry_uniform(tk, shape, "cpu").numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("seed,shape", [(0, (4097, 3)), (11, (999, 2)), (5, (3, 333))])
def test_threefry_normal_matches_jax(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 8)
    tk = rng.fold_in(rng.make_key(seed), 8)
    want = np.asarray(jax.random.normal(jk, shape, jnp.float32))
    got = rng.threefry_normal(tk, shape, "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


def test_erf_inv_is_xlas_polynomial():
    g = np.random.default_rng(0)
    x = np.concatenate([g.uniform(-1, 1, 100_000), 1 - g.uniform(0, 1e-5, 1000),
                        g.uniform(-1e-3, 1e-3, 1000), [0.0, -0.99999994]]).astype(np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = rng.erf_inv(torch.from_numpy(x)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=4)
    edge = rng.erf_inv(torch.tensor([1.0, -1.0])).numpy()
    assert np.isposinf(edge[0]) and np.isneginf(edge[1])


def test_point_to_uv_matches_jax():
    w, h = 40, 24
    args = dict(pos=(0.2, 0.4, -1.5), target=(0.1, 0.0, 0.5), aspect=w / h)
    jcam, tcam = jax_make_camera(**args), make_camera(**args)
    # points in front of the camera, a little past the frustum too (far
    # beside the camera the uv ratios cancel catastrophically)
    g = np.random.default_rng(1)
    o, d = primary_rays(tcam, w, h, torch.from_numpy(g.uniform(-8, w + 8, 3000).astype(np.float32)),
                        torch.from_numpy(g.uniform(-8, h + 8, 3000).astype(np.float32)))
    pts = (o + torch.from_numpy(g.uniform(0.3, 4.0, (3000, 1)).astype(np.float32)) * d).numpy()
    want = np.asarray(jax_reproject.point_to_uv(jax.tree.map(jnp.asarray, jcam), w / h,
                                                jnp.asarray(pts)))
    got = reproject.point_to_uv(tcam, w / h, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # points along primary rays land on their own pixel
    px, py = _scanline(w, h)
    o, d = primary_rays(tcam, w, h, torch.from_numpy(px), torch.from_numpy(py))
    uv = reproject.point_to_uv(tcam, w / h, o + 1.7 * d).numpy()
    np.testing.assert_allclose(uv, np.stack([px / w, py / h], -1), atol=2e-3)


@pytest.mark.parametrize("name", ["glassbox", "media"])
def test_trace_reproject_matches_jax(name):
    w = h = 16
    jscene, tscene, jcfg, tcfg = _both(name, w, h)
    px, py = _scanline(w, h)
    jo, jd = jax_primary_rays(jscene.camera, w, h, jnp.asarray(px), jnp.asarray(py), None, jnp)
    with jax.disable_jit():
        want = jax_reproject.trace_reproject(jscene, jcfg, jo, jd, jax.random.PRNGKey(4))
    o, d = primary_rays(tscene.camera, w, h, torch.from_numpy(px), torch.from_numpy(py))
    got = reproject.trace_reproject(tscene, tcfg, o, d, rng.make_key(4))
    names = ("albedo0", "illumination", "point", "normal", "t")
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    assert (got[5].numpy() != MAT_NONE).mean() > 0.5
    assert float(got[1].mean()) > 0.02
    for f, a, b in zip(names, got[:5], want[:5]):
        diff = np.abs(a.numpy() - np.asarray(b)).reshape(w * h, -1).max(-1)
        assert (diff > 1e-4).mean() <= 0.01, f"{f}: {(diff > 1e-4).mean():.2%} (max {diff.max()})"


def test_resolve_matches_jax():
    """Pass 2 on the same G-buffer, a seeded history and a previous camera
    moved by 0.02, so the uvs shift by a fraction of a pixel."""
    w = h = 16
    jscene, tscene, jcfg, tcfg = _both("glassbox", w, h)
    px, py = _scanline(w, h)
    o, d = primary_rays(tscene.camera, w, h, torch.from_numpy(px), torch.from_numpy(py))
    alb, illum, p0, _, _, m0 = reproject.trace_reproject(tscene, tcfg, o, d, rng.make_key(0))
    history = np.random.default_rng(7).random((h, w, 3), np.float32) * 2.0
    cam = dict(pos=np.asarray(jscene.camera.pos) + 0.02, target=(0.5, 0.5, 0.5), aspect=w / h)
    hit = m0 != MAT_NONE
    got = reproject.resolve(tscene, tcfg, make_camera(**cam), alb, illum, p0, m0, hit,
                            torch.from_numpy(history))
    j = [jnp.asarray(x.numpy()) for x in (alb, illum, p0, m0, hit)]
    with jax.disable_jit():
        want = jax_reproject.resolve(jscene, jcfg, jax.tree.map(jnp.asarray, jax_make_camera(**cam)),
                                     *j, jnp.asarray(history))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    # the blend took history on some pixels and not on others
    assert 0 < float((got[1] != illum.reshape(h, w, 3)).any(-1).float().mean()) < 1


def test_reproject_pass1_converged_matches_oracle():
    """The decomposed estimator's converged albedo x illumination against
    the oracle's TraceReproject (test_reproject.py::
    test_reproject_pass1_converged_matches_oracle): 96 samples, as 96 copies
    of the 12x12 primary rays in one pass."""
    scene, cfg = presets.glass_sphere_box(12, 12)
    cfg = dataclasses.replace(cfg, mode="path", max_bounces=3, deterministic_lights=True)
    spp, n = 96, 144
    golden = np.load(pathlib.Path(__file__).parent / "goldens" / "reproject_glassbox_12.npz")
    px, py = _scanline(12, 12)
    o, d = primary_rays(scene.camera, 12, 12, torch.from_numpy(np.tile(px, spp)),
                        torch.from_numpy(np.tile(py, spp)))
    alb, illum = reproject.trace_reproject(scene, cfg, o, d, rng.make_key(50))[:2]
    img = alb.reshape(spp, n, 3).mean(0) * illum.reshape(spp, n, 3).mean(0)
    ref = (golden["alb"] * golden["ill"]).reshape(-1, 3)
    img = img.numpy()
    diff = np.abs(img / (1.0 + img) - ref / (1.0 + ref)).mean()
    assert diff < 0.03, diff


def test_two_frames_blend():
    scene, cfg = presets.glass_sphere_box(24, 24)
    cfg = dataclasses.replace(cfg, mode="reproject", max_bounces=2)
    hist0 = torch.zeros((24, 24, 3))
    img1, hist1, aux = reproject.render_reproject_frame(scene, cfg, scene.camera, hist0,
                                                        rng.make_key(0))
    img2, hist2, _ = reproject.render_reproject_frame(scene, cfg, scene.camera, hist1,
                                                      rng.make_key(1))
    for x in (img1, hist1, img2, hist2):
        assert x.shape == (24, 24, 3) and bool(torch.isfinite(x).all())
    assert not torch.allclose(hist1, hist2)
    assert float(img2.max()) <= 50.0
    assert set(aux) == {"p0", "n0", "t0", "m0"}


def test_tile_order_frame_matches_scanline():
    """Tile ray order only reorders the rays: same G-buffer per pixel."""
    scene, cfg = presets.monu_like_path(128, 16, gridsize=16, bounces=1)
    cfg = dataclasses.replace(cfg, mode="reproject")
    hist = torch.zeros((16, 128, 3))
    _, _, tiled = reproject.render_reproject_frame(scene, cfg, scene.camera, hist,
                                                   rng.make_key(2))
    _, _, scan = reproject.render_reproject_frame(
        scene, dataclasses.replace(cfg, ray_order="scanline"), scene.camera, hist,
        rng.make_key(2))
    for f in ("p0", "n0", "t0", "m0"):
        assert torch.equal(tiled[f], scan[f]), f


def test_cli_render_reproject_writes_png(tmp_path):
    out = tmp_path / "rp.png"
    cli.main(["render", "--preset", "glassbox", "--mode", "reproject", "--width", "16",
              "--bounces", "2", "--frames", "2", "--device", "cpu", "--output", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
