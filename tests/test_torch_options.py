"""The JAX package's render options in the port, against the JAX package,
on the CPU: the RenderConfig fields, ``num_area_samples``, the threefry
sampler (``rng``), the wavefront compaction (``compact_chunks``), the
live-prefix chunks of the reordered loop (``reorder_compact_chunks``) and
the whitted batch sort (``whitted_sort_batch``).

Both packages render the very same scene arrays (``scene_from_numpy``),
and the JAX references run op by op (``disable_jit``: under jit XLA's CPU
backend contracts multiply-adds, tests/test_torch_render.py).  Every
option but the batch sort of the exact queue changes which samples a lane
draws, so each frame is also held apart from the frame without it: the
option must have run.

Tolerances, from the neighbouring file of each renderer:
* ``_det_illumination`` on identical hits: 1e-5 (tests/test_torch_whitted.py);
* path frames: mean absolute difference <= 1e-4 and at most 1% of pixels
  off by more than 1e-3 (tests/test_torch_render.py).  The threefry
  frames take the same rule: their uniforms are bit-equal and 13-16% of
  their normals 1-3 ulps off ``jax.random.normal`` (XLA's erf_inv
  polynomial); measured here, the frames' mean absolute difference is
  below 1e-7;
* whitted queues: at most 1% of pixels off by more than 1e-4, median
  difference <= 1e-6, the same iteration count
  (tests/test_torch_whitted.py); the exact queue with and without the
  batch sort: bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_render import _flatten, _jax_scene
from test_torch_whitted import _both, _hold, _lit_scene, _rays
from voxtracer.config import RenderConfig as JaxConfig
from voxtracer.render import integrator as jax_integrator
from voxtracer.render.camera import make_camera as jax_camera
from voxtracer.render.camera import primary_rays as jax_primary_rays
from voxtracer.scene import presets as jax_presets
from voxtracer.scene.instances import VolumeSpec, build_volumes
from voxtracer.scene.lights import make_lights
from voxtracer.scene.materials import default_materials
from voxtracer_torch.config import RenderConfig
from voxtracer_torch.core.rng import make_key
from voxtracer_torch.core.types import MAT_NONE
from voxtracer_torch.render import integrator
from voxtracer_torch.scene import presets
from voxtracer_torch.scene.convert import scene_from_numpy

torch.set_num_threads(1)


def _hold_path(got, want):
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert diff.mean() <= 1e-4, diff.mean()
    assert (diff.max(-1) > 1e-3).mean() <= 0.01, (diff.max(-1) > 1e-3).mean()
    return diff


def _moved(a, b, share=0.05):
    """At least `share` of the pixels of two frames differ by more than 1e-3."""
    off = (np.abs(np.asarray(a) - np.asarray(b)).reshape(-1, 3).max(-1) > 1e-3).mean()
    assert off >= share, off


def _port_frame(tscene, w, h, **kw):
    """One 1-spp band of w x h through the port -> [h, w, 3]."""
    got = integrator.render_tiled(tscene, RenderConfig(width=w, height=h, **kw), make_key(0),
                                  1, 1).numpy()
    assert got.shape == (h, w, 3) and np.isfinite(got).all() and 0.02 < got.mean() < 10.0
    return got


def _frames(jscene, tscene, w, h, **kw):
    """One 1-spp band of w x h through each package -> (JAX, port) [h, w, 3]."""
    with jax.disable_jit():
        want = np.asarray(jax_integrator._render_banded(
            jscene, JaxConfig(width=w, height=h, **kw), jax.random.PRNGKey(0), 1, 1))
    return want, _port_frame(tscene, w, h, **kw)


# ------------------------------------------------------------------ config

def test_render_config_fields_equal_the_jax_ones():
    """The same field names with the same defaults: a JAX configuration
    carries across, and a field added to either side fails here."""
    want = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    got = {f.name: f.default for f in dataclasses.fields(RenderConfig)}
    assert got == want


@pytest.mark.parametrize("name", ["monu_path", "city_path", "city_xl_path"])
def test_presets_take_spp(name, monkeypatch, tmp_path):
    """The asset path presets take spp into their config, as the JAX
    package's; the asset-free stand-ins of monu and city_xl too."""
    import inspect

    assert inspect.signature(getattr(jax_presets, name)).parameters["spp"].default == 1
    assert inspect.signature(getattr(presets, name)).parameters["spp"].default == 1
    for like in ("monu_like_path", "city_xl_like_path"):
        assert inspect.signature(getattr(presets, like)).parameters["spp"].default == 1
    _, cfg = presets.monu_like_path(16, 8, gridsize=8, spp=3)
    assert cfg.spp == 3


# ------------------------------------------------------------------ num_area_samples

@pytest.mark.parametrize("samples", [1, 5])
def test_num_area_samples_matches_jax(samples):
    """The all-lights NEE sum on glassbox under a point, an area, a spot
    and a directional light, with 1 and 5 samples of the area light."""
    w = h = 16
    jscene, tscene = _both(_lit_scene(w, h))
    kw = dict(width=w, height=h, mode="whitted", deterministic_lights=True,
              num_area_samples=samples)
    cfg, jcfg = RenderConfig(**kw), JaxConfig(**kw)
    _, (o, d) = _rays(cfg, (jscene.camera, tscene.camera))
    rec = integrator.find_nearest_world(tscene, o, d, torch.ones(w * h, dtype=torch.bool))
    hit = rec["hit"]
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
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the sample count reaches the sum
    three = integrator.illumination(tscene, dataclasses.replace(cfg, num_area_samples=3),
                                    integrator.cpack(p), integrator.cpack(nrm), hit,
                                    make_key(0), integrator.cpack(alb))
    assert np.abs(integrator.cstack(three).numpy() - got).max() > 1e-3


# ------------------------------------------------------------------ rng

@pytest.fixture(scope="module")
def path_scenes():
    """glassbox (glass and mirror) and media (glass and smoke, so the exit
    march runs inside a chunk), each as (JAX, port) scenes."""
    js = _jax_scene("media", 16, 16)
    glass = _both(jax_presets.glass_sphere_box(16, 16)[0])
    return {"glassbox": glass,
            "media": (jax.tree.map(jnp.asarray, js), scene_from_numpy(_flatten(js), device="cpu"))}


@pytest.mark.parametrize("lights", ["random", "summed"])
def test_threefry_path_frame_matches_jax(lights):
    """rng = "threefry": glassbox 16x16 in path mode, 1 bounce, under the
    four lights of every kind: with random light choice (the light pick,
    salt 7, and the one area sample, salt 11) and with every light summed
    (the area samples, salts 200-202); each bounce's lobe, sphere,
    hemisphere and Fresnel streams and the pixel jitter."""
    jscene, tscene = _both(_lit_scene(16, 16))
    kw = dict(mode="path", max_bounces=1, deterministic_lights=lights == "summed",
              rng="threefry")
    want, got = _frames(jscene, tscene, 16, 16, **kw)
    diff = _hold_path(got, want)
    assert diff.mean() < 1e-6
    _moved(got, _port_frame(tscene, 16, 16, **dict(kw, rng="hash")), 0.2)


def test_threefry_media_frame_matches_jax(path_scenes):
    """rng = "threefry" through glass and smoke (the scatter streams, salts
    6 and 8): the media scene at 16x16, 2 bounces."""
    jscene, tscene = path_scenes["media"]
    want, got = _frames(jscene, tscene, 16, 16, mode="path", max_bounces=2, rng="threefry")
    _hold_path(got, want)


# ------------------------------------------------------------------ compaction

@pytest.mark.parametrize("name", ["glassbox", "media"])
def test_compacted_path_frame_matches_jax(path_scenes, name, monkeypatch):
    """compact_chunks = 4 with compact_min = 256 (the 16x16 frame's ray
    count), 1 bounce: the live rays partitioned to a prefix each bounce,
    chunks of 64 traced under fold_in(bounce key, chunk) up to the last
    live one."""
    jscene, tscene = path_scenes[name]
    kw = dict(mode="path", max_bounces=1, compact_chunks=4, compact_min=256)
    taken = []
    kept = integrator._trace_chunks

    def spy(*args):
        taken.append(args[4])  # the lane after the last live one
        return kept(*args)

    monkeypatch.setattr(integrator, "_trace_chunks", spy)
    want, got = _frames(jscene, tscene, 16, 16, **kw)
    _hold_path(got, want)
    assert taken[0] == 256 and len(taken) == 2 and taken[-1] < 256  # rays died
    _moved(got, _port_frame(tscene, 16, 16, mode="path", max_bounces=1), 0.1)


def test_compaction_needs_enough_rays_and_a_divisor(path_scenes):
    """As in the JAX package: below compact_min, or with a chunk count that
    does not divide the rays, the plain loop runs."""
    tscene = path_scenes["glassbox"][1]
    base = RenderConfig(width=16, height=16, mode="path", max_bounces=2)
    plain = integrator.render_tiled(tscene, base, make_key(0), 1, 1)
    for kw in (dict(compact_chunks=4, compact_min=257), dict(compact_chunks=3, compact_min=1)):
        assert integrator.path_loop(tscene, dataclasses.replace(base, **kw), 256) == "plain"
        assert torch.equal(integrator.render_tiled(tscene, dataclasses.replace(base, **kw),
                                                   make_key(0), 1, 1), plain)
    assert integrator.path_loop(tscene, dataclasses.replace(
        base, compact_chunks=4, compact_min=1, bounce_reorder="always"), 256) == "compact"


# ------------------------------------------------------------------ reorder chunks

@pytest.fixture(scope="module")
def reorder_scene():
    """tests/test_reorder.py's scene: 8 random 16^3 volumes, unpaged; here
    inside a hollow white shell (as in tests/test_torch_reorder.py), so
    that every ray hits and bounces."""
    rng = np.random.default_rng(5)
    specs = []
    for _ in range(8):
        g = np.full((16,) * 3, MAT_NONE, np.uint8)
        for _ in range(3):
            lo = rng.integers(0, 12, 3)
            hi = lo + rng.integers(2, 8, 3)
            g[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = int(rng.choice([1, 2, 7, 8, 10]))
        specs.append(VolumeSpec(position=tuple(rng.uniform(-2.0, 2.0, 3)), gridsize=16, grid=g,
                                rotation=tuple(rng.uniform(-0.4, 0.4, 3)),
                                scale=tuple(rng.uniform(0.5, 1.2, 3))))
    shell = np.full((16,) * 3, 0, np.uint8)
    shell[1:-1, 1:-1, 1:-1] = MAT_NONE
    specs.append(VolumeSpec(position=(-0.5, -0.5, -0.5), gridsize=16, grid=shell,
                            scale=(11.0, 11.0, 11.0)))
    cam = jax_camera(pos=(0.0, 0.5, -4.0), target=(0.0, 0.0, 0.0))
    lights = make_lights(point=((0.5, 3.0, -3.0, 9.0, 9.0, 8.0),))
    return _both(jax_presets._assemble(build_volumes(specs), default_materials(), lights=lights,
                                       camera=cam))


def _reorder_frames(scenes, w, h, with_jax=True, **kw):
    """trace_path on tests/test_reorder.py's camera rays (pixel centres) ->
    (JAX or None, port) [w * h, 3]."""
    jscene, tscene = scenes
    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32) + 0.5,
                          jnp.arange(w, dtype=jnp.float32) + 0.5, indexing="ij")
    o, d = jax_primary_rays(jscene.camera, w, h, xx, yy, None, jnp)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    kw = dict(dict(width=w, height=h, mode="path", bounce_reorder="always",
                   bounce_reorder_period=1), **kw)
    want = None
    if with_jax:
        with jax.disable_jit():
            want = np.asarray(jax_integrator.trace_path(jscene, JaxConfig(**kw), o, d,
                                                        jax.random.PRNGKey(0)))
    got = integrator.trace_path(tscene, RenderConfig(**kw), torch.from_numpy(np.array(o)),
                                torch.from_numpy(np.array(d)), make_key(0)).numpy()
    assert np.isfinite(got).all() and got.mean() > 0.02
    return want, got


def test_reorder_compact_chunks_match_jax(reorder_scene):
    """reorder_compact_chunks = 4 on 16x16 rays, 1 bounce, re-sorted before
    it: chunks of 64 up to the last live lane."""
    want, got = _reorder_frames(reorder_scene, 16, 16, max_bounces=1, reorder_compact_chunks=4)
    _hold_path(got, want)
    _, unchunked = _reorder_frames(reorder_scene, 16, 16, False, max_bounces=1)
    _moved(got, unchunked, 0.2)


def test_reorder_compact_chunks_indivisible_falls_back(reorder_scene):
    """32x31 = 992 rays in 5 chunks do not divide: the loop runs unchunked,
    as the JAX package's (tests/test_reorder.py::
    test_chunked_indivisible_falls_back), bit for bit the frame with
    reorder_compact_chunks = 1, which tests/test_torch_reorder.py holds to
    the JAX package."""
    _, got = _reorder_frames(reorder_scene, 32, 31, False, max_bounces=1,
                             reorder_compact_chunks=5)
    _, one = _reorder_frames(reorder_scene, 32, 31, False, max_bounces=1)
    np.testing.assert_array_equal(got, one)


# ------------------------------------------------------------------ whitted batch sort

@pytest.mark.parametrize("lights", ["summed", "random"])
def test_whitted_sort_batch_matches_jax(lights):
    """The FIFO queue with each batch sorted, glassbox 16x16, depth 3,
    under the four lights: summed, and chosen at random (each branch draws
    its light at its sorted slot, so the sort's order reaches the image)."""
    w = h = 16
    jscene, tscene = _both(_lit_scene(w, h))
    kw = dict(width=w, height=h, mode="whitted", max_bounces=3, activate_sky=False,
              deterministic_lights=lights == "summed", whitted_sort_batch=True)
    cfg, jcfg = RenderConfig(**kw), JaxConfig(**kw)
    (jo, jd), (o, d) = _rays(cfg, (jscene.camera, tscene.camera))
    with jax.disable_jit():
        want, jit_iters = jax_integrator.trace_whitted_iter(jscene, jcfg, jo, jd, 3,
                                                            return_iters=True)
    got, iters = integrator.trace_whitted_iter(tscene, cfg, o, d, 3, return_iters=True)
    assert iters == int(jit_iters)
    assert float(got.mean()) > 0.02
    _hold(got.numpy(), want)
    if lights == "random":
        unsorted = integrator.trace_whitted_iter(
            tscene, dataclasses.replace(cfg, whitted_sort_batch=False), o, d, 3)
        _moved(got.numpy(), unsorted.numpy(), 0.05)


@pytest.mark.parametrize("lights", ["summed", "random"])
def test_exact_queue_is_the_same_with_the_batch_sort(lights):
    """The exact queue (render_sharded's) traces each batch sorted but
    keeps each branch's slot and queue order: the image and the iteration
    count equal the unsorted queue's bit for bit."""
    w = h = 16
    jscene, tscene = _both(_lit_scene(w, h))
    cfg = RenderConfig(width=w, height=h, mode="whitted", max_bounces=3,
                       deterministic_lights=lights == "summed")
    _, (o, d) = _rays(cfg, (jscene.camera, tscene.camera))
    plain = integrator.whitted_queue(tscene, cfg, o, d, 3, exact=True)
    traced = []
    kept = integrator._queue_batch

    def spy(scene, cfg_, batch, *rest):
        traced.append(batch[:, integrator._QPIX].clone())
        return kept(scene, cfg_, batch, *rest)

    integrator._queue_batch = spy
    try:
        got = integrator.whitted_queue(tscene, dataclasses.replace(cfg, whitted_sort_batch=True),
                                       o, d, 3, exact=True)
    finally:
        integrator._queue_batch = kept
    assert torch.equal(got[0], plain[0]) and got[1:] == plain[1:]
    # the rows were traced in another order than the queue's
    assert not torch.equal(traced[0], torch.arange(w * h, dtype=torch.float32))
