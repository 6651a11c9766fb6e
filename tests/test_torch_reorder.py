"""The port's bounce reorder (``_trace_path_reordered``) against the JAX
package's, on the CPU.

The reorder sorts the path wavefront by [terminated : morton code of the
origin : direction octant] before bounce 1 and then every
``bounce_reorder_period``-th bounce.  The counter-hash streams are per
lane, so a reordered frame draws other samples than an unordered one: the
port must reproduce the JAX package's reordered image, lane for lane.

The JAX sort key lives in a closure, so the key test states it again in
jnp, line for line, and sorts with ``lax.sort`` on (key, iota) as the JAX
package does; the port's key and permutation must equal them exactly.
The frame test runs the JAX ``trace_path`` op by op (``disable_jit``, no
multiply-add contracted, ``VOXTRACER_PALLAS=0``) on the paged 66-volume
scene of tests/test_torch_paged.py, its last volume swapped for a hollow
shell around the rest so that every ray keeps bouncing, at 24 x 16, 2
bounces, within the path tolerances of tests/test_torch_render.py: mean
absolute difference <= 1e-4, at most 1% of pixels off by more than 1e-3.
The port packs the path state a component a row ([21, n]) where the JAX
package packs a ray a row ([n, 22]): the key and the permutation do not
depend on it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_paged import _both, _random_specs, _unpaged
from voxtracer.config import RenderConfig as JaxConfig
from voxtracer.core.types import MAT_NONE
from voxtracer.render import integrator as jax_integrator
from voxtracer.scene.lights import make_lights
from voxtracer_torch.config import RenderConfig
from voxtracer_torch.core.rng import make_key
from voxtracer_torch.render import integrator
from voxtracer_torch.render.camera import primary_rays
from voxtracer_torch.scene.lights import make_lights as port_lights

torch.set_num_threads(1)

W, H = 24, 16


@pytest.fixture(scope="module")
def scenes():
    """The paged 66-volume scene under a point light, its last volume a
    hollow white shell around the others and the camera, so that every ray
    hits and bounces."""
    specs = _random_specs()
    shell = np.full((16,) * 3, 0, np.uint8)
    shell[1:-1, 1:-1, 1:-1] = MAT_NONE
    specs[65] = dict(position=(-0.5, -0.5, -0.5), gridsize=16, scale=(11.0, 11.0, 11.0),
                     grid=shell)
    jscene, tscene = _both(specs)
    light = ((0.5, 3.0, -3.0, 9.0, 9.0, 8.0),)
    jscene = jscene.replace(lights=jax.tree.map(jnp.asarray, make_lights(point=light)))
    return jscene, dataclasses.replace(tscene, lights=port_lights(point=light))


def _camera_rays(tscene):
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.float32) + 0.5,
                            torch.arange(W, dtype=torch.float32) + 0.5, indexing="ij")
    o, d = primary_rays(tscene.camera, W, H, px.reshape(-1), py.reshape(-1))
    return o.contiguous(), d.contiguous()


def _jax_key(pk, lo, span):
    """voxtracer/render/integrator.py ``morton_key`` (:975-988), restated,
    on the JAX package's layout: a ray a row."""
    n = pk.shape[0]
    done = pk[:, 13] <= 0.5
    q = []
    for c in range(3):
        f = (pk[:, c] - lo[c]) / span[c]
        q.append(jnp.clip((f * 32.0).astype(jnp.int32), 0, 31))
    m = jnp.zeros(n, jnp.int32)
    for bit in range(5):
        for c in range(3):
            m = m | (((q[c] >> bit) & 1) << (3 * bit + c + 3))
    oct_ = ((pk[:, 3] < 0).astype(jnp.int32) + 2 * (pk[:, 4] < 0).astype(jnp.int32)
            + 4 * (pk[:, 5] < 0).astype(jnp.int32))
    return jnp.where(done, jnp.int32(1 << 30), m | oct_)


def test_world_bounds_match_jax(scenes):
    jscene, tscene = scenes
    jlo, jhi = jax_integrator._world_bounds(jscene)
    lo, hi = integrator._world_bounds(tscene)
    np.testing.assert_allclose(np.asarray(jlo), lo.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jhi), hi.numpy(), rtol=1e-6, atol=1e-6)


def test_morton_key_and_permutation_match_jax():
    """A random packed state: origins in and around the world box (a few
    far outside, inf and NaN), every octant, a third of the rays
    terminated, many equal keys."""
    rng = np.random.default_rng(3)
    n = 5000
    pk = rng.uniform(-1.0, 1.0, (n, integrator._PK_ROWS)).astype(np.float32)
    pk[:, :3] = rng.uniform(-3.0, 3.0, (n, 3))
    pk[:40, 0] = [1e30, -1e30, np.inf, -np.inf] * 10
    pk[40:50, 1] = np.nan
    pk[:, integrator._PK_ACTIVE] = rng.uniform(size=n) < 0.67
    lo = np.array([-2.5, -2.0, -2.25], np.float32)
    span = np.array([5.0, 4.5, 4.0], np.float32)
    want = _jax_key(jnp.asarray(pk), jnp.asarray(lo), jnp.asarray(span))
    _, perm = jax.lax.sort((want, jnp.arange(n, dtype=jnp.int32)), num_keys=1)
    tpk = torch.from_numpy(np.ascontiguousarray(pk.T))  # the port packs a component a row
    got = integrator._morton_key(tpk, torch.from_numpy(lo), torch.from_numpy(span))
    assert got.dtype == torch.int32 and len(np.unique(got.numpy())) < 0.7 * n
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(
        np.asarray(perm),
        integrator._reorder_perm(tpk, torch.from_numpy(lo), torch.from_numpy(span)).numpy())


def _unpack_path(pk):
    """[21 or 22, n] -> (the state dict, each ray's first lane): the packed
    rows back as component tuples and bool flags."""
    c = pk.unbind(0)
    st = dict(o=c[0:3], d=c[3:6], tp=c[6:9], rad=c[9:12], in_glass=c[12] > 0.5,
              active=c[integrator._PK_ACTIVE] > 0.5, sky_tp=c[15:18], sky_d=c[18:21])
    if len(c) > integrator._PK_ROWS:
        st["in_light"] = c[integrator._PK_ROWS] > 0.5
    return st, c[integrator._PK_PIX]


def test_pack_path_round_trip():
    rng = np.random.default_rng(4)
    n = 257

    def vec():
        return tuple(torch.from_numpy(rng.normal(size=n).astype(np.float32)) for _ in range(3))

    st = dict(o=vec(), d=vec(), tp=vec(), rad=vec(), sky_tp=vec(), sky_d=vec(),
              in_glass=torch.from_numpy(rng.uniform(size=n) < 0.5),
              active=torch.from_numpy(rng.uniform(size=n) < 0.5))
    pix = torch.arange(n, dtype=torch.float32)
    pk = integrator._pack_path(st, pix)
    assert pk.shape == (integrator._PK_ROWS, n)
    back, bpix = _unpack_path(pk)
    assert torch.equal(bpix, pix)
    for k, v in st.items():
        for a, b in zip(v if isinstance(v, tuple) else (v,),
                        back[k] if isinstance(v, tuple) else (back[k],)):
            assert torch.equal(a, b) and b.is_contiguous(), k


@pytest.mark.parametrize("period", [1, 2])
def test_reordered_trace_path_matches_jax(scenes, period, monkeypatch):
    jscene, tscene = scenes
    o, d = _camera_rays(tscene)
    kw = dict(width=W, height=H, mode="path", max_bounces=2, bounce_reorder="always",
              bounce_reorder_period=period)
    monkeypatch.setenv("VOXTRACER_PALLAS", "0")
    with jax.disable_jit():
        want = np.asarray(jax_integrator.trace_path(
            jscene, JaxConfig(**kw), jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
            jax.random.PRNGKey(0)))
    got = integrator.trace_path(tscene, RenderConfig(**kw), o, d, make_key(0)).numpy()
    assert got.shape == (W * H, 3) and np.isfinite(got).all()
    diff = np.abs(got - want)
    assert diff.mean() <= 1e-4, diff.mean()
    assert (diff.max(-1) > 1e-3).mean() <= 0.01
    assert 0.02 < got.mean() < 10.0
    # the reorder reassigns the samples: the unordered frame is another one
    plain = integrator.trace_path(tscene, RenderConfig(**dict(kw, bounce_reorder="none")), o, d,
                                  make_key(0)).numpy()
    assert (np.abs(plain - got).max(-1) > 1e-3).mean() > 0.05


def test_auto_reorders_only_a_paged_scene_with_enough_rays(scenes, monkeypatch):
    _, tscene = scenes
    o, d = _camera_rays(tscene)
    taken = []
    kept = integrator._trace_path_reordered

    def spy(*args):
        taken.append(True)
        return kept(*args)

    monkeypatch.setattr(integrator, "_trace_path_reordered", spy)

    def reordered(scene, **kw):
        taken.clear()
        cfg = RenderConfig(**dict(dict(width=W, height=H, mode="path", max_bounces=1), **kw))
        integrator.trace_path(scene, cfg, o, d, make_key(1))
        return bool(taken)

    assert RenderConfig().bounce_reorder == JaxConfig().bounce_reorder == "auto"
    assert RenderConfig().bounce_reorder_period == JaxConfig().bounce_reorder_period == 2
    assert RenderConfig().compact_min == JaxConfig().compact_min == 65536
    assert not reordered(tscene)                              # 384 rays < compact_min
    assert reordered(tscene, compact_min=W * H)               # paged and enough rays
    assert not reordered(_unpaged(tscene), compact_min=1)     # not paged
    assert not reordered(tscene, compact_min=1, bounce_reorder="none")
    assert reordered(_unpaged(tscene), bounce_reorder="always")
    assert not reordered(tscene, bounce_reorder="always", max_bounces=0)
