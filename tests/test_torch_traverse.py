"""Parity of the PyTorch port's traversal and row lookup with the JAX
package on the CPU.

On the CPU the port's wrappers run the plain versions: ``traverse`` and
``exit_march`` go to the dense ``dda_occ.traverse_occ``, ``lookup_rows``
to a clipped gather.  They are held against the JAX package's CPU paths:
``traverse_occ_topk`` (what ``find_nearest_world`` runs off the TPU) and
``traverse_occ``.  Bars, as tests/test_pallas_dda.py sets them: hit, vol
and cell exact; t within 1e-6; normals within 1e-5.

The CUDA kernels themselves are held against these plain versions on the
card in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.core.types import GLASS as JGLASS
from voxtracer.core.types import MAT_NONE, SMOKE_MID_DENSITY
from voxtracer.kernels import dda_occ as jdda_occ
from voxtracer.kernels import primitives as jprim
from voxtracer.scene.instances import VolumeSpec, build_volumes
from voxtracer.scene.instances import make_spheres as jax_make_spheres
from voxtracer.scene.instances import make_triangles as jax_make_triangles
from voxtracer_torch.kernels import lookup, traverse
from voxtracer_torch.kernels import primitives as prim
from voxtracer_torch.kernels.dda import BIG
from voxtracer_torch.kernels.dda_occ import entry_t
from voxtracer_torch.scene.instances import make_spheres as port_make_spheres
from voxtracer_torch.scene.instances import make_triangles as port_make_triangles

torch.set_num_threads(1)


def _rand_scene(rng, nvol, gridsize=32):
    """Volumes with a few solid boxes of mixed materials (glass and smoke
    included), random positions, rotations and non-uniform scales."""
    specs = []
    for _ in range(nvol):
        g = np.full((gridsize,) * 3, MAT_NONE, np.uint8)
        for _ in range(4):
            lo = rng.integers(0, gridsize - 4, 3)
            hi = lo + rng.integers(2, 10, 3)
            mat = int(rng.choice([1, 2, 7, JGLASS, SMOKE_MID_DENSITY, 15]))
            g[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = mat
        specs.append(VolumeSpec(position=tuple(rng.uniform(-1.2, 1.2, 3)),
                                gridsize=gridsize, grid=g,
                                rotation=tuple(rng.uniform(-0.5, 0.5, 3)),
                                scale=tuple(rng.uniform(0.6, 1.5, 3))))
    return build_volumes(specs)


def _rand_rays(rng, n=512):
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _jax_args(vols):
    return (jnp.asarray(vols.grids.reshape(-1)), jnp.asarray(vols.gridsize),
            jnp.asarray(vols.inv), jnp.asarray(vols.fwd), jnp.asarray(vols.cube_min))


def _torch_args(vols):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(vols.grids.reshape(-1)), t(vols.gridsize), t(vols.inv), t(vols.fwd),
            t(vols.cube_min))


def _torch_occ(vols):
    return torch.from_numpy(np.asarray(vols.occ)), torch.from_numpy(vols.bricksize)


def _assert_same(ref, got, mask_key, fields):
    h = np.asarray(ref[mask_key])
    np.testing.assert_array_equal(h, got[mask_key].numpy())
    np.testing.assert_allclose(np.asarray(ref["t"]), got["t"].numpy(),
                               rtol=1e-6, atol=1e-6)
    for f in fields:
        np.testing.assert_array_equal(np.asarray(ref[f]), got[f].numpy(), err_msg=f)
    for c in ("nx", "ny", "nz"):
        np.testing.assert_allclose(np.asarray(ref[c])[h], got[c].numpy()[h],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_nearest_matches_jax(seed):
    rng = np.random.default_rng(seed)
    vols = _rand_scene(rng, nvol=4)
    o, d = _rand_rays(rng)
    n = o.shape[0]
    act = rng.uniform(size=n) < 0.9
    ven = np.array([True, True, seed != 2, True])
    kw = dict(occ=jnp.asarray(vols.occ), bricksize=jnp.asarray(vols.bricksize))
    jargs = (*_jax_args(vols), jnp.asarray(o), jnp.asarray(d),
             jnp.full(n, BIG, jnp.float32), jnp.asarray(act), jnp.asarray(ven))
    got = traverse.traverse(*_torch_args(vols), torch.from_numpy(o), torch.from_numpy(d),
                            torch.full((n,), BIG), torch.from_numpy(act),
                            torch.from_numpy(ven), *_torch_occ(vols), mode="nearest")
    refs = [jdda_occ.traverse_occ(*jargs, **kw, mode="nearest")]
    if ven.all():
        # traverse_occ_topk still walks a disabled volume while a ray's
        # t_limit and best t are both BIG (its BIG entry key passes
        # kt0 <= min(tl, best)), so it is a reference only with every
        # volume enabled
        refs.append(jdda_occ.traverse_occ_topk(*jargs, **kw, mode="nearest", k=2))
    for ref in refs:
        _assert_same(ref, got, "hit", ("vol", "cell"))
    assert int(got["hit"].sum()) > 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_occluded_matches_jax(seed):
    rng = np.random.default_rng(10 + seed)
    vols = _rand_scene(rng, nvol=4)
    o, d = _rand_rays(rng)
    n = o.shape[0]
    tl = rng.uniform(0.5, 4.0, n).astype(np.float32)
    act = np.ones(n, bool)
    ven = np.ones(4, bool)
    kw = dict(occ=jnp.asarray(vols.occ), bricksize=jnp.asarray(vols.bricksize))
    jargs = (*_jax_args(vols), jnp.asarray(o), jnp.asarray(d), jnp.asarray(tl),
             jnp.asarray(act), jnp.asarray(ven))
    got = traverse.traverse(*_torch_args(vols), torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(tl), torch.from_numpy(act),
                            torch.from_numpy(ven), *_torch_occ(vols), mode="occluded")
    for ref in (jdda_occ.traverse_occ_topk(*jargs, **kw, mode="occluded", k=2),
                jdda_occ.traverse_occ(*jargs, **kw, mode="occluded")):
        np.testing.assert_array_equal(np.asarray(ref["hit"]), got["hit"].numpy())
    assert 0 < int(got["hit"].sum()) < n


def _exit_case(seed):
    """Rays dropped near the volume interiors, each marching its own volume
    through the glass or the smoke plane."""
    rng = np.random.default_rng(20 + seed)
    vols = _rand_scene(rng, nvol=3)
    o, d = _rand_rays(rng, n=512)
    o = o * 0.4
    n = o.shape[0]
    vol = rng.integers(0, vols.n, n).astype(np.int32)
    code = rng.integers(0, 2, n).astype(np.int32)
    act = rng.uniform(size=n) < 0.8
    return vols, o, d, vol, code, act


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_exit_matches_jax(seed):
    vols, o, d, vol, code, act = _exit_case(seed)
    n = o.shape[0]
    ref = jdda_occ.traverse_occ(*_jax_args(vols), jnp.asarray(o), jnp.asarray(d),
                                jnp.full(n, BIG, jnp.float32), jnp.asarray(act),
                                jnp.ones(vols.n, bool), occ=jnp.asarray(vols.occ),
                                bricksize=jnp.asarray(vols.bricksize), mode="exit",
                                mode_code=jnp.asarray(code), vol_match=jnp.asarray(vol))
    got = traverse.exit_march(*_torch_args(vols), torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(act), torch.from_numpy(code),
                              torch.from_numpy(vol), *_torch_occ(vols))
    _assert_same(ref, got, "in_vol", ("cell",))
    assert int(got["in_vol"].sum()) > 0


def test_lookup_rows_matches_take():
    rng = np.random.default_rng(5)
    tab = rng.uniform(size=(256, 6)).astype(np.float32)
    idx = rng.integers(-40, 300, 5000).astype(np.int32)
    want = np.asarray(jnp.take(jnp.asarray(tab), jnp.asarray(idx), axis=0, mode="clip"))
    got = lookup.lookup_rows(torch.from_numpy(tab), torch.from_numpy(idx))
    np.testing.assert_array_equal(want, got.numpy())


def test_entry_t_matches_jax():
    rng = np.random.default_rng(4)
    vols = _rand_scene(rng, nvol=4)
    o, d = _rand_rays(rng)
    want = jdda_occ._entry_t(jnp.asarray(vols.inv), jnp.asarray(vols.cube_min),
                             jnp.asarray(o), jnp.asarray(d))
    got = entry_t(torch.from_numpy(vols.inv), torch.from_numpy(vols.cube_min),
                  torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-6, atol=1e-6)
    assert (got.numpy() < BIG).any() and (got.numpy() == 0.0).any()


def test_primitives_match_jax():
    rng = np.random.default_rng(6)
    o, d = _rand_rays(rng, n=1024)
    sph = [(*rng.uniform(-1.5, 1.5, 3), rng.uniform(0.2, 0.8), int(rng.integers(0, 16)))
           for _ in range(5)]
    tri = [(rng.uniform(-1, 1, 3), rng.uniform(-1, 1, 3), rng.uniform(-1, 1, 3),
            rng.uniform(-1, 1, 3), int(rng.integers(0, 16))) for _ in range(5)]
    js, jt = jax_make_spheres(sph), jax_make_triangles(tri)
    ts, tt = port_make_spheres(sph), port_make_triangles(tri)
    jo, jd, to, td = jnp.asarray(o), jnp.asarray(d), torch.from_numpy(o), torch.from_numpy(d)
    tl = rng.uniform(0.5, 3.0, o.shape[0]).astype(np.float32)

    want = jprim.spheres_nearest(js, jo, jd)
    got = prim.spheres_nearest(ts, to, td)
    hit = np.asarray(want[1]) != MAT_NONE
    assert hit.any()
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    np.testing.assert_array_equal(np.asarray(want[3]), got[3].numpy())
    np.testing.assert_allclose(np.asarray(want[0]), got[0].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(want[2])[hit], got[2].numpy()[hit], atol=1e-5)

    want = jprim.triangles_nearest(jt, jo, jd)
    got = prim.triangles_nearest(tt, to, td)
    hit = np.asarray(want[1]) != MAT_NONE
    assert hit.any()
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    np.testing.assert_allclose(np.asarray(want[0]), got[0].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(want[2])[hit], got[2].numpy()[hit], atol=1e-5)

    for jf, tf, jp, tp in ((jprim.spheres_occluded, prim.spheres_occluded, js, ts),
                           (jprim.triangles_occluded, prim.triangles_occluded, jt, tt)):
        np.testing.assert_array_equal(np.asarray(jf(jp, jo, jd, jnp.asarray(tl))),
                                      tf(tp, to, td, torch.from_numpy(tl)).numpy())
