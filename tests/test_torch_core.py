"""Parity of the PyTorch port's core numerics, random streams and host
builders with the JAX package, on the CPU.

The same numpy inputs go to both packages.  JAX runs op by op here (no
jit), so XLA fuses nothing and both sides round every elementwise step
the same way: the fast approximations, the ray offset and the random
streams must agree bit for bit.
"""

import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.core import mathx as jmathx
from voxtracer.core import rng as jrng
from voxtracer.io.hdr import procedural_sky as jax_sky
from voxtracer.render.camera import make_camera as jax_camera
from voxtracer.render.camera import primary_rays as jax_primary_rays
from voxtracer.render.sky import sample_sky as jax_sample_sky
from voxtracer.core.types import Sky as JSky
from voxtracer.core.types import GLASS
from voxtracer.scene import instances as jinst
from voxtracer.scene import procgen as jprocgen
from voxtracer.scene.volume import solid_grid as jax_solid_grid
from voxtracer_torch.core import mathx, rng
from voxtracer_torch.core.types import Sky
from voxtracer_torch.io.hdr import procedural_sky
from voxtracer_torch.render.camera import make_camera, primary_rays
from voxtracer_torch.render.sky import sample_sky
from voxtracer_torch.scene import presets
from voxtracer_torch.scene.instances import build_volumes

torch.set_num_threads(1)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_offset_ray_bit_exact():
    g = np.random.default_rng(0)
    p = np.concatenate([g.uniform(-3, 3, 4000), g.uniform(-0.04, 0.04, 1000)])
    p = p.astype(np.float32)
    n = g.uniform(-1, 1, p.shape).astype(np.float32)
    want = jmathx.offset_ray(jnp.asarray(p), jnp.asarray(n), jnp)
    got = mathx.offset_ray(torch.from_numpy(p), torch.from_numpy(n))
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))


def test_fast_trig_bit_exact():
    g = np.random.default_rng(1)
    y = g.uniform(-2, 2, 5000).astype(np.float32)
    x = g.uniform(-2, 2, 5000).astype(np.float32)
    c = g.uniform(-1, 1, 5000).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(jmathx.atan2_fast(jnp.asarray(y), jnp.asarray(x), jnp)),
        _bits(mathx.atan2_fast(torch.from_numpy(y), torch.from_numpy(x)).numpy()))
    # acos_fast takes a square root.  XLA's CPU sqrt is not correctly
    # rounded (about 0.5% of these inputs land one ulp off), so the bit
    # comparison is against the JAX package's own numpy path, and jnp is
    # held to within an ulp.
    got = mathx.acos_fast(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(_bits(jmathx.acos_fast(c, np)), _bits(got))
    np.testing.assert_array_max_ulp(np.asarray(jmathx.acos_fast(jnp.asarray(c), jnp)),
                                    got, maxulp=1)
    np.testing.assert_array_equal(
        _bits(jmathx.schlick(jnp.asarray(c), jnp.float32(1.45), jnp)),
        _bits(mathx.schlick(torch.from_numpy(c), torch.tensor(1.45)).numpy()))
    np.testing.assert_array_equal(
        _bits(jmathx.schlick_nonmetal(jnp.asarray(c))),
        _bits(mathx.schlick_nonmetal(torch.from_numpy(c)).numpy()))


@pytest.mark.parametrize("seed,path", [(0, (0,)), (3, (5, 960)),
                                       (12345, (4, 0, 2)),
                                       (2 ** 31 - 1, (2 ** 31 - 1, 7))])
def test_fold_in_matches_jax(seed, path):
    jk, tk = jax.random.PRNGKey(seed), rng.make_key(seed)
    assert tuple(int(w) for w in np.asarray(jk)) == tk
    for data in path:
        jk, tk = jax.random.fold_in(jk, data), rng.fold_in(tk, data)
        assert tuple(int(w) for w in np.asarray(jk)) == tk


@pytest.mark.parametrize("seed,salt,shape", [(0, 1, (1000,)), (7, 100, (999, 2)),
                                             (42, 4, (3, 517))])
def test_hash_streams_match_jax(seed, salt, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    tk = rng.fold_in(rng.make_key(seed), 3)
    np.testing.assert_array_equal(
        np.asarray(jrng.hash_bits(jk, salt, shape)).astype(np.int64),
        rng.hash_bits(tk, salt, shape, "cpu").numpy())
    np.testing.assert_array_equal(
        _bits(jrng.hash_uniform(jk, salt, shape)),
        _bits(rng.hash_uniform(tk, salt, shape, "cpu").numpy()))
    # log and cos differ between XLA and torch by about an ulp
    np.testing.assert_allclose(np.asarray(jrng.hash_normal(jk, salt, shape)),
                               rng.hash_normal(tk, salt, shape, "cpu").numpy(),
                               rtol=1e-6, atol=1e-6)


def test_primary_rays_match_jax():
    w, h = 96, 40
    jcam = jax_camera(pos=(0.1, 1.1, -2.6), target=(0.2, 0.5, 0.5), aspect=w / h)
    tcam = make_camera(pos=(0.1, 1.1, -2.6), target=(0.2, 0.5, 0.5), aspect=w / h)
    for f in ("pos", "top_left", "top_right", "bottom_left", "right", "up", "ahead"):
        np.testing.assert_array_equal(getattr(jcam, f), getattr(tcam, f).numpy())
    g = np.random.default_rng(2)
    px = g.uniform(0, w, 2000).astype(np.float32)
    py = g.uniform(0, h, 2000).astype(np.float32)
    jo, jd = jax_primary_rays(jax.tree.map(jnp.asarray, jcam), w, h,
                              jnp.asarray(px), jnp.asarray(py), None, jnp)
    to, td = primary_rays(tcam, w, h, torch.from_numpy(px), torch.from_numpy(py))
    np.testing.assert_allclose(np.asarray(jo), to.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=1e-6, atol=1e-6)


def test_sample_sky_matches_jax():
    pix = procedural_sky(512, 256)
    np.testing.assert_array_equal(pix, jax_sky(512, 256))
    g = np.random.default_rng(3)
    d = g.normal(size=(4000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jsky = JSky(pixels=jnp.asarray(pix), contribution=jnp.float32(1.0))
    tsky = Sky(pixels=torch.from_numpy(pix), contribution=torch.tensor(1.0))
    for active in (True, False):
        want = jax_sample_sky(jsky, jnp.asarray(d), active, (0.392, 0.584, 0.829))
        got = sample_sky(tsky, torch.from_numpy(d), active, (0.392, 0.584, 0.829))
        np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-6, atol=1e-6)


def _jax_specs(name):
    """The JAX package's VolumeSpecs for the port's asset-free presets."""
    if name == "monu_like":
        specs = [jinst.VolumeSpec(position=(float(i) * 0.75 - 0.75, 0.0, 0.0),
                                  gridsize=64,
                                  grid=jprocgen.generate_noise_grid(64, seed=s))
                 for i, s in enumerate((1, 2, 3))]
        return specs + [jinst.VolumeSpec(position=(0.0, -0.51, 0.0), gridsize=1,
                                         scale=(8.0, 0.02, 8.0),
                                         grid=jax_solid_grid(1, 7))]
    return [
        jinst.VolumeSpec(position=(0, 0, 0), gridsize=8, grid=jax_solid_grid(8, GLASS),
                         scale=(0.5, 0.5, 0.5), rotation=(0.13, 0.41, 0.07)),
        jinst.VolumeSpec(position=(0.0, -0.6, 0.0), gridsize=1, scale=(4.0, 0.3, 4.0),
                         grid=jax_solid_grid(1, 1), rotation=(0.02, 0.11, 0.015)),
        jinst.VolumeSpec(position=(0.0, 0.0, 0.8), gridsize=1, scale=(3.0, 3.0, 0.2),
                         grid=jax_solid_grid(1, 7), rotation=(0.06, -0.09, 0.03)),
        jinst.VolumeSpec(position=(0.3, -0.05, 0.0), gridsize=32,
                         grid=jprocgen.generate_smoke_grid(32, seed=5),
                         scale=(0.45, 0.45, 0.45), rotation=(0.0, 0.2, 0.0)),
    ]


@pytest.mark.parametrize("name", ["monu_like", "media"])
def test_builders_match_jax(name):
    want = jinst.build_volumes(_jax_specs(name))
    port_specs = presets.monu_like_specs() if name == "monu_like" else presets.media_specs()
    got = build_volumes(port_specs)
    for f in ("grids", "gridsize", "inv", "fwd", "cube_min", "bricks", "bricksize", "occ"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)


def test_port_imports_neither_jax_nor_reference():
    code = textwrap.dedent("""
        import sys
        import voxtracer_torch, voxtracer_torch.render.integrator, voxtracer_torch.cli
        import voxtracer_torch.scene.presets, voxtracer_torch.scene.convert
        import voxtracer_torch.diff.volumetric, voxtracer_torch.diff.train
        import voxtracer_torch.render.reproject, voxtracer_torch.core.sampling
        import voxtracer_torch.kernels.probes, voxtracer_torch.probe
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "voxtracer")]
        assert not bad, bad
    """)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(
        __import__("pathlib").Path(__file__).resolve().parent.parent))
