"""Parity of the PyTorch port's core numerics, random streams and host
builders with the JAX package, on the CPU.

The same numpy inputs go to both packages.  JAX runs op by op here (no
jit), so XLA fuses nothing and both sides round every elementwise step
the same way: the fast approximations, the ray offset and the random
streams must agree bit for bit.
"""

import math
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
from voxtracer.core import transforms as jtransforms
from voxtracer.io.hdr import procedural_sky as jax_sky
from voxtracer.render.camera import make_camera as jax_camera
from voxtracer.render.camera import primary_rays as jax_primary_rays
from voxtracer.render.sky import sample_sky as jax_sample_sky
from voxtracer.core.types import Sky as JSky
from voxtracer.core.types import GLASS
from voxtracer.scene import instances as jinst
from voxtracer.scene import procgen as jprocgen
from voxtracer.scene.volume import solid_grid as jax_solid_grid
from voxtracer_torch.core import mathx, rng, transforms
from voxtracer_torch.core.types import Sky
from voxtracer_torch.io.hdr import procedural_sky
from voxtracer_torch.kernels import rng as rng_kernel
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


def _map_counters(shape, m):
    """csrc/rng.cu ``counter()`` over every flat index of `shape`, in int64."""
    i = torch.arange(math.prod(shape), dtype=torch.int64)
    if m.lanes is None and m.row_stride == m.blk:
        return m.off + i
    r = i // m.blk
    q = i - r * m.blk
    if m.lanes is None:
        return r * m.row_stride + m.off + q
    a = q // m.inner
    return r * m.row_stride + m.lanes.long()[a] * m.inner + (q - a * m.inner)


def _lane_list(size, total, seed):
    """`size` distinct global lane indices of `total`, in no order."""
    g = torch.Generator().manual_seed(seed)
    return torch.randperm(total, generator=g)[:size]


# (shape, lanes, axis): the draws' shapes with every form of `lanes`
COUNTER_CASES = [
    *[(shape, None, axis) for shape in [(37,), (2, 37), (3, 37), (37, 2), (37, 3)]
      for axis in (0, -1)],
    ((37,), (5, 100), -1), ((3, 37), (0, 37), -1), ((3, 37), (11, 200), -1),
    ((2, 37), (60, 97), -1), ((37, 2), (11, 200), -1), ((37, 3), (11, 200), 0),
    ((37, 2), (11, 200), 0), ((3, 37), (1, 5), 0), ((2, 3, 37), (4, 9), 1),
    ((37,), (_lane_list(37, 120, 0), 120), -1), ((3, 37), (_lane_list(37, 80, 1), 80), -1),
    ((37, 3), (_lane_list(37, 64, 2), 64), 0), ((37, 2), (_lane_list(37, 37, 3), 37), 0),
    ((2, 37), (2 ** 32 - 20, 2 ** 32 + 50), -1), ((37, 3), (2 ** 32 + 7, 2 ** 33), 0),
]


@pytest.mark.parametrize("shape,lanes,axis", COUNTER_CASES)
def test_kernel_counter_map_is_counters(shape, lanes, axis):
    """The affine map the stream kernel evaluates gives each element the
    counter ``core.rng.counters`` gives it, for a window of lanes on either
    axis, a list of lanes, and a window past 2**32 lanes (threefry's hi
    word non-zero)."""
    m = rng_kernel.counter_map(shape, lanes, axis)
    assert m.blk * m.inner > 0 and math.prod(shape) % m.blk == 0
    want = rng.counters(shape, "cpu", lanes, axis)
    assert torch.equal(_map_counters(shape, m), want)
    if lanes is not None and not torch.is_tensor(lanes[0]) and lanes[0] >= 2 ** 32 - 20:
        assert (want >> 32).max() > 0


@pytest.mark.parametrize("draw", ["hash_uniform", "hash_normal", "threefry_uniform",
                                  "threefry_normal"])
def test_cpu_draws_take_the_plain_version(draw):
    """A CPU device runs the plain torch ops (no launch); any device but
    the CPU and CUDA raises."""
    before = dict(rng_kernel.launches)
    key = rng.fold_in(rng.make_key(7), 2)
    args = (key, 3) if draw.startswith("hash") else (key,)
    plain = getattr(rng, draw + "_plain")
    for dev, lanes in (("cpu", None), (torch.device("cpu"), (4, 50))):
        got = getattr(rng, draw)(*args, (3, 21), dev, lanes)
        want = plain(*args, (3, 21), dev, lanes)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert rng_kernel.launches == before
    with pytest.raises(ValueError, match="no random streams"):
        getattr(rng, draw)(*args, (3, 21), "meta")


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


@pytest.mark.parametrize("fn", ["transform_point", "transform_vector"])
def test_transforms_apply_as_jax(fn):
    """The same float32 arrays: numpy and torch inputs bit-equal to the JAX
    function on numpy; on JAX arrays XLA's CPU dot rounds as a chain of
    fused multiply-adds, 1e-6 relative."""
    rs = np.random.default_rng(3)
    m = rs.normal(size=(4, 4)).astype(np.float32)
    p = (rs.normal(size=(7, 5, 3)) * 10.0).astype(np.float32)
    want = getattr(jtransforms, fn)(m, p)
    port = getattr(transforms, fn)
    np.testing.assert_array_equal(port(m, p), want)
    got = port(torch.from_numpy(m), torch.from_numpy(p))
    assert isinstance(got, torch.Tensor) and got.shape == (7, 5, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(getattr(jtransforms, fn)(jnp.asarray(m),
                                                                   jnp.asarray(p))),
                               rtol=1e-6, atol=1e-6)


def test_port_imports_neither_jax_nor_reference():
    code = textwrap.dedent("""
        import sys
        import voxtracer_torch, voxtracer_torch.render.integrator, voxtracer_torch.cli
        import voxtracer_torch.scene.presets, voxtracer_torch.scene.convert
        import voxtracer_torch.diff.volumetric, voxtracer_torch.diff.train
        import voxtracer_torch.render.reproject, voxtracer_torch.core.sampling
        import voxtracer_torch.kernels.probes, voxtracer_torch.probe
        import voxtracer_torch.scene.instances, voxtracer_torch.config
        import voxtracer_torch.core.types, voxtracer_torch.kernels.traverse
        import voxtracer_torch.kernels.lookup, voxtracer_torch.kernels.dda_occ
        import voxtracer_torch.diff.path_replay, voxtracer_torch.diff.replay_active
        import voxtracer_torch.render.camera, voxtracer_torch.utils.retry
        import voxtracer_torch.core.transforms
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "voxtracer")]
        assert not bad, bad
    """)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(
        __import__("pathlib").Path(__file__).resolve().parent.parent))
