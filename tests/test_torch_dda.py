"""The port's single-volume DDA and ``dda.traverse``'s three modes against
the JAX package's ``kernels/dda.py``, on the CPU.

* The six cases of tests/test_dda.py (an axis ray, misses, diagonal rays
  against a brute-force march, the exit march, occlusion, a voxel normal),
  each run through both packages' single-volume wrappers (``dda_nearest``,
  ``dda_exit``, ``dda_occluded``, ``normal_voxel``) on the same inputs:
  hit, in_vol and cell identical, t within 1e-6; the analytic
  expectations of tests/test_dda.py hold on the port's side too.
* ``traverse`` in each mode (nearest with a skip range, occluded, exit
  through glass and smoke) over a random 3-volume scene with transforms,
  without bricks (the one-level walk) and with them (the two-level walk),
  against the JAX ``traverse`` on the same arrays run op by op
  (``disable_jit``: under jit XLA contracts the object-space transform's
  multiply-adds, which moves an exit t by 1.3e-6): hit, vol, in_vol and
  cell identical, t within 1e-6 and normals within 1e-5 (XLA's CPU rsqrt
  is approximate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.core.types import GLASS, MAT_NONE, SMOKE_MID_DENSITY
from voxtracer.kernels import dda as jdda
from voxtracer.scene.instances import VolumeSpec, build_volumes
from voxtracer_torch.kernels import dda

torch.set_num_threads(1)


def _grid(g):
    return np.full((g, g, g), MAT_NONE, np.int32)


def _rays(o, d):
    o = np.asarray(o, np.float32)
    d = np.asarray(d, np.float32)
    with np.errstate(divide="ignore"):  # an axis ray: 1 / 0 = inf, as the JAX package's
        rd = (1.0 / d).astype(np.float32)
    return o, d, rd, np.signbit(d).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want, t_index=1):
    """Per-ray outputs of the two packages: t within 1e-6, the rest equal."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        if i == t_index:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)


def _nearest_both(grid, o, d, t_limit=1e34):
    g, n = grid.shape[0], o.shape[0]
    o, d, rd, ds = _rays(o, d / np.linalg.norm(d, axis=-1, keepdims=True))
    want = jdda.dda_nearest(jnp.asarray(grid.reshape(-1)), jnp.int32(g), g,
                            jnp.zeros(3, jnp.float32), jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray(rd), jnp.asarray(ds), jnp.full(n, t_limit, jnp.float32),
                            jnp.ones(n, bool), jnp.int32(1), jnp.int32(0))
    got = dda.dda_nearest(_t(grid.reshape(-1)), g, g, torch.zeros(3), _t(o), _t(d), _t(rd),
                          _t(ds), torch.full((n,), t_limit), torch.ones(n, dtype=torch.bool),
                          1, 0)
    _same(got, want)
    return got


def test_axis_ray_hits_first_voxel():
    grid = _grid(8)
    grid[4, :, :] = 3  # a solid slab at x cell 4
    hit, t, cell = _nearest_both(grid, np.array([[-0.5, 0.55, 0.55], [1.5, 0.55, 0.55]]),
                                 np.array([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]]))
    assert hit.all() and cell.tolist() == [3, 3]
    np.testing.assert_allclose(t.numpy(), [1.0, 1.5 - 5.0 / 8.0], atol=1e-5)


def test_miss_empty_grid_and_outside():
    hit, _, cell = _nearest_both(_grid(4), np.array([[0.5, 0.5, -1.0], [5.0, 5.0, 5.0]]),
                                 np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]]))
    assert not hit.any() and int(cell[0]) == MAT_NONE


def test_diagonal_traversal_matches_bruteforce():
    rng = np.random.default_rng(0)
    g = 16
    grid = _grid(g)
    grid[rng.random((g, g, g)) < 0.08] = 5
    n = 256
    o = (rng.random((n, 3)).astype(np.float32) - 0.5) * 0.2 - np.array([0.6, 0, 0], np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hit, t, _ = _nearest_both(grid, o, d)
    assert 0 < int(hit.sum()) < n
    for i in range(0, n, 17):
        ts = np.arange(0.0, 3.0, 1e-4, dtype=np.float64)
        pts = o[i][None, :] + ts[:, None] * d[i][None, :]
        inside = ((pts >= 0) & (pts < 1)).all(axis=1)
        cells = np.clip((pts * g).astype(int), 0, g - 1)
        occ = inside & (grid[cells[:, 0], cells[:, 1], cells[:, 2]] != MAT_NONE)
        assert bool(hit[i]) == bool(occ.any()), i
        if occ.any():
            assert abs(float(t[i]) - ts[occ.argmax()]) < 5e-4, i


def _exit_both(grid, o, d):
    g = grid.shape[0]
    o, d, rd, ds = _rays(o, d)
    want = jdda.dda_exit(jnp.asarray(grid.reshape(-1)), jnp.int32(g), g,
                         jnp.zeros(3, jnp.float32), jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(rd), jnp.asarray(ds), jnp.ones(1, bool),
                         jnp.zeros(1, jnp.int32), jnp.int32(8), jnp.int32(9), jnp.int32(14))
    got = dda.dda_exit(_t(grid.reshape(-1)), g, g, torch.zeros(3), _t(o), _t(d), _t(rd), _t(ds),
                       torch.ones(1, dtype=torch.bool), torch.zeros(1, dtype=torch.int32),
                       8, 9, 14)
    _same(got, want)
    return got


def test_exit_march_through_material():
    o, d = [[2.5 / 8.0, 0.55, 0.57]], [[1.0, 0.0, 0.0]]  # inside the glass
    grid = _grid(8)
    grid[2:6, :, :] = GLASS  # glass block, x cells [2, 6)
    in_vol, t, cell = _exit_both(grid, o, d)
    assert bool(in_vol[0]) and int(cell[0]) == MAT_NONE  # exits into an empty cell
    np.testing.assert_allclose(float(t[0]), 6.0 / 8.0 - 2.5 / 8.0, atol=1e-5)
    grid2 = _grid(8)
    grid2[2:, :, :] = GLASS  # glass to the grid's edge: falls off, boundary t
    in_vol, t, _ = _exit_both(grid2, o, d)
    assert not bool(in_vol[0])
    np.testing.assert_allclose(float(t[0]), 1.0 - 2.5 / 8.0, atol=1e-5)


def test_occlusion_blocked_and_clear():
    g = 8
    grid = _grid(g)
    grid[:, 3, :] = 9  # a smoke slab occludes too (the reference's quirk)
    o, d, rd, ds = _rays([[0.55, -0.5, 0.57], [0.55, -0.5, 0.57]],
                         [[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]])
    for limit, expect in ((10.0, [True, False]), (0.6, [False, False])):
        want = jdda.dda_occluded(jnp.asarray(grid.reshape(-1)), jnp.int32(g), g,
                                 jnp.zeros(3, jnp.float32), jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(rd), jnp.asarray(ds),
                                 jnp.full(2, limit, jnp.float32), jnp.ones(2, bool))
        got = dda.dda_occluded(_t(grid.reshape(-1)), g, g, torch.zeros(3), _t(o), _t(d), _t(rd),
                               _t(ds), torch.full((2,), limit), torch.ones(2, dtype=torch.bool))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.tolist() == expect


def test_normal_voxel_faces():
    rng = np.random.default_rng(1)
    # a ray along +x hits the face at x = 0.5: normal -x; then random rays
    # at random t through a rotated-and-scaled forward matrix
    o = np.concatenate([[[-0.5, 0.55, 0.55]], rng.uniform(-1, 2, (15, 3))]).astype(np.float32)
    d = np.concatenate([[[1.0, 0.0, 0.0]], rng.normal(size=(15, 3))]).astype(np.float32)
    t = np.concatenate([[1.0], rng.uniform(0, 2, 15)]).astype(np.float32)
    ds = np.signbit(d).astype(np.float32)
    for fwd in (np.eye(4, dtype=np.float32),
                build_volumes([VolumeSpec(position=(0.1, 0.2, 0.3), gridsize=8,
                                          grid=_grid(8), rotation=(0.3, -0.2, 0.1),
                                          scale=(1.0, 2.0, 0.5))]).fwd[0]):
        want = np.asarray(jdda.normal_voxel(jnp.int32(8), jnp.asarray(fwd), jnp.asarray(o),
                                            jnp.asarray(d), jnp.asarray(t), jnp.asarray(ds)))
        got = dda.normal_voxel(8, _t(fwd), _t(o), _t(d), _t(t), _t(ds)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    axis = dda.normal_voxel(8, torch.eye(4), _t(o[:1]), _t(d[:1]), _t(t[:1]), _t(ds[:1]))
    np.testing.assert_allclose(axis.numpy()[0], [-1.0, 0.0, 0.0], atol=1e-6)


# ---------------------------------------------------------------- traverse's modes

@pytest.fixture(scope="module")
def world():
    """Three transformed 32^3 volumes of boxes (a glass and a smoke box in
    each, then three of plain, emissive or glass materials) and 256 rays
    from random origins towards random points of the volumes' cubes, as
    numpy arrays."""
    rng = np.random.default_rng(4)
    specs = []
    for _ in range(3):
        g = np.full((32,) * 3, MAT_NONE, np.uint8)
        for mat in (GLASS, SMOKE_MID_DENSITY, *rng.choice([1, 2, 7, GLASS, 15], 3)):
            lo = rng.integers(0, 28, 3)
            hi = lo + rng.integers(2, 12, 3)
            g[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = int(mat)
        specs.append(VolumeSpec(position=tuple(rng.uniform(-1.2, 1.2, 3)), gridsize=32, grid=g,
                                rotation=tuple(rng.uniform(-0.5, 0.5, 3)),
                                scale=tuple(rng.uniform(0.6, 1.5, 3))))
    vols = build_volumes(specs)
    n = 256
    fwd, cmin = np.asarray(vols.fwd), np.asarray(vols.cube_min)
    # from random origins towards a random point of a random volume's cube
    aim = rng.integers(0, 3, n)
    local = np.concatenate([cmin[aim] + rng.random((n, 3)), np.ones((n, 1))], axis=1)
    target = np.einsum("nij,nj->ni", fwd[aim], local)[:, :3]
    o = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    arrays = dict(grids=np.asarray(vols.grids).reshape(-1), gridsize=np.asarray(vols.gridsize),
                  inv=np.asarray(vols.inv), fwd=np.asarray(vols.fwd),
                  cube_min=np.asarray(vols.cube_min), bricks=np.asarray(vols.bricks).reshape(-1),
                  bricksize=np.asarray(vols.bricksize))
    # the exit march's rays: each starts inside a glass or smoke cell of
    # its volume (the centre of a random such cell, in world space)
    vm = rng.integers(0, 3, n).astype(np.int32)
    code, eo = np.zeros(n, np.int32), np.zeros((n, 3), np.float32)
    for i in range(n):
        g = specs[vm[i]].grid
        cells = np.argwhere((g == GLASS) | ((g >= 9) & (g <= 14)))
        c = cells[rng.integers(len(cells))]
        code[i] = int(g[tuple(c)] != GLASS)
        local = np.append((c + 0.5) / 32.0 + arrays["cube_min"][vm[i]], 1.0)
        eo[i] = (arrays["fwd"][vm[i]] @ local)[:3]
    return arrays, o, d, eo, vm, code


@pytest.mark.parametrize("bricks", [False, True])
@pytest.mark.parametrize("mode", ["nearest", "occluded", "exit"])
def test_traverse_modes_match_jax(world, mode, bricks):
    a, o, d, eo, vm, code = world
    n = o.shape[0]
    rng = np.random.default_rng(7)
    tl = np.where(rng.random(n) < 0.5, 1e34, rng.uniform(0.5, 3.0, n)).astype(np.float32)
    act = rng.random(n) < 0.9
    ven = np.array([True, False, True]) if mode == "nearest" else np.ones(3, bool)
    skip = (9, 14) if mode == "nearest" else (1, 0)
    if mode == "exit":
        o, tl = eo, np.full(n, 1e34, np.float32)
    kw = dict(mode=mode)
    if mode == "exit":
        kw.update(mode_code=code, vol_match=vm)
    if bricks:
        kw.update(bricks_flat=a["bricks"], bricksize=a["bricksize"])
    base = (a["grids"], a["gridsize"], a["inv"], a["fwd"], a["cube_min"], o, d, tl, act, ven)
    with jax.disable_jit():
        want = jdda.traverse(*(jnp.asarray(x) for x in base), jnp.int32(skip[0]),
                             jnp.int32(skip[1]),
                             **{k: jnp.asarray(v) if k != "mode" else v for k, v in kw.items()})
    got = dda.traverse(*(_t(x) for x in base), skip[0], skip[1],
                       **{k: _t(v) if k != "mode" else v for k, v in kw.items()})
    assert set(got) == set(want)
    for k in got:
        g, w = got[k].numpy(), np.asarray(want[k])
        if k == "t":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        elif k in ("nx", "ny", "nz"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    flag = got["in_vol" if mode == "exit" else "hit"]
    assert 0 < int(flag.sum()) < n  # both outcomes occur
