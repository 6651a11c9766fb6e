"""The packed scene tables of the port's traversal kernels against the TPU
kernel's, on the CPU.

``voxtracer_torch.kernels.traverse.scene_tables`` packs what the CUDA
kernels of K1-K3 read: the per-volume constants and one brick-occupied
bitmask per occupancy plane.  They must equal what
``voxtracer.kernels.pallas_dda._prep_tables`` (plain jnp, no Pallas call)
packs for the TPU kernel: its ``vtab`` (the first V columns, transposed)
and its ``bm`` (flattened; its padding words are zero), bit for bit.  The
tables are cached per volume set; an in-place edit of a source tensor
must rebuild them, and freeing a source must drop them.  ``traverse``'s
``None`` defaults (no t limit, every
volume enabled) must give what the explicit tensors give.  The world
boxes the kernels cull with must hold every world point of each volume's
cube, as ``inv`` maps it (within 1e-5).
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.core.types import GLASS, MAT_NONE, SMOKE_MID_DENSITY
from voxtracer.kernels.pallas_dda import _prep_tables
from voxtracer.scene.instances import VolumeSpec, build_volumes
from voxtracer_torch.kernels import traverse
from voxtracer_torch.kernels.dda import BIG
from voxtracer_torch.scene.presets import monu_like_path

torch.set_num_threads(1)


def _random_volumes():
    """Four volumes of mixed grid sizes (1, 5, 16 and 32: one to four
    bricks a side) with a few solid boxes of mixed materials, glass and
    smoke included, under random transforms."""
    rng = np.random.default_rng(11)
    specs = []
    for gs in (16, 5, 32, 1):
        g = np.full((gs,) * 3, MAT_NONE, np.uint8)
        for _ in range(3):
            lo = rng.integers(0, max(gs - 2, 1), 3)
            hi = lo + rng.integers(1, max(gs // 2, 2), 3)
            g[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = int(
                rng.choice([1, 7, GLASS, SMOKE_MID_DENSITY]))
        specs.append(VolumeSpec(position=tuple(rng.uniform(-1, 1, 3)), gridsize=gs, grid=g,
                                rotation=tuple(rng.uniform(-0.5, 0.5, 3)),
                                scale=tuple(rng.uniform(0.6, 1.5, 3))))
    v = build_volumes(specs)
    return {f: np.asarray(getattr(v, f)) for f in
            ("grids", "gridsize", "inv", "fwd", "cube_min", "occ", "bricksize")}


def _monu_like():
    scene, _ = monu_like_path(32, 16, gridsize=64)
    v = scene.volumes
    return {f: getattr(v, f).numpy() for f in
            ("grids", "gridsize", "inv", "fwd", "cube_min", "occ", "bricksize")}


SCENES = {"random": _random_volumes, "monu_like": _monu_like}
TABLE_ARGS = ("gridsize", "inv", "fwd", "cube_min", "occ", "bricksize")


@pytest.mark.parametrize("plane", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_tables_match_prep_tables(name, plane):
    a = SCENES[name]()
    v = a["gridsize"].shape[0]
    vtab, bm = traverse.scene_tables(*(torch.from_numpy(a[f]) for f in TABLE_ARGS))
    jv, _, _, _, _, jbm, _ = _prep_tables(*(jnp.asarray(a[f]) for f in TABLE_ARGS), plane)
    assert vtab.shape == (v, traverse.VT) and vtab.dtype == torch.float32
    np.testing.assert_array_equal(vtab.numpy(), np.asarray(jv)[:, :v].T)
    words = bm.shape[1]
    assert words == -(-v * a["occ"].shape[2] // 32) and bm.dtype == torch.int32
    jflat = np.asarray(jbm).reshape(-1)
    np.testing.assert_array_equal(bm[plane].numpy(), jflat[:words])
    assert not jflat[words:].any()
    if plane == 0:  # the scene has occupied and empty bricks
        assert (bm[0] != 0).any() and (bm[0] != -1).any()


def _cpu_volumes():
    scene, _ = monu_like_path(32, 16, gridsize=16)
    v = scene.volumes
    return v, (v.grids.reshape(-1), v.gridsize, v.inv, v.fwd, v.cube_min, v.occ, v.bricksize)


@pytest.mark.parametrize("edit", ["occ", "inv"])
def test_tables_cache_rebuilds_after_in_place_edit(edit):
    vols, args = _cpu_volumes()
    first = traverse.tables(*args)
    assert traverse.tables(*args) is first  # cached
    if edit == "occ":
        vol, brick = torch.nonzero(~(vols.occ[0] != 0).any(-1))[0]
        vols.occ[0, vol, brick, 5] = 1 << 9  # one cell of an empty brick, in place
    else:
        vols.inv[2, 0, 3] += 0.25
    again = traverse.tables(*args)
    assert again is not first
    vtab, bm = traverse.scene_tables(*args[1:])
    assert torch.equal(again.vtab, vtab) and torch.equal(again.bm, bm)
    changed = again.bm if edit == "occ" else again.vtab
    assert not torch.equal(changed, first.bm if edit == "occ" else first.vtab)
    assert traverse.tables(*args) is again


def test_tables_cache_lets_go_of_freed_volumes():
    """The cache holds no source alive: when the volumes are freed, their
    entry goes, and a call through a new view of a live source hits it."""
    before = set(traverse._cache)
    vols, args = _cpu_volumes()
    first = traverse.tables(*args)
    (key,) = set(traverse._cache) - before
    assert traverse.tables(vols.grids.reshape(-1), *args[1:]) is first
    del vols, args, first
    gc.collect()
    assert key not in traverse._cache


@pytest.mark.parametrize("mode", ["nearest", "occluded"])
def test_none_defaults_equal_explicit_tensors(mode):
    vols, args = _cpu_volumes()
    rng = np.random.default_rng(3)
    n = 400
    o = torch.from_numpy(rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    act = torch.from_numpy(rng.uniform(size=n) < 0.9)
    tl = torch.from_numpy(rng.uniform(0.5, 4.0, n).astype(np.float32)) \
        if mode == "occluded" else None
    g, gs, inv, fwd, cmin, occ, bsz = args
    got = traverse.traverse(g, gs, inv, fwd, cmin, o, d, tl, act, None, occ, bsz, mode=mode)
    want = traverse.traverse(g, gs, inv, fwd, cmin, o, d,
                             torch.full((n,), BIG) if tl is None else tl, act,
                             torch.ones(vols.n, dtype=torch.bool), occ, bsz, mode=mode)
    assert got.keys() == want.keys()
    for f in got:
        assert torch.equal(got[f], want[f]), f
    assert 0 < int(got["hit"].sum()) < n


@pytest.mark.parametrize("name", sorted(SCENES))
def test_world_boxes_hold_the_volumes(name):
    """Points of each object-space cube [b, b + 1]^3, taken to world space
    by solving inv (float64), lie in the volume's world box, and the box's
    corners are such points (the box is tight)."""
    a = SCENES[name]()
    inv, cmin = (torch.from_numpy(a[f]) for f in ("inv", "cube_min"))
    box = traverse.world_boxes(inv, cmin).double()
    assert box.shape == (inv.shape[0], 8)
    rng = np.random.default_rng(5)
    obj = torch.from_numpy(rng.uniform(0.0, 1.0, (inv.shape[0], 4096, 3))) + cmin.double()[:, None]
    corners = torch.tensor([[i >> 2 & 1, i >> 1 & 1, i & 1] for i in range(8)],
                           dtype=torch.float64)
    obj = torch.cat([obj, cmin.double()[:, None] + corners[None]], 1)
    m = inv.double()
    world = torch.linalg.solve(m[:, None, :3, :3], (obj - m[:, None, :3, 3])[..., None])[..., 0]
    assert bool((world >= box[:, None, 0:3] - 1e-5).all() and (world <= box[:, None, 3:6] + 1e-5).all())
    ext_lo, ext_hi = world.amin(1), world.amax(1)
    np.testing.assert_allclose(box[:, 0:3].numpy(), ext_lo.numpy(), atol=1e-5)
    np.testing.assert_allclose(box[:, 3:6].numpy(), ext_hi.numpy(), atol=1e-5)
    np.testing.assert_allclose(box[:, 6].numpy(), torch.maximum(ext_lo.abs(), ext_hi.abs())
                               .amax(1).numpy(), atol=1e-5)
