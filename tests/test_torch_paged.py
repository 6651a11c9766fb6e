"""Scenes past 64 volumes: the port's ``paginate_volumes`` and its paged
traversal against the JAX package, on the CPU.

The scenes are the 66-volume random scene of tests/test_paged.py (16^3
grids, seed 5, 3 pages of at most 24 volumes) and the city_xl-layout
stand-in (111 volumes, 5 pages) at 8^3.  Both packages build them from
the same specs, and the traversal tests run on the JAX arrays carried
over with ``scene_from_numpy``, pages included.

On the CPU the port walks such a scene page by page (``_paged_traverse``,
the paged exit).  It is held against the JAX package's walk over all
volumes (``VOXTRACER_PALLAS=0``: ``traverse_occ_topk`` and
``traverse_occ``), run op by op under ``disable_jit`` so that XLA
contracts no multiply-add: hit, vol and material identical, t within
1e-6, normals within 1e-5.  The paged route must also equal the port's
own single walk over all volumes bit for bit, exact ties between copies
of one volume in two pages included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_render import _flatten
from voxtracer.core.types import MAT_NONE
from voxtracer.render import integrator as jax_integrator
from voxtracer.render.camera import make_camera as jax_camera
from voxtracer.scene import instances as jinst
from voxtracer.scene import presets as jax_presets
from voxtracer.scene.materials import default_materials
from voxtracer_torch import cli
from voxtracer_torch.core.rng import make_key
from voxtracer_torch.render import integrator
from voxtracer_torch.scene import instances, presets
from voxtracer_torch.scene.convert import scene_from_numpy

torch.set_num_threads(1)

N = 2048
FIELDS = ("grids", "gridsize", "inv", "fwd", "cube_min", "bricks", "bricksize", "occ")


def _random_specs(nvol=66, gridsize=16, seed=5):
    """tests/test_paged.py::_scene's volumes as keyword dicts."""
    rng = np.random.default_rng(seed)
    specs = []
    for _ in range(nvol):
        g = np.full((gridsize,) * 3, MAT_NONE, np.uint8)
        for _ in range(3):
            lo = rng.integers(0, gridsize - 4, 3)
            hi = lo + rng.integers(2, 8, 3)
            g[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = int(rng.choice([1, 2, 7, 8, 10]))
        specs.append(dict(position=tuple(rng.uniform(-2.0, 2.0, 3)), gridsize=gridsize, grid=g,
                          rotation=tuple(rng.uniform(-0.4, 0.4, 3)),
                          scale=tuple(rng.uniform(0.5, 1.2, 3))))
    return specs


def _city_specs(gridsize=8):
    return [dict(position=s.position, gridsize=s.gridsize, grid=s.grid, rotation=s.rotation,
                 scale=s.scale) for s in presets.city_like_specs(gridsize)]


def _jax_volumes(specs, page=24):
    return jinst.paginate_volumes(jinst.build_volumes([jinst.VolumeSpec(**s) for s in specs]),
                                  page=page)


def _both(specs):
    """(the JAX scene, the same arrays and pages as the port's scene)."""
    cam = jax_camera(pos=(0.0, 0.5, -4.0), target=(0.0, 0.0, 0.0))
    js = jax_presets._assemble(_jax_volumes(specs), default_materials(), camera=cam)
    return jax.tree.map(jnp.asarray, js), scene_from_numpy(_flatten(js), device="cpu")


@pytest.fixture(scope="module")
def scenes():
    return _both(_random_specs())


def _sorted_positions(specs):
    """Each volume's index in `specs` by its place in the paginated order."""
    vols = instances.paginate_volumes(instances.build_volumes(
        [instances.VolumeSpec(**s) for s in specs]), page=24)
    pos = np.asarray([s["position"] for s in specs], np.float32)
    return [np.flatnonzero((pos == c).all(1)).tolist() for c in vols.cube_min.numpy()]


@pytest.fixture(scope="module")
def tie_scenes():
    """The random scene with the last volume of its first page copied over
    a later one: the copy sorts right behind it, into the second page, and
    every hit on one ties exactly with a hit on the other."""
    specs = _random_specs()
    order = _sorted_positions(specs)
    for later in range(40, 66):
        trial = list(specs)
        trial[order[later][0]] = specs[order[23][0]]
        if _sorted_positions(trial)[23:25] == [[order[23][0], order[later][0]]] * 2:
            break
    else:
        raise AssertionError("no copy straddles the first page's end")
    jscene, tscene = _both(trial)
    assert torch.equal(tscene.volumes.inv[23], tscene.volumes.inv[24])
    return jscene, tscene, [23, 24]


def _rays(seed, n=N, scale=1.0):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-2.5, 2.5, (n, 3)) * scale).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unpaged(tscene):
    return dataclasses.replace(tscene, volumes=dataclasses.replace(tscene.volumes, pages=None))


@pytest.mark.parametrize("which", ["random66", "city111"])
def test_paginate_volumes_matches_jax(which):
    specs = _random_specs() if which == "random66" else _city_specs()
    want = _jax_volumes(specs)
    got = instances.paginate_volumes(instances.build_volumes(
        [instances.VolumeSpec(**s) for s in specs]), page=24)
    assert len(got.pages) == len(want.pages) == (3 if which == "random66" else 5)
    assert sorted(p.vol_off for p in got.pages) == list(range(0, got.n, 24))
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)), getattr(got, f).numpy(),
                                      err_msg=f)
    for wp, gp in zip(want.pages, got.pages):  # the walk order too
        assert (wp.vol_off, wp.n) == (gp.vol_off, gp.n)
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(wp, f)), getattr(gp, f).numpy(),
                                          err_msg=f)
    lo, hi = instances.instance_world_aabbs(got)
    jlo, jhi = jinst.instance_world_aabbs(want)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)


def test_paginate_leaves_a_small_set_alone_and_pages_follow_the_device():
    small = instances.build_volumes([instances.VolumeSpec(**s) for s in _random_specs(5)])
    assert instances.paginate_volumes(small, page=24) is small
    vols = instances.paginate_volumes(instances.build_volumes(
        [instances.VolumeSpec(**s) for s in _random_specs(30, 8)]), page=8)
    moved = vols.to("cpu")
    assert [(p.vol_off, p.n) for p in moved.pages] == [(p.vol_off, p.n) for p in vols.pages]
    for p in moved.pages:  # a page is a slice of its parent, sharing its grids
        assert p.grids.data_ptr() == moved.grids[p.vol_off].data_ptr()
        assert torch.equal(p.occ, moved.occ[:, p.vol_off:p.vol_off + p.n])
        assert p.occ.is_contiguous() and p.pages is None


def test_paged_nearest_matches_jax(scenes, monkeypatch):
    jscene, tscene = scenes
    o, d = _rays(11)
    act = np.random.default_rng(1).uniform(size=N) < 0.9
    monkeypatch.setenv("VOXTRACER_PALLAS", "0")
    with jax.disable_jit():
        want = jax_integrator.find_nearest_world(jscene, jnp.asarray(o), jnp.asarray(d),
                                                 jnp.asarray(act))
    assert integrator._pages(tscene, _t(o)) is not None
    got = integrator.find_nearest_world(tscene, _t(o), _t(d), _t(act))
    h = np.asarray(want["hit"])
    assert 100 < h.sum() < N
    for f in ("hit", "vol", "mat"):
        np.testing.assert_array_equal(np.asarray(want[f]), got[f].numpy(), err_msg=f)
    np.testing.assert_allclose(np.asarray(want["t"]), got["t"].numpy(), rtol=1e-6, atol=1e-6)
    for c in ("nx", "ny", "nz"):
        np.testing.assert_allclose(np.asarray(want[c])[h], got[c].numpy()[h], rtol=1e-5,
                                   atol=1e-5)
    # the paged route against the port's own walk over all 66 volumes
    one = integrator.find_nearest_world(_unpaged(tscene), _t(o), _t(d), _t(act))
    for f in got:
        assert torch.equal(got[f], one[f]), f


def test_paged_occluded_matches_jax(scenes, monkeypatch):
    jscene, tscene = scenes
    o, d = _rays(13)
    tl = np.random.default_rng(3).uniform(0.5, 5.0, N).astype(np.float32)
    act = np.random.default_rng(2).uniform(size=N) < 0.9
    monkeypatch.setenv("VOXTRACER_PALLAS", "0")
    with jax.disable_jit():
        want = jax_integrator.is_occluded_world(jscene, jnp.asarray(o), jnp.asarray(d),
                                                jnp.asarray(tl), jnp.asarray(act))
    got = integrator.is_occluded_world(tscene, _t(o), _t(d), _t(tl), _t(act))
    assert 50 < int(got.sum()) < N
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert torch.equal(got, integrator.is_occluded_world(_unpaged(tscene), _t(o), _t(d), _t(tl),
                                                         _t(act)))


def test_paged_exit_matches_jax(scenes, monkeypatch):
    jscene, tscene = scenes
    rng = np.random.default_rng(17)
    o, d = _rays(17)
    vol = rng.integers(0, 66, N).astype(np.int32)
    # three rays in four start inside their own volume's cube
    fwd, cmin = tscene.volumes.fwd.numpy()[vol], tscene.volumes.cube_min.numpy()[vol]
    inside = np.einsum("nij,nj->ni", fwd[:, :3, :3], cmin + rng.uniform(size=(N, 3)))
    inside = (inside + fwd[:, :3, 3]).astype(np.float32)
    o = np.where(rng.uniform(size=(N, 1)) < 0.75, inside, o)
    code = rng.integers(0, 2, N).astype(np.int32)
    mask = rng.uniform(size=N) < 0.9
    monkeypatch.setenv("VOXTRACER_PALLAS", "0")
    with jax.disable_jit():
        w_in, w_t, w_n = jax_integrator.material_exit_world(
            jscene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(vol), jnp.asarray(code),
            jnp.asarray(mask))
    g_in, g_t, g_n = integrator.material_exit_world(tscene, _t(o), _t(d), _t(vol), _t(code),
                                                    _t(mask))
    iv = np.asarray(w_in)
    assert iv.sum() > 20
    np.testing.assert_array_equal(iv, g_in.numpy())
    # an inactive ray's t is its entry t in the one walk, 0 in a page that is
    # not its own: no caller reads it
    np.testing.assert_allclose(np.asarray(w_t)[mask], g_t.numpy()[mask], rtol=1e-6, atol=1e-6)
    for w, g in zip(w_n, g_n):
        np.testing.assert_allclose(np.asarray(w)[iv], g.numpy()[iv], rtol=1e-5, atol=1e-5)
    o_in, o_t, o_n = integrator.material_exit_world(_unpaged(tscene), _t(o), _t(d), _t(vol),
                                                    _t(code), _t(mask))
    assert torch.equal(g_in, o_in) and torch.equal(g_t[_t(mask)], o_t[_t(mask)])
    for g, w in zip(g_n, o_n):
        assert torch.equal(g, w)


def test_cross_page_exact_ties_go_to_the_lower_volume(tie_scenes, monkeypatch):
    jscene, tscene, twins = tie_scenes
    o, d = _rays(19)
    # half of the rays aimed at the copied volume's middle
    mid = np.asarray(tscene.volumes.fwd[twins[0]].numpy() @ np.append(
        tscene.volumes.cube_min[twins[0]].numpy() + 0.5, 1.0))[:3]
    aim = mid + np.random.default_rng(4).uniform(-0.3, 0.3, (N // 2, 3)) - o[:N // 2]
    d[:N // 2] = (aim / np.linalg.norm(aim, axis=1, keepdims=True)).astype(np.float32)
    act = np.ones(N, bool)
    got = integrator.find_nearest_world(tscene, _t(o), _t(d), _t(act))
    one = integrator.find_nearest_world(_unpaged(tscene), _t(o), _t(d), _t(act))
    for f in got:
        assert torch.equal(got[f], one[f]), f
    assert int((got["vol"] == twins[0]).sum()) > 50
    assert not bool(torch.isin(got["vol"], torch.tensor(twins[1:], dtype=torch.int32)).any())
    monkeypatch.setenv("VOXTRACER_PALLAS", "0")
    with jax.disable_jit():
        want = jax_integrator.find_nearest_world(jscene, jnp.asarray(o), jnp.asarray(d),
                                                 jnp.asarray(act))
    for f in ("hit", "vol", "mat"):
        np.testing.assert_array_equal(np.asarray(want[f]), got[f].numpy(), err_msg=f)


def test_paged_traverse_with_disabled_volumes_and_limits(scenes):
    """``_paged_traverse`` itself with volumes switched off and a t limit,
    against one walk over all volumes, in both modes."""
    _, tscene = scenes
    o, d = _rays(23)
    rng = np.random.default_rng(5)
    ven = _t(rng.uniform(size=66) < 0.7)
    tl = _t(np.where(rng.uniform(size=N) < 0.2, np.inf, rng.uniform(0.5, 5.0, N))
            .astype(np.float32))
    act = _t(rng.uniform(size=N) < 0.9)
    v = tscene.volumes
    for mode in ("nearest", "occluded"):
        got = integrator._paged_traverse(tscene, _t(o), _t(d), tl, act, ven, mode)
        want = integrator.traverse(*integrator._vol_args(tscene), _t(o), _t(d), tl, act, ven,
                                   v.occ, v.bricksize, mode=mode)
        assert int(got["hit"].sum()) > 20
        for f in want:
            assert torch.equal(got[f], want[f]), (mode, f)


def test_city_xl_like_preset_builds_and_renders():
    scene, cfg = presets.city_xl_like_path(16, 16, gridsize=8)
    assert scene.volumes.n == 111 and len(scene.volumes.pages) == 5
    assert sum(p.n for p in scene.volumes.pages) == 111
    assert cfg.mode == "path" and cfg.max_bounces == 4 and cfg.bounce_reorder == "auto"
    img = integrator.render_tiled(scene, cfg, make_key(0), 1, 1)
    assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
    assert 0.02 < float(img.mean()) < 10.0
    assert "city_xl_like" in presets.PRESETS


def test_cli_renders_the_city_xl_like_preset(tmp_path):
    """``cli render --preset city_xl_like`` (111 volumes of 64^3, built in
    a few seconds) at 16 x 16, 1 bounce, on the CPU."""
    out = tmp_path / "city.png"
    cli.main(["render", "--preset", "city_xl_like", "--width", "16", "--bounces", "1",
              "--device", "cpu", "--output", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
