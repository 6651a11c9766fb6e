"""The port's CUDA kernels against their plain PyTorch versions on the card.

Each test builds the kernels (nvcc, csrc/) on first use, launches one on
CUDA tensors and holds it against the plain version on the same tensors:
hit, vol, cell and in_vol identical, t within 1e-6, normals within 1e-5,
lookup rows, the probes' results, the random streams' float bits and
the path bounce's shading kernels' states and frames identical (held to
their plain stages, ``kernels.bounce.PLAIN``), the lookup's backward per entry within
1e-5 * (sum of |ct| over the entry's rows) + 1e-6 (both sides sum with
atomics, in no fixed order), a whole relaxed-march gradient through
the kernels within relative L2 1e-4 of one through the plain versions,
the replay gradients through the kernels within relative L2 1e-4 of
ones through the plain versions (the active replay's image within 1e-5),
and whitted, reproject, thin-lens and capability-replay images through
the kernels with at most 0.1% of pixels off by more than 1e-3 from ones
through the plain versions (whitted's per-pixel scatter-add runs in no
fixed order).  K1 and K2 run
at up to 256 volumes in one launch, held to the plain walk and to the
page-by-page walk of the CPU path; K3 is held on the rays that march (of
the others it returns zeros).
Without a CUDA device every test skips: the
kernels have no CPU mode.  This file imports neither JAX nor the JAX
package, so it runs on a machine with the card and PyTorch alone:

    python -m pytest tests/test_torch_gpu.py -q --noconftest -p no:cacheprovider
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import plain_traversal, plain_versions, same_exit, write_standin_assets
from voxtracer_torch.config import RenderConfig
from voxtracer_torch.game.level import Game
from voxtracer_torch.scene.lights import make_lights
from voxtracer_torch.scene.materials import default_materials
from voxtracer_torch.scene.presets import _assemble
from voxtracer_torch.core.types import GLASS, MAT_NONE, SMOKE_MID_DENSITY, SMOKE_PLAYER
from voxtracer_torch.diff import train, volumetric
from voxtracer_torch.kernels import build, lookup, probes, traverse
from voxtracer_torch.kernels.dda import BIG
from voxtracer_torch.kernels.dda_occ import traverse_occ
from voxtracer_torch.scene.instances import VolumeSpec, build_volumes
from voxtracer_torch.core import rng
from voxtracer_torch.core.rng import fold_in, make_key
from voxtracer_torch.kernels import bounce as bounce_kernel
from voxtracer_torch.kernels import rng as rng_kernel
from voxtracer_torch.render import integrator, reproject
from voxtracer_torch.scene.presets import glass_sphere_box, media_path, monu_like_path

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _scene(rng, nvol, dev, gridsize=32):
    """Volumes of a few solid boxes of mixed materials (glass and smoke
    included) under random transforms, as tensors on dev."""
    specs = []
    for _ in range(nvol):
        g = np.full((gridsize,) * 3, MAT_NONE, np.uint8)
        for _ in range(6):
            lo = rng.integers(0, gridsize - 4, 3)
            hi = lo + rng.integers(2, 12, 3)
            g[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = int(
                rng.choice([1, 2, 7, GLASS, SMOKE_MID_DENSITY, 15]))
        specs.append(VolumeSpec(position=tuple(rng.uniform(-1.2, 1.2, 3)),
                                gridsize=gridsize, grid=g,
                                rotation=tuple(rng.uniform(-0.5, 0.5, 3)),
                                scale=tuple(rng.uniform(0.6, 1.5, 3))))
    v = build_volumes(specs).to(dev)
    return (v.grids.reshape(-1), v.gridsize, v.inv, v.fwd, v.cube_min), v.occ, v.bricksize


def _rays(rng, n, dev, scale=1.0):
    o = (rng.uniform(-2.5, 2.5, (n, 3)) * scale).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def _same(k, p, exact):
    for f in exact:
        assert torch.equal(k[f], p[f].to(k[f].dtype)), f
    assert torch.allclose(k["t"], p["t"], rtol=1e-6, atol=1e-6)
    for c in ("nx", "ny", "nz"):
        assert torch.allclose(k[c], p[c], rtol=1e-5, atol=1e-5), c


@pytest.mark.parametrize("mode", ["nearest", "occluded"])
def test_traverse_kernel_matches_plain(cuda, mode):
    rng = np.random.default_rng(7)
    vargs, occ, bsz = _scene(rng, 4, cuda)
    n = 65536
    o, d = _rays(rng, n, cuda)
    tl = torch.full((n,), BIG, device=cuda) if mode == "nearest" else \
        torch.from_numpy(rng.uniform(0.5, 4.0, n).astype(np.float32)).to(cuda)
    act = torch.from_numpy(rng.uniform(size=n) < 0.9).to(cuda)
    ven = torch.tensor([True, True, False, True], device=cuda)
    before = traverse.launches[f"traverse_{mode}"]
    k = traverse.traverse(*vargs, o, d, tl, act, ven, occ, bsz, mode=mode)
    p = traverse_occ(*vargs, o, d, tl, act, ven, occ, bsz, mode=mode)
    torch.cuda.synchronize()
    assert traverse.launches[f"traverse_{mode}"] == before + 1
    assert 0 < int(k["hit"].sum()) < n
    if mode == "occluded":
        assert torch.equal(k["hit"], p["hit"])
    else:
        _same(k, p, ("hit", "vol", "cell"))


def _edge_scene(rng, nvol, dev, disabled):
    """nvol volumes of 16^3 boxes; the last one a copy of the first (every
    hit on it ties in t with one on volume 0: the earliest volume must
    win); with `disabled`, every third volume between them switched off."""
    specs = []
    for _ in range(nvol):
        g = np.full((16,) * 3, MAT_NONE, np.uint8)
        for _ in range(3):
            lo = rng.integers(0, 12, 3)
            g[lo[0]:lo[0] + rng.integers(2, 8), lo[1]:lo[1] + rng.integers(2, 8),
              lo[2]:lo[2] + rng.integers(2, 8)] = int(rng.choice([1, 2, 7, GLASS]))
        specs.append(VolumeSpec(position=tuple(rng.uniform(-1.5, 1.5, 3)), gridsize=16, grid=g,
                                rotation=tuple(rng.uniform(-0.5, 0.5, 3)),
                                scale=tuple(rng.uniform(0.4, 1.2, 3))))
    if nvol > 1:
        specs[-1] = specs[0]
    v = build_volumes(specs).to(dev)
    ven = torch.ones(nvol, dtype=torch.bool)
    if disabled:
        ven[1:-1:3] = False
    return (v.grids.reshape(-1), v.gridsize, v.inv, v.fwd, v.cube_min), v.occ, v.bricksize, \
        ven.to(dev)


def _edge_rays(rng, n, dev):
    """Random rays, then rays along the axes and in the axis planes (zero
    and -0.0 direction components), rays with NaN directions or origins
    and rays that start inside the volumes."""
    o, d = _rays(rng, n, torch.device("cpu"))
    axes = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
                         [0.6, 0.8, 0], [0, -0.6, 0.8], [0.8, -0.0, -0.6], [-0.0, 1, -0.0]])
    k = 256
    d[:k * len(axes)] = axes.repeat_interleave(k, 0)
    d[-64:-32, 0] = float("nan")
    o[-32:, 1] = float("nan")
    o[-1024:-512] *= 0.2  # near the middle of the scene, often inside a volume
    return o.to(dev), d.to(dev)


@pytest.mark.parametrize("disabled", [False, True])
@pytest.mark.parametrize("nvol", [1, 4, 8, 9, 64, 65, 66, 111, 256])
def test_traverse_kernel_volume_counts_and_edge_rays(cuda, nvol, disabled):
    """K1 and K2 against the plain version at 1 to 256 volumes, in one
    launch at every count (index order; 8 and 9 straddle the count up to
    which the first port's K1 kept its entry list in registers, 64 and 65
    the TPU kernels' and the earlier port's cap): with disabled volumes,
    inactive rays, exact t ties between two volumes, zero-component and NaN
    directions, and t limits of inf (K2)."""
    rng = np.random.default_rng(nvol + 100 * disabled)
    vargs, occ, bsz, ven = _edge_scene(rng, nvol, cuda, disabled)
    n = 16384
    o, d = _edge_rays(rng, n, cuda)
    act = torch.from_numpy(rng.uniform(size=n) < 0.9).to(cuda)
    tl = torch.from_numpy(np.where(rng.uniform(size=n) < 0.1, np.inf,
                                   rng.uniform(0.2, 4.0, n)).astype(np.float32)).to(cuda)
    for mode, limit in (("nearest", None), ("occluded", tl)):
        p = plain_traversal((*vargs, o, d, limit, act, ven, occ, bsz), mode)
        k = traverse.traverse(*vargs, o, d, limit, act, ven, occ, bsz, mode=mode)
        torch.cuda.synchronize()
        if mode == "occluded":
            assert torch.equal(k["hit"], p["hit"])
        else:
            _same(k, p, ("hit", "vol", "cell"))
        assert 0 < int(k["hit"].sum()) < n
    if nvol > 1 and not disabled:  # the copy of volume 0 never wins its ties
        k = traverse.traverse(*vargs, o, d, None, act, ven, occ, bsz)
        assert bool((k["vol"] == 0).any()) and not bool((k["vol"] == nvol - 1).any())


@pytest.mark.parametrize("variant", ["count", "no_normals"])
@pytest.mark.parametrize("where", ["monu_like primary", "66 volumes, edge rays"])
def test_traverse_variants_match_plain(cuda, variant, where):
    """K1's variants against their plain versions: the trip counts
    identical, hit, t, vol, cell and the normals at K1's bars, and hit, t,
    vol and cell equal to K1's own; the no-normals variant's normals zero.
    On the monu_like 512x256 primary rays, and on 66 volumes (ties,
    disabled volumes, zero-component and NaN directions)."""
    rng = np.random.default_rng(13)
    if where == "monu_like primary":
        scene, cfg = monu_like_path(512, 256, bounces=4)
        scene = scene.to(cuda)
        v = scene.volumes
        vargs, occ, bsz, ven = ((v.grids.reshape(-1), v.gridsize, v.inv, v.fwd, v.cube_min),
                                v.occ, v.bricksize, None)
        px, py = integrator._pixel_grid(cfg, cuda)
        o, d = integrator.primary_rays(scene.camera, cfg.width, cfg.height, px, py)
        o = o.contiguous()
        act = torch.ones(o.shape[0], dtype=torch.bool, device=cuda)
    else:
        vargs, occ, bsz, ven = _edge_scene(rng, 66, cuda, True)
        o, d = _edge_rays(rng, 16384, cuda)
        act = torch.from_numpy(rng.uniform(size=16384) < 0.9).to(cuda)
    args = (*vargs, o, d, None, act, ven, occ, bsz)
    kw = dict(count_iters=True) if variant == "count" else dict(ablate=("norm",))
    before = traverse.launches[f"traverse_nearest_{variant}"]
    k = traverse.traverse(*args, **kw)
    torch.cuda.synchronize()
    assert traverse.launches[f"traverse_nearest_{variant}"] == before + 1
    p = traverse.traverse_plain(*args, **kw)
    whole = traverse.traverse(*args)
    _same(k, p, ("hit", "vol", "cell"))
    for f in ("hit", "t", "vol", "cell"):
        assert torch.equal(k[f], whole[f]), f
    assert 0 < int(k["hit"].sum()) < o.shape[0]
    if variant == "count":
        assert torch.equal(k["iters"], p["iters"])
        assert int(k["iters"].max()) > 1 and not bool(k["iters"][~act].any())
    else:
        assert not any(bool(k[c].any()) for c in ("nx", "ny", "nz"))


def test_traverse_takes_none_defaults(cuda):
    """t_limit None (BIG) and vol_enabled None (every volume) give what the
    explicit tensors give, in both modes."""
    rng = np.random.default_rng(65)
    vargs, occ, bsz = _scene(rng, 4, cuda)
    o, d = _rays(rng, 65536, cuda)
    act = torch.from_numpy(rng.uniform(size=65536) < 0.9).to(cuda)
    tl = torch.from_numpy(rng.uniform(0.5, 4.0, 65536).astype(np.float32)).to(cuda)
    ones = torch.ones(4, dtype=torch.bool, device=cuda)
    for mode, limit in (("nearest", None), ("occluded", tl)):
        got = traverse.traverse(*vargs, o, d, limit, act, None, occ, bsz, mode=mode)
        want = traverse.traverse(*vargs, o, d, torch.full((65536,), BIG, device=cuda)
                                 if limit is None else limit, act, ones, occ, bsz, mode=mode)
        torch.cuda.synchronize()
        for f in got:
            assert torch.equal(got[f], want[f]), (mode, f)


def test_traverse_kernels_on_the_captured_path_calls(cuda):
    """K1 and K2 on every call one 1080p path frame makes (primary rays,
    bounces 1-4, the NEE shadow rays), captured as the path passes them."""
    from chip_smoke import captured_traversals

    scene, cfg = monu_like_path(1920, 1080, bounces=4)
    scene = scene.to(cuda)
    calls = []
    with captured_traversals(calls):
        integrator.render_tiled(scene, cfg, make_key(0), 1, 1)
    assert [m for m, _ in calls].count("occluded") == [m for m, _ in calls].count("nearest") == 5
    for mode, args in calls:
        k = traverse.traverse(*args, mode=mode)
        p = traverse.traverse_plain(*args, mode=mode)
        torch.cuda.synchronize()
        if mode == "occluded":
            assert torch.equal(k["hit"], p["hit"])
        else:
            _same(k, p, ("hit", "vol", "cell"))


def test_exit_kernel_matches_plain(cuda):
    rng = np.random.default_rng(8)
    vargs, occ, bsz = _scene(rng, 3, cuda)
    n = 65536
    o, d = _rays(rng, n, cuda, scale=0.4)
    vol = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(cuda)
    code = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(cuda)
    act = torch.from_numpy(rng.uniform(size=n) < 0.8).to(cuda)
    vol[:64] = torch.tensor([-1, 3, 7, -2], dtype=torch.int32, device=cuda).repeat(16)  # no volume
    k = traverse.exit_march(*vargs, o, d, act, code, vol, occ, bsz)
    p = traverse.exit_march_plain(*vargs, o, d, act, code, vol, occ, bsz)
    torch.cuda.synchronize()
    assert int(k["in_vol"].sum()) > 0
    same_exit(k, p, act, "K3")


def test_exit_kernel_on_the_captured_path_calls(cuda):
    """K3 on every exit call of a whitted 256^2 glassbox frame and of the
    media 128^2 path and reproject frames, as the renderers pass them."""
    from chip_smoke import captured_traversals

    calls = []
    with captured_traversals(calls):
        scene, cfg = glass_sphere_box(256, 256)
        integrator.render_tiled(scene.to(cuda), cfg, make_key(0), 1, 1)
        scene, cfg = media_path(128, 128)
        scene = scene.to(cuda)
        integrator.render_tiled(scene, cfg, make_key(0), 1, 1)
        rcfg = dataclasses.replace(cfg, mode="reproject")
        hist = torch.zeros((128, 128, 3), device=cuda)
        for i in range(2):
            _, hist, _ = reproject.render_reproject_frame(scene, rcfg, scene.camera, hist,
                                                          fold_in(make_key(0), i))
    exits = [args for mode, args in calls if mode == "exit"]
    assert len(exits) >= 6
    for args in exits:
        k = traverse.exit_march(*args)
        p = traverse.exit_march_plain(*args)
        torch.cuda.synchronize()
        assert bool(args[7].any())
        same_exit(k, p, args[7], "K3")


def _city(cuda, gridsize=16):
    from voxtracer_torch.scene.presets import city_xl_like_path

    scene, cfg = city_xl_like_path(256, 128, gridsize=gridsize)
    return scene.to(cuda), cfg


def test_111_volume_frame_calls_match_plain_and_the_paged_walk(cuda):
    """Every K1 and K2 call of a 256 x 128 frame of the 111-volume city
    layout (16^3 grids): one launch over all volumes against the plain walk
    in ray chunks, and against the page-by-page walk the CPU path takes
    (a launch a page here), bit for bit."""
    from chip_smoke import captured_traversals

    scene, cfg = _city(cuda)
    assert scene.volumes.n == 111 and integrator._pages(scene, scene.volumes.inv) is None
    calls = []
    with captured_traversals(calls):
        integrator.render_tiled(scene, cfg, make_key(0), 1, 1)
    modes = [m for m, _ in calls]
    assert modes.count("nearest") == 5 and modes.count("occluded") == 5
    for mode, args in calls:
        k = traverse.traverse(*args, mode=mode)
        p = plain_traversal(args, mode)
        g = integrator._paged_traverse(scene, args[5], args[6], args[7], args[8], None, mode)
        torch.cuda.synchronize()
        if mode == "occluded":
            assert torch.equal(k["hit"], p["hit"]) and torch.equal(k["hit"], g["hit"])
        else:
            _same(k, p, ("hit", "vol", "cell"))
            for f in k:
                assert torch.equal(k[f], g[f]), f


def test_cross_page_tie_on_the_card(cuda):
    """Two copies of one volume on both sides of a page boundary: the one
    launch and the paged walk both give every tie to the lower volume."""
    rng = np.random.default_rng(31)
    specs = []
    for i in range(70):
        g = np.full((16,) * 3, MAT_NONE, np.uint8)
        lo = rng.integers(0, 10, 3)
        g[lo[0]:lo[0] + 5, lo[1]:lo[1] + 5, lo[2]:lo[2] + 5] = int(rng.choice([1, 2, 7]))
        specs.append(VolumeSpec(position=tuple(rng.uniform(-1.5, 1.5, 3)), gridsize=16, grid=g,
                                rotation=tuple(rng.uniform(-0.5, 0.5, 3)),
                                scale=tuple(rng.uniform(0.6, 1.2, 3))))
    specs[24] = specs[23]  # build order is kept: pages cut at 24 below
    vols = build_volumes(specs).with_pages([(24, 48), (0, 24), (48, 70)]).to(cuda)
    scene = dataclasses.replace(glass_sphere_box(8, 8)[0].to(cuda), volumes=vols)
    n = 32768
    o, d = _rays(rng, n, cuda)
    mid = vols.fwd[23] @ torch.cat([vols.cube_min[23] + 0.5, torch.ones(1, device=cuda)])
    aim = mid[:3] + (torch.rand((n // 2, 3), device=cuda) - 0.5) * 0.6 - o[:n // 2]
    d[:n // 2] = aim / aim.norm(dim=1, keepdim=True)
    act = torch.ones(n, dtype=torch.bool, device=cuda)
    k = traverse.traverse(*integrator._vol_args(scene), o, d, None, act, None, vols.occ,
                          vols.bricksize)
    g = integrator._paged_traverse(scene, o, d, None, act, None, "nearest")
    p = plain_traversal((*integrator._vol_args(scene), o, d, None, act, None, vols.occ,
                         vols.bricksize), "nearest")
    torch.cuda.synchronize()
    _same(k, p, ("hit", "vol", "cell"))
    for f in k:
        assert torch.equal(k[f], g[f]), f
    assert int((k["vol"] == 23).sum()) > 100 and not bool((k["vol"] == 24).any())


def test_111_volume_frame_kernels_match_plain(cuda):
    """A 128 x 64 frame of the city layout, 4 bounces, kernels against
    plain versions: as the preset renders it (no reorder below "auto"'s ray
    count) to the image gate; with the reorder forced on to at most 1% of
    pixels, since one ulp in a bounce origin can move a ray across a sort
    cell and reassign the samples of the lanes in between."""
    scene, cfg = _city(cuda)
    cfg = dataclasses.replace(cfg, width=128, height=64)
    for reorder, gate in (("auto", 1e-3), ("always", 1e-2)):
        c = dataclasses.replace(cfg, bounce_reorder=reorder)
        before = dict(traverse.launches, **lookup.launches)
        a = integrator.render_tiled(scene, c, make_key(0), 1, 1)
        after = dict(traverse.launches, **lookup.launches)
        for name in ("traverse_nearest", "traverse_occluded", "lookup_rows"):
            assert after[name] > before[name], name
        with plain_versions():
            b = integrator.render_tiled(scene, c, make_key(0), 1, 1)
        assert bool(torch.isfinite(a).all()) and float(a.mean()) > 0.02
        assert float(((a - b).abs().amax(-1) > 1e-3).float().mean()) <= gate, reorder


def test_lookup_kernel_matches_plain(cuda):
    rng = np.random.default_rng(9)
    tab = torch.from_numpy(rng.uniform(size=(256, 6)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(-40, 300, 100_003).astype(np.int32)).to(cuda)
    k = lookup.lookup_rows(tab, idx)
    torch.cuda.synchronize()
    assert torch.equal(k, lookup.lookup_rows_plain(tab, idx))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    rng = np.random.default_rng(10)
    vargs, occ, bsz = _scene(rng, 2, cuda)
    o, d = _rays(rng, 128, cuda)
    tl = torch.full((128,), BIG, device=cuda)
    act = torch.ones(128, dtype=torch.bool, device=cuda)
    ven = torch.ones(2, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        traverse.traverse(*vargs, o.double(), d, tl, act, ven, occ, bsz)
    with pytest.raises(ValueError):
        traverse.traverse(*vargs, o.t().contiguous().t(), d, tl, act, ven, occ, bsz)
    with pytest.raises(ValueError):
        traverse.traverse(*vargs, o, d, tl.cpu(), act, ven, occ, bsz)
    tab = torch.zeros((256, 6), device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    for bad in ((tab, torch.zeros(4, device=cuda)), (tab, idx[None]),
                (tab, torch.zeros(8, dtype=torch.int32, device=cuda)[::2]),
                (tab.double(), idx), (tab.cpu(), idx), (tab.t(), idx),
                (torch.zeros((4, 64), device=cuda), idx)):  # 64 floats a row: slabs past a block
        with pytest.raises(ValueError):
            lookup.lookup_rows(*bad)
    ct = torch.zeros((4, 3), device=cuda)
    for bad, kw in (((ct.double(), idx, 256), {}), ((ct, idx.long(), 256), {}),
                    ((ct, idx[:3], 256), {}), ((ct.t().contiguous().t(), idx, 256), {}),
                    ((ct, idx.cpu(), 256), {}), ((ct, idx, 0), {}),
                    ((ct, idx, 256), {"acc": "global"}),
                    ((ct[:, :1].contiguous(), idx, 64 * 1024), {"acc": "shared"})):
        with pytest.raises(ValueError):
            lookup.lookup_rows_bwd(*bad, **kw)


def _hold_bwd(ct, idx, k, acc=None):
    got = lookup.lookup_rows_bwd(ct, idx, k, acc=acc)
    want = lookup.lookup_rows_bwd_plain(ct, idx, k)
    bound = 1e-5 * lookup.lookup_rows_bwd_plain(ct.abs(), idx, k) + 1e-6
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= bound).all())
    assert float(want.abs().max()) > 0 or not bool(ct.any())
    return got


def _ids(rng, n, k, spread, offset, dev):
    """n int32 ids for a [k, .] table as a view at storage offset `offset`:
    all on one entry, on a few (the albedo rows' pattern, out-of-range ones
    included), or spread over the table and past both ends."""
    if spread == "one":
        ids = np.full(n + offset, k // 3)
    elif spread == "few":
        ids = rng.choice([-5, 0, 2, 7, k - 1, k + 9], n + offset, p=[.05, .1, .1, .15, .55, .05])
    else:
        ids = rng.integers(-8, k + 8, n + offset)
    return torch.from_numpy(ids.astype(np.int32)).to(dev)[offset:]


@pytest.mark.parametrize("c", [1, 3, 5, 6, 7, 16])
def test_lookup_kernel_widths_offsets_and_sizes(cuda, c):
    """K4 at the path's widths 1, 3, 5, 6 and the generic ones 7 and 16, with
    ids at storage offsets 0-3 (a misaligned head for the 16-byte loads),
    n from 0 to a ragged 100,003, and a NaN row: bit for bit."""
    rng = np.random.default_rng(c)
    tab_np = rng.uniform(-1, 1, (256, c)).astype(np.float32)
    tab_np[7] = np.nan
    tab = torch.from_numpy(tab_np).to(cuda)
    for offset in (0, 1, 2, 3):
        for n in (0, 1, 31, 33, 127, 129, 1027, 100_003):
            for spread in ("few", "spread"):
                idx = _ids(rng, n, 256, spread, offset, cuda)
                assert idx.storage_offset() == offset
                got = lookup.lookup_rows(tab, idx)
                torch.cuda.synchronize()
                want = lookup.lookup_rows_plain(tab, idx)
                assert got.shape == (n, c)
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (offset, n)


@pytest.mark.parametrize("acc", ["shared", "direct", None])
@pytest.mark.parametrize("c", [1, 3, 5, 6, 7, 16])
def test_lookup_bwd_widths_accumulators_and_contention(cuda, c, acc):
    """K4-bwd with each accumulator forced (and the plan's), at the path's
    widths and generic ones, ids all on one entry (the worst contention), on
    a few and spread, offsets 0-3, n from 0 to 200,003, with and without
    rows of zeros (most of the brick-sigma rows are; -0.0 among them).  A
    forced shared accumulator whose 8 warp copies do not fit a block is
    refused."""
    rng = np.random.default_rng(100 + c)
    for k in (256, 2048):
        if acc == "shared" and 32 * k * c > lookup.smem_limit(cuda):
            with pytest.raises(ValueError):
                lookup.lookup_rows_bwd(torch.zeros((4, c), device=cuda),
                                       torch.zeros(4, dtype=torch.int32, device=cuda), k, acc)
            continue
        for offset, n in ((0, 0), (1, 1), (2, 31), (3, 33), (0, 1027), (1, 200_003)):
            for spread in ("one", "few", "spread"):
                for zeros in (0.0, 0.9):
                    idx = _ids(rng, n, k, spread, offset, cuda)
                    ct_np = rng.normal(size=(n, c)).astype(np.float32)
                    ct_np[rng.uniform(size=n) < zeros] = 0.0
                    ct_np[rng.uniform(size=n) < zeros / 10] = -0.0
                    ct = torch.from_numpy(ct_np).to(cuda)
                    got = _hold_bwd(ct, idx, k, acc)
                    assert got.shape == (k, c)


def test_lookup_bwd_holds_one_signed_rows_at_the_albedo_shape(cuda):
    """2,918,400 albedo rows of one sign (the march's are: its loss pulls
    every pixel the same way), most on one id: the plan's accumulator adds
    each entry's global sum in a short chain of f32 adds."""
    rng = np.random.default_rng(6)
    n, k = 2_918_400, 256
    assert lookup.bwd_plan(n, k, 3, torch.cuda.get_device_properties(cuda).multi_processor_count
                           )[0] == "shared"
    idx = _ids(rng, n, k, "few", 0, cuda)
    ct = torch.from_numpy(rng.uniform(0.5, 1.5, (n, 3)).astype(np.float32)).to(cuda)
    _hold_bwd(ct, idx, k)


@pytest.mark.parametrize("bricks", [1, 4, 37])
def test_lookup_bwd_holds_one_signed_concentrated_rows_at_the_brick_shape(cuda, bricks):
    """2,918,400 brick-sigma rows ([2048, 1]) of one sign on 1, 4 or 37
    bricks: tens of thousands of rows an entry, whatever accumulator the
    plan picks for the shape."""
    rng = np.random.default_rng(60 + bricks)
    n, k = 2_918_400, 2048
    ids = rng.choice(rng.choice(k, bricks, replace=False), n)
    idx = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    for lo, hi in ((0.5, 1.5), (1e-3, 1.0)):
        ct = torch.from_numpy(rng.uniform(lo, hi, (n, 1)).astype(np.float32)).to(cuda)
        _hold_bwd(ct, idx, k)
        _hold_bwd(-ct, idx, k)


def test_lookup_bwd_holds_one_signed_rows_at_the_gradient_s_brick_ids(cuda):
    """The largest brick-sigma cotangent of one 1080p binned gradient, its
    ids as the march makes them, its zero rows replaced by one-signed
    values (the march's own are 98% zeros)."""
    from chip_smoke import captured_lookups

    scene, cfg = monu_like_path(1920, 1080, bounces=4)
    scene = scene.to(cuda)
    params = volumetric.params_from_scene(scene)
    plan = train.prepare_bins(scene, cfg, torch.zeros((1080, 1920, 3), device=cuda),
                              bin_steps=(2, 10), edges=(4.0,), tiles=2, span_steps=1)
    calls = {}
    with captured_lookups(calls):
        train.binned_grads(params, scene, plan)
    k = scene.volumes.n * scene.volumes.occ.shape[2]
    ct, idx, kk = calls[("bwd", k, 1)]
    assert kk == k == 2048 and idx.shape[0] > 100_000
    gen = torch.Generator(device=cuda).manual_seed(7)
    fill = torch.rand(ct.shape, generator=gen, device=cuda) + 0.5
    _hold_bwd(torch.where(ct == 0, fill, ct.abs()), idx, k)
    _hold_bwd(ct, idx, k)


@pytest.mark.parametrize("acc", ["shared", "direct"])
def test_lookup_bwd_nan_cotangent_reaches_its_entry(cuda, acc):
    rng = np.random.default_rng(5)
    n, k = 50_000, 256
    idx = _ids(rng, n, k, "few", 0, cuda)
    ct = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(cuda)
    ct[1234, 1] = float("nan")
    got = lookup.lookup_rows_bwd(ct, idx, k, acc=acc)
    want = lookup.lookup_rows_bwd_plain(ct, idx, k)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[int(idx[1234].clamp(0, k - 1)), 1]))
    ok = ~torch.isnan(want)
    bound = 1e-5 * lookup.lookup_rows_bwd_plain(ct.abs(), idx, k) + 1e-6
    assert bool(((got - want).abs()[ok] <= bound[ok]).all())


@pytest.mark.parametrize("k,c,lo,hi", [(256, 3, 0, 16), (256, 3, -8, 264), (2048, 1, -8, 2056)])
def test_lookup_bwd_kernel_matches_plain(cuda, k, c, lo, hi):
    """Albedo rows (few distinct ids, as the march's material column gives
    them, then out-of-range ids) and brick-sigma rows."""
    gen = torch.Generator(device=cuda).manual_seed(k + lo)
    n = 1_000_003
    idx = torch.randint(lo, hi, (n,), generator=gen, device=cuda, dtype=torch.int32)
    ct = torch.randn((n, c), generator=gen, device=cuda)
    before = lookup.launches["lookup_rows_bwd"]
    _hold_bwd(ct, idx, k)
    assert lookup.launches["lookup_rows_bwd"] == before + 1


def test_lookup_takes_tables_past_48kb(cuda):
    """The brick-sigma table of 64 volumes of 64^3 ([64 * 512, 1] f32,
    128 KB, read through L1) and a 1M-entry one, then the backward's
    shared accumulator at the device's shared-memory opt-in limit (8 warp
    copies of the table a block) and one entry past it."""
    k_bwd = lookup.smem_limit(cuda) // (4 * lookup.THREADS // 32)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for k in (k_bwd, 64 * 512, 1 << 20):
        tab = torch.rand((k, 1), generator=gen, device=cuda)
        idx = torch.randint(-8, k + 8, (300_007,), generator=gen, device=cuda, dtype=torch.int32)
        assert torch.equal(lookup.lookup_rows(tab, idx), lookup.lookup_rows_plain(tab, idx))
        ct = torch.randn((idx.shape[0], 1), generator=gen, device=cuda)
        for acc in ("shared", "direct") if k <= k_bwd else ("direct",):
            _hold_bwd(ct, idx, k, acc)
        if k > k_bwd:
            with pytest.raises(ValueError):
                lookup.lookup_rows_bwd(ct, idx, k, acc="shared")


def test_gradient_kernels_match_plain(cuda):
    """One binned gradient (the bench's (2,10)-step bins at edge 4, 2 bands)
    and one render_diff image at 64x32, through the kernels and through
    their plain versions."""
    scene, cfg = monu_like_path(64, 32, gridsize=64)
    scene = scene.to(cuda)
    params = volumetric.params_from_scene(scene)
    plan = train.prepare_bins(scene, cfg, torch.zeros((32, 64, 3), device=cuda))

    def run():
        _, g = train.binned_grads(params, scene, plan)
        img = volumetric.render_diff(params, scene, cfg, 10, k=plan.k, span_steps=1)
        return g, img

    before = dict(traverse.launches, **lookup.launches)
    ga, ia = run()
    after = dict(traverse.launches, **lookup.launches)
    for name in ("traverse_nearest", "lookup_rows", "lookup_rows_bwd"):
        assert after[name] > before[name], name
    with plain_versions():
        gb, ib = run()
    for f in ("density_logits", "albedo_table"):
        a, b = getattr(ga, f), getattr(gb, f)
        assert float(b.abs().max()) > 0
        assert float((a - b).norm() / b.norm()) <= 1e-4, f
    assert float((ia - ib).abs().max()) <= 1e-5


def _kernels_vs_plain(run):
    """run() through the kernels, then through the plain versions swapped
    into the port's bindings; every kernel must have launched."""
    before = dict(traverse.launches, **lookup.launches)
    a = run()
    after = dict(traverse.launches, **lookup.launches)
    with plain_versions():
        b = run()
    for name in ("traverse_nearest", "traverse_occluded", "exit_march", "lookup_rows"):
        assert after[name] > before[name], name
    for x, y in zip(a, b):
        assert bool(torch.isfinite(x).all())
        assert float(((x - y).abs().amax(-1) > 1e-3).float().mean()) <= 1e-3
    return a


def test_whitted_kernels_match_plain(cuda):
    scene, cfg = glass_sphere_box(128, 64)
    scene = scene.to(cuda)
    (img,) = _kernels_vs_plain(lambda: (integrator.render_tiled(scene, cfg, make_key(0), 1, 1),))
    assert float(img.mean()) > 0.01


def test_reproject_kernels_match_plain(cuda):
    """Two media frames: the first fills the history, the second blends."""
    scene, cfg = media_path(128, 64, bounces=3)
    scene = scene.to(cuda)
    cfg = dataclasses.replace(cfg, mode="reproject")

    def run():
        h = torch.zeros((64, 128, 3), device=cuda)
        _, h, _ = reproject.render_reproject_frame(scene, cfg, scene.camera, h, make_key(0))
        img, h, _ = reproject.render_reproject_frame(scene, cfg, scene.camera, h,
                                                     fold_in(make_key(0), 1))
        return img, h

    img, _ = _kernels_vs_plain(run)
    assert 0.01 < float(img.mean()) < 1.0


def test_replay_lookups_hold_at_every_shape_of_a_replay_step(cuda):
    """K4 and K4-bwd on every distinct call shape of one active replay
    gradient of the 512x288 monu-like frame (64^3 volumes, the bench's
    bins): the albedo rows at n_c and the brick-sigma rows at each bin's
    segment count.  A brick-sigma cotangent that is all zero in the step
    (no lead or tail sample in a grid) gives zeros, and is held on normal
    rows at the same ids."""
    from chip_smoke import captured_lookups
    from voxtracer_torch.diff import replay_active

    scene, cfg = monu_like_path(512, 288, gridsize=64)
    scene = scene.to(cuda)
    pre = replay_active.replay_precompute(scene, cfg, make_key(0))
    grad_fn, _ = replay_active.make_replay_grad_fn(
        scene, cfg, pre, torch.zeros((pre["n_c"], 3), device=cuda), float(512 * 288 * 3))
    calls = {}
    with captured_lookups(calls, every_n=True):
        grad_fn(volumetric.params_from_scene(scene))
    k_b = scene.volumes.n * scene.volumes.occ.shape[2]
    assert ("fwd", pre["n_c"], 256, 3) in calls and ("bwd", pre["n_c"], 256, 3) in calls
    assert sum(key[2] == k_b for key in calls) >= 4
    gen = torch.Generator(device=cuda).manual_seed(8)
    for key, args in calls.items():
        if key[0] == "fwd":
            tab, idx = args
            assert torch.equal(lookup.lookup_rows(tab, idx), lookup.lookup_rows_plain(tab, idx))
            continue
        ct, idx, k = args
        _hold_bwd(ct, idx, k)
        _hold_bwd(torch.randn(ct.shape, generator=gen, device=cuda), idx, k)


def test_replay_gradients_kernels_match_plain(cuda):
    """The active replay's gradient and image at 128x72 on one precompute,
    and the capability replay's (glass and smoke chains: the exit march)
    on the media scene at 64x64, through the kernels and through their
    plain versions."""
    from voxtracer_torch.diff import path_replay, replay_active

    scene, cfg = monu_like_path(128, 72, gridsize=64)
    scene = scene.to(cuda)
    params = volumetric.params_from_scene(scene)
    pre = replay_active.replay_precompute(scene, cfg, make_key(0))
    grad_fn, _ = replay_active.make_replay_grad_fn(
        scene, cfg, pre, torch.zeros((pre["n_c"], 3), device=cuda), float(128 * 72 * 3))
    mscene, mcfg = media_path(64, 64)
    mscene = mscene.to(cuda)
    mparams = volumetric.params_from_scene(mscene, occupied_logit=0.5)
    vg = volumetric.value_and_grad(path_replay.mse_loss_replay)
    target = torch.zeros((64, 64, 3), device=cuda)

    def run():
        with torch.no_grad():
            img = replay_active.render_replay_active(params, scene, cfg,
                                                     *replay_active.split_pre(pre))
            mimg = path_replay.render_diff_replay(mparams, mscene, mcfg, make_key(0))
        return grad_fn(params), img, vg(mparams, mscene, mcfg, target, make_key(0))[1], mimg

    before = dict(traverse.launches, **lookup.launches)
    ga, ia, mga, mia = run()
    after = dict(traverse.launches, **lookup.launches)
    for name in ("traverse_nearest", "exit_march", "lookup_rows", "lookup_rows_bwd"):
        assert after[name] > before[name], name
    with plain_versions():
        gb, ib, mgb, mib = run()
    for a_, b_ in ((ga, gb), (mga, mgb)):
        for f in ("density_logits", "albedo_table"):
            a, b = getattr(a_, f), getattr(b_, f)
            assert float(b.abs().max()) > 0
            assert float((a - b).norm() / b.norm()) <= 1e-4, f
    assert float((ia - ib).abs().max()) <= 1e-5
    assert float(((mia - mib).abs().amax(-1) > 1e-3).float().mean()) <= 1e-3


def test_replay_brick_lead_and_tail_kernels_match_plain(cuda):
    """The active replay on the scene of tests/test_torch_replay_active.py's
    lead and tail test at 128x128 (the camera and light inside the empty
    bricks of a grid, unsaturated logits), where the brick-sigma rows carry
    non-zero cotangents: K4-bwd on each of its brick-sigma calls, then the
    gradient and image through the kernels and through their plain
    versions."""
    from chip_smoke import captured_lookups
    from voxtracer_torch.config import RenderConfig
    from voxtracer_torch.diff import replay_active
    from voxtracer_torch.render.camera import make_camera
    from voxtracer_torch.scene.lights import make_lights
    from voxtracer_torch.scene.materials import default_materials
    from voxtracer_torch.scene.presets import _assemble

    grid = np.full((32, 32, 32), MAT_NONE, np.uint8)
    grid[:, :, 24:] = 7
    scene = _assemble(
        build_volumes([VolumeSpec(position=(-1.0, 0.0, 0.0), gridsize=8,
                                  grid=np.full((8, 8, 8), 7, np.uint8)),
                       VolumeSpec(position=(0.0, 0.0, 0.0), gridsize=32, grid=grid)]),
        default_materials(), lights=make_lights(point=((0.5, 0.8, 0.3, 2.0, 2.0, 2.0),)),
        camera=make_camera(pos=(0.5, 0.45, 0.05), target=(0.5, 0.5, 1.0), aspect=1.0)).to(cuda)
    cfg = RenderConfig(width=128, height=128, mode="path", max_bounces=4)
    params = volumetric.params_from_scene(scene, occupied_logit=0.5, empty_logit=-4.0)
    pre = replay_active.replay_precompute(scene, cfg, make_key(0))
    grad_fn, _ = replay_active.make_replay_grad_fn(
        scene, cfg, pre, torch.zeros((pre["n_c"], 3), device=cuda), float(128 * 128 * 3))
    calls = {}
    with captured_lookups(calls, every_n=True):
        ga = grad_fn(params)
    k_b = scene.volumes.n * scene.volumes.occ.shape[2]
    bsig = [args for key, args in calls.items() if key[0] == "bwd" and key[2] == k_b]
    assert len(bsig) >= 2 and all(bool(ct.any()) for ct, _, _ in bsig)
    for ct, idx, k in bsig:
        _hold_bwd(ct, idx, k)
    assert float(ga.density_logits[1, :, :, :24].abs().max()) > 0

    def run():
        with torch.no_grad():
            img = replay_active.render_replay_active(params, scene, cfg,
                                                     *replay_active.split_pre(pre))
        return grad_fn(params), img

    ga, ia = run()
    with plain_versions():
        gb, ib = run()
    for f in ("density_logits", "albedo_table"):
        a, b = getattr(ga, f), getattr(gb, f)
        assert float((a - b).norm() / b.norm()) <= 1e-4, f
    assert float((ia - ib).abs().max()) <= 1e-5


def test_dof_frame_kernels_match_plain(cuda):
    """A thin-lens media frame (use_dof, focused at 1.5, lens radius 3)."""
    scene, cfg = media_path(128, 64, bounces=3)
    cam = dataclasses.replace(scene.camera, focal_distance=torch.tensor(1.5),
                              defocus_jitter=torch.tensor(3.0))
    scene = dataclasses.replace(scene, camera=cam).to(cuda)
    cfg = dataclasses.replace(cfg, use_dof=True)
    (img,) = _kernels_vs_plain(lambda: (integrator.render_tiled(scene, cfg, make_key(0), 1, 1),))
    assert 0.01 < float(img.mean()) < 10.0


@pytest.fixture(scope="module")
def standins(tmp_path_factory):
    """The stand-in .vox files of chip_smoke.write_standin_assets."""
    d = tmp_path_factory.mktemp("vox")
    write_standin_assets(str(d), 0)
    return d


def test_game_frame_kernels_match_plain(cuda, standins):
    """render_game_frame of the game's first zone and of its second (area
    light, emissive sphere, the monu2 copies), light kill on: images and
    flags through the kernels and the plain versions agree."""
    game = Game(seed=0, asset_dir=str(standins))
    cfg = RenderConfig(width=128, height=106, mode="path", max_bounces=3,
                       detect_light_kill=True)

    def fake_probe(o, d, dist):
        point = np.array([0.0, 0.0, game.state.trigger_checkpoint - 1.0], np.float32)
        return 1, 1.0, point, np.array([0.0, 1.0, 0.0], np.float32)

    for chunk in (0, 1):
        if chunk:
            game.tick(0.016, "w", fake_probe)
        scene = game.build_scene(cfg.width, cfg.height, cuda)
        (img,) = _kernels_vs_plain(
            lambda: (integrator.render_game_frame(scene, cfg, make_key(chunk))[0],))
        lit = integrator.render_game_frame(scene, cfg, make_key(chunk))[1]
        with plain_versions():
            plit = integrator.render_game_frame(scene, cfg, make_key(chunk))[1]
        assert bool(lit) == bool(plit)
        assert 0.01 < float(img.mean()) < 10.0


@pytest.mark.parametrize("colour,flag", [(500.0, True), (1e-4, False)])
def test_light_kill_flag_on_the_card(cuda, colour, flag):
    """tests/test_game.py's lit and dark player-smoke scenes: the flag is
    set exactly when the light is bright, through the kernels and the
    plain versions."""
    vols = build_volumes([VolumeSpec(position=(0, 0, 0), gridsize=4,
                                     grid=np.full((4, 4, 4), SMOKE_PLAYER, np.uint8))])
    mats = default_materials()
    mats.albedo[SMOKE_PLAYER] = torch.tensor([1.0, 0.7, 1.0])
    scene = _assemble(vols, mats, make_lights(point=((0.0, 0.0, -1.2) + (colour,) * 3,)))
    scene = scene.to(cuda)
    cfg = RenderConfig(width=16, height=16, mode="path", max_bounces=2,
                       detect_light_kill=True, activate_sky=False)
    assert bool(integrator.render_game_frame(scene, cfg, make_key(0))[1]) == flag
    with plain_versions():
        assert bool(integrator.render_game_frame(scene, cfg, make_key(0))[1]) == flag


def test_skip_range_probe_on_the_card(cuda, standins):
    """The game probe's plain-torch walk on CUDA tensors equals the same
    walk on the CPU, ray for ray."""
    game = Game(seed=0, asset_dir=str(standins))
    rng = np.random.default_rng(3)
    o = rng.uniform(-3.0, 3.0, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    out = []
    for dev in (cuda, torch.device("cpu")):
        scene = game.build_scene(64, 53, dev)
        out.append(integrator.find_nearest_world(
            scene, torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
            torch.ones(512, dtype=torch.bool, device=dev), skip_lo=9, skip_hi=14,
            skip_first=True))
    a, b = out
    for f in ("hit", "vol", "mat"):
        assert torch.equal(a[f].cpu(), b[f]), f
    assert int(a["hit"].sum()) > 50
    for f in ("t", "nx", "ny", "nz"):
        assert torch.allclose(a[f].cpu(), b[f], rtol=1e-6, atol=1e-6), f


def _probe_inputs(rng, b, dev):
    def wide(shape):
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, shape).astype(np.int32)).to(dev)

    far = rng.uniform(size=(b, 128)) < 0.25
    y = np.where(far, rng.uniform(-1e9, 2e9, (b, 128)), rng.uniform(-100, 100, (b, 128)))
    return {"lane_gather": (wide((b, 128)), wide((b, 128))),
            "chain_gather": (wide((16, 128)), wide((b, 128))),
            "alu_loop": (wide((b, 128)), torch.from_numpy(y.astype(np.float32)).to(dev))}


@pytest.mark.parametrize("iters", [0, 1, 5, 64, 4099])
@pytest.mark.parametrize("b", [1, 32, 133, 256, 1024, 1057])
def test_probe_kernels_match_plain(cuda, b, iters):
    """P1, P3 and P4 over random int32 tables and indices (and far and near
    floats for P4): loop counts on both sides of the 4-step unroll, and row
    counts on both sides of P1's and P4's switch between their two forms of
    the step (B = 1024 takes the few-ops forms), each counted as its form.
    On 132 SMs, P3 packs B = 133 as 67 blocks of 2 rows (the last holds
    one) and B = 1057 as 133 blocks of 8 (the last holds one, in a second
    wave: one block an SM)."""
    for name, args in _probe_inputs(np.random.default_rng([b, iters]), b, cuda).items():
        key = name if name == "chain_gather" else f"{name}_{probes.form(name, b)}"
        before = dict(probes.launches)
        got = getattr(probes, name)(*args, iters)
        torch.cuda.synchronize()
        assert probes.launches == dict(before, **{key: before[key] + 1})
        assert torch.equal(got, getattr(probes, name + "_plain")(*args, iters)), name


@pytest.mark.parametrize("b", [133, 1057])
def test_chain_gather_writes_only_its_rows(cuda, b):
    """P3's last block holds fewer rows than it has threads for: the rows
    past B of a larger output keep what they held."""
    rng = np.random.default_rng(b)
    tab, idx = (torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, shape).astype(np.int32))
                .to(cuda) for shape in ((16, 128), (b + 8, 128)))
    out = torch.full((b + 8, 128), 12345, dtype=torch.int32, device=cuda)
    build.check(build.lib().vt_chain_gather(tab.data_ptr(), idx.data_ptr(), b, 37,
                                            out.data_ptr(),
                                            torch.cuda.current_stream(cuda).cuda_stream),
                "chain_gather")
    torch.cuda.synchronize()
    assert torch.equal(out[:b], probes.chain_gather_plain(tab, idx[:b], 37))
    assert bool((out[b:] == 12345).all())


def test_probe_forms_switch_at_their_warps_a_scheduler(cuda):
    """P1 takes its short chain up to 5 rows an SM (5 warps a scheduler),
    P4 up to 2, and the few-ops form past that."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for name, warps in (("lane_gather", 5), ("alu_loop", 2)):
        assert probes.form(name, 1) == probes.form(name, warps * sms) == "short_chain"
        assert probes.form(name, warps * sms + 1) == "few_ops"


def test_probe_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    t = torch.zeros((4, 128), dtype=torch.int32, device=cuda)
    f = torch.zeros((4, 128), dtype=torch.float32, device=cuda)
    strided = torch.zeros((128, 4), dtype=torch.int32, device=cuda).t()
    tab = torch.zeros((16, 128), dtype=torch.int32, device=cuda)
    for fn, args in ((probes.lane_gather, (t.float(), t, 1)), (probes.lane_gather, (t, t[:3], 1)),
                     (probes.lane_gather, (t, t[:, :64].contiguous(), 1)),
                     (probes.lane_gather, (strided, t, 1)), (probes.lane_gather, (t.cpu(), t, 1)),
                     (probes.lane_gather, (t, t, -1)),
                     (probes.chain_gather, (t, t, 1)), (probes.chain_gather, (tab.long(), t, 1)),
                     (probes.chain_gather, (tab, strided, 1)),
                     (probes.alu_loop, (t, t, 1)), (probes.alu_loop, (t, f[:2], 1)),
                     (probes.alu_loop, (strided, f, 1)), (probes.alu_loop, (t, f.cpu(), 1))):
        with pytest.raises(ValueError):
            fn(*args)


def _pixels_off(a, b):
    return int(((a - b).abs().amax(-1) > 1e-3).sum())


def test_sharded_reorder_frame_kernels_match_plain(cuda):
    """render_sharded on one rank of a 64^2 path frame that reorders its
    bounces (the wavefront gathered, sorted and un-permuted through the
    rank hook): through the kernels and through the plain versions, 0
    pixels off by more than 1e-3."""
    from voxtracer_torch.dist.mesh import make_mesh, render_sharded

    scene, cfg = monu_like_path(64, 64, gridsize=32, bounces=3)
    cfg = dataclasses.replace(cfg, bounce_reorder="always")
    scene = scene.to(cuda)
    mesh = make_mesh(device="cuda")
    stats = {}
    got = render_sharded(scene, cfg, make_key(0), 1, mesh, stats)
    with plain_versions():
        want = render_sharded(scene, cfg, make_key(0), 1, mesh)
    assert [w for w, _, _ in stats["exchanges"]].count("reorder") == 2
    assert bool(torch.isfinite(got).all()) and 0.02 < float(got.mean()) < 10.0
    assert _pixels_off(got, want) == 0


def test_random_light_whitted_frame_kernels_match_plain(cuda):
    """render_sharded on one rank of glassbox 64^2 whitted, depth 3, two
    point lights and an area light with random light choice (each branch
    draws at its global queue slot): through the kernels and through the
    plain versions, 0 pixels off by more than 1e-3; the frame differs from
    the all-lights sum."""
    from voxtracer_torch.dist.mesh import make_mesh, render_sharded

    scene, cfg = glass_sphere_box(64, 64)
    lights = make_lights(point=((0.83, 1.57, -1.21, 2.0, 2.0, 2.0), (-1.0, 1.2, -0.8, 1.0, 0.9, 0.8)),
                         area=((0.3, 1.8, -0.5, 1.0, 1.0, 1.0, 0.5, 0.2),))
    scene = dataclasses.replace(scene, lights=lights).to(cuda)
    cfg = dataclasses.replace(cfg, max_bounces=3, deterministic_lights=False)
    mesh = make_mesh(device="cuda")
    stats = {}
    got = render_sharded(scene, cfg, make_key(0), 1, mesh, stats)
    with plain_versions():
        want = render_sharded(scene, cfg, make_key(0), 1, mesh)
    summed = render_sharded(scene, dataclasses.replace(cfg, deterministic_lights=True),
                            make_key(0), 1, mesh)
    assert len(stats["exchanges"]) == stats["queue_iterations"][0] > 1
    assert _pixels_off(got, want) == 0
    assert _pixels_off(got, summed) > 0


def _held_frame(run, share=1e-3):
    """run() through the kernels and through the plain versions: finite,
    and at most `share` of the pixels off by more than 1e-3 (chip_smoke's
    image gate) -> the kernels' image."""
    got = run()
    with plain_versions():
        want = run()
    assert bool(torch.isfinite(got).all())
    assert _pixels_off(got, want) <= share * got[..., 0].numel()
    return got


@pytest.mark.parametrize("chunks", [4, 8])
def test_compacted_path_frame_kernels_match_plain(cuda, chunks):
    """compact_chunks on the monu-like 128x64 path frame, 4 bounces
    (compact_min 1): each bounce's chunks through K1, K2 and K4, held to
    the plain versions; more K1 launches than bounces."""
    scene, cfg = monu_like_path(128, 64, gridsize=32, bounces=4)
    cfg = dataclasses.replace(cfg, compact_chunks=chunks, compact_min=1)
    scene = scene.to(cuda)
    before = traverse.launches["traverse_nearest"]
    got = _held_frame(lambda: integrator.render_tiled(scene, cfg, make_key(0), 1, 1))
    assert traverse.launches["traverse_nearest"] - before > cfg.max_bounces + 1
    assert 0.02 < float(got.mean()) < 10.0


def test_compacted_media_frame_kernels_match_plain(cuda):
    """compact_chunks = 4 on the media scene at 128^2: K3 marches inside
    the chunks."""
    scene, cfg = media_path(128, 128, bounces=4)
    cfg = dataclasses.replace(cfg, compact_chunks=4, compact_min=1)
    scene = scene.to(cuda)
    before = traverse.launches["exit_march"]
    _held_frame(lambda: integrator.render_tiled(scene, cfg, make_key(0), 1, 1))
    assert traverse.launches["exit_march"] > before


def test_reorder_compact_chunks_kernels_match_plain(cuda):
    """reorder_compact_chunks = 4 on the reordered 128x64 frame (reorder
    always, period 1): through the kernels and the plain versions, 1% of
    pixels (chip_smoke's gate with the reorder forced on)."""
    scene, cfg = monu_like_path(128, 64, gridsize=32, bounces=3)
    cfg = dataclasses.replace(cfg, bounce_reorder="always", bounce_reorder_period=1,
                              reorder_compact_chunks=4)
    scene = scene.to(cuda)
    _held_frame(lambda: integrator.render_tiled(scene, cfg, make_key(0), 1, 1), 1e-2)


@pytest.mark.parametrize("exact", [False, True])
def test_whitted_sort_batch_kernels_match_plain(cuda, exact):
    """whitted_sort_batch on glassbox 128^2, depth 5: the FIFO queue held
    to the plain versions; the exact queue's image equals the unsorted
    exact queue's to rounding of K1-K3 (none: they work per ray)."""
    scene, cfg = glass_sphere_box(128, 128)
    cfg = dataclasses.replace(cfg, whitted_sort_batch=True)
    scene = scene.to(cuda)
    px, py = integrator._pixel_grid(cfg, cuda)
    o, d = integrator.primary_rays(scene.camera, cfg.width, cfg.height, px, py)
    o = o.contiguous()
    got = _held_frame(lambda: integrator.whitted_queue(scene, cfg, o, d, 5, exact=exact)[0])
    if exact:
        unsorted = integrator.whitted_queue(
            scene, dataclasses.replace(cfg, whitted_sort_batch=False), o, d, 5, exact=True)[0]
        assert torch.equal(got, unsorted)


def test_threefry_path_frame_kernels_match_plain(cuda):
    """rng = "threefry" on the monu-like 128x64 path frame."""
    scene, cfg = monu_like_path(128, 64, gridsize=32, bounces=4)
    cfg = dataclasses.replace(cfg, rng="threefry")
    scene = scene.to(cuda)
    got = _held_frame(lambda: integrator.render_tiled(scene, cfg, make_key(0), 1, 1))
    assert 0.02 < float(got.mean()) < 10.0


def test_importance_gradient_kernels_match_plain(cuda):
    """importance = 8 on the clamped bins of the monu-like 256x128 binned
    gradient: the probes through K4, the step through K1, K4 and K4-bwd,
    within relative L2 1e-4 of the plain versions."""
    scene, cfg = monu_like_path(256, 128, bounces=4)
    scene = scene.to(cuda)
    params = volumetric.params_from_scene(scene, occupied_logit=-4.0, empty_logit=-8.0)
    plan = train.prepare_bins(scene, cfg, torch.zeros((cfg.height, cfg.width, 3), device=cuda),
                              importance=8)
    assert any(b.clamp for b in plan.bins)
    before = lookup.launches["lookup_rows"]
    _, got = train.binned_grads(params, scene, plan)
    launched = lookup.launches["lookup_rows"] - before
    with plain_versions():
        _, want = train.binned_grads(params, scene, plan)
    uniform = dataclasses.replace(plan, importance=0)
    before = lookup.launches["lookup_rows"]
    train.binned_grads(params, scene, uniform)
    assert launched > lookup.launches["lookup_rows"] - before  # the probes' lookups
    for f in ("density_logits", "albedo_table"):
        g, w = getattr(got, f), getattr(want, f)
        assert float((g - w).norm() / w.norm()) <= 1e-4, f


RNG_DRAWS = ["hash_uniform", "hash_normal", "threefry_uniform", "threefry_normal"]
RNG_N = [2_073_600, 2_073_599]  # the 1080p wavefront, and a ragged tail


def _rng_args(draw, seed):
    key = fold_in(make_key(seed), 9)
    return (key, 6) if draw.startswith("hash") else (key,)


def _kernel_is_plain(draw, shape, dev, lanes=None, axis=None, seed=0):
    """One kernel draw, bit for bit its plain torch ops on the card, in one
    launch."""
    args = _rng_args(draw, seed)
    kw = {} if axis is None else {"axis": axis}
    name = "rng_" + draw.split("_")[0]
    before = dict(rng_kernel.launches)
    got = getattr(rng, draw)(*args, shape, dev, lanes, **kw)
    after = dict(rng_kernel.launches)
    want = getattr(rng, draw + "_plain")(*args, shape, dev, lanes, **kw)
    torch.cuda.synchronize()
    assert after[name] == before[name] + 1 and sum(after.values()) == sum(before.values()) + 1
    assert got.shape == want.shape and got.dtype == torch.float32 and got.is_cuda
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        int((got.view(torch.int32) != want.view(torch.int32)).sum())


@pytest.mark.parametrize("draw", RNG_DRAWS)
@pytest.mark.parametrize("n", RNG_N)
@pytest.mark.parametrize("shape", ["n", "2n", "3n", "n2", "n3"])
def test_rng_kernel_is_its_plain_version(cuda, draw, n, shape):
    """Each stream at the frames' shapes: the kernel's float32 bits equal
    the plain int64 torch ops', one launch a draw."""
    shape = {"n": (n,), "2n": (2, n), "3n": (3, n), "n2": (n, 2), "n3": (n, 3)}[shape]
    _kernel_is_plain(draw, shape, cuda, seed=n)


@pytest.mark.parametrize("draw,form", [
    (draw, form) for draw in RNG_DRAWS
    for form in ["window_last", "lane_list_last", "past_2_32"]
    + ([] if draw.startswith("hash") else ["window_first", "lane_list_first"])])
def test_rng_kernel_lanes_are_its_plain_version(cuda, draw, form):
    """Windows of lanes on the last axis and on the first (threefry's
    axis; the hash streams' lanes run along the last axis alone), lists of
    lane indices (the sharded whitted queue) and a window
    past 2**32 lanes (threefry's hi word non-zero), bit for bit."""
    n = RNG_N[1]
    ids = torch.randperm(3 * n, generator=torch.Generator().manual_seed(5))[:n]
    shape, lanes, axis = {
        "window_last": ((3, n), (1_000, n + 5_000), -1),
        "window_first": ((n, 3), (777, 2 * n), 0),
        "lane_list_last": ((3, n), (ids.to(cuda), 3 * n), -1),
        "lane_list_first": ((n, 2), (ids.to(cuda), 3 * n), 0),
        "past_2_32": ((2, n), (2 ** 32 - 1_000, 2 ** 32 + n), -1),
    }[form]
    _kernel_is_plain(draw, shape, cuda, lanes, None if draw.startswith("hash") else axis,
                     seed=3)


def test_rng_kernel_refuses_what_it_does_not_take(cuda):
    """An empty draw launches nothing; a lane list of the wrong length
    raises."""
    before = dict(rng_kernel.launches)
    assert rng.hash_uniform(make_key(0), 1, (0, 3), cuda).shape == (0, 3)
    assert rng_kernel.launches == before
    with pytest.raises(ValueError, match="lane indices"):
        rng.threefry_uniform(make_key(0), (4, 3), cuda, (torch.arange(5, device=cuda), 9), 0)


# ---- the path bounce's shading kernels (csrc/bounce.cu) against their
# plain stages (kernels.bounce.PLAIN) on the same CUDA state, bit for bit

def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _light_kill_media(width, height):
    """The media scene with its smoke volume first (the light kill looks
    at volume 0) and the light kill on."""
    from voxtracer_torch.scene.presets import media_specs

    scene, cfg = media_path(width, height, bounces=4)
    specs = media_specs()
    scene = dataclasses.replace(scene, volumes=build_volumes(specs[-1:] + specs[:-1]))
    return scene, dataclasses.replace(cfg, detect_light_kill=True, light_kill_threshold=0.01)


def _all_lights(scene):
    """Every light type, the directional one lit."""
    return dataclasses.replace(scene, lights=make_lights(
        point=((0.0, 3.0, -2.0, 6.0, 6.0, 6.0), (1.0, 2.0, 1.0, 2.0, 1.0, 0.5)),
        spot=((-1.0, 2.5, -1.0, 0.3, -0.9, 0.3, 4.0, 4.0, 3.0, 0.6),),
        area=((0.5, 2.0, -1.5, 3.0, 3.0, 3.0, 2.0, 0.4), (-0.5, 1.5, 0.5, 1.0, 2.0, 1.0, 1.0, 0.2)),
        directional=((0.3, -1.0, 0.2), (0.8, 0.7, 0.6))))


def _bounce_case(name, dev):
    """(scene, cfg, lanes) of one bounce test, at 128x64."""
    if name in ("det", "det_kill"):
        scene, cfg = (_light_kill_media(128, 64) if name == "det_kill"
                      else media_path(128, 64, bounces=4))
        return (_all_lights(scene).to(dev), dataclasses.replace(cfg, deterministic_lights=True),
                None)
    if name == "media":
        scene, cfg = media_path(128, 64, bounces=4)
        return scene.to(dev), cfg, None
    if name == "media_kill":
        scene, cfg = _light_kill_media(128, 64)
        return scene.to(dev), cfg, None
    scene, cfg = monu_like_path(128, 64, gridsize=32, bounces=4)
    lanes = None
    if name == "lights":
        scene = _all_lights(scene)
    elif name == "threefry":
        cfg = dataclasses.replace(cfg, rng="threefry")
    elif name == "lanes":
        lanes = (1000, 3 * 8192)
    return scene.to(dev), cfg, lanes


@pytest.mark.parametrize("name", ["monu", "media", "media_kill", "lights", "threefry", "lanes",
                                  "det", "det_kill"])
def test_bounce_kernels_are_the_plain_bounce(cuda, name):
    """Every bounce of a 128x64 frame, one at a time: the three kernels give
    the packed state of their plain versions between the same traversals
    bit for bit (every material class, K3, each light type, the light
    kill, threefry draws, a window of lanes, the deterministic all-lights
    NEE with area samples, with and without the light kill)."""
    scene, cfg, lanes = _bounce_case(name, cuda)
    py, px = torch.meshgrid(torch.arange(cfg.height, dtype=torch.float32, device=cuda) + 0.5,
                            torch.arange(cfg.width, dtype=torch.float32, device=cuda) + 0.5,
                            indexing="ij")
    o, d = integrator.primary_rays(scene.camera, cfg.width, cfg.height, px.reshape(-1),
                                   py.reshape(-1))
    pk, active = integrator._first_path(cfg, o, d)
    before = dict(bounce_kernel.launches)
    marched = traverse.launches["exit_march"]
    bounces = 0
    for depth in range(cfg.max_bounces + 1):
        if not bool(active.any()):
            break
        bounces += 1
        bkey = fold_in(make_key(7), depth)
        want = pk.clone()
        want_active = integrator._bounce_core(scene, cfg, want, active, bkey, lanes,
                                              stages=bounce_kernel.PLAIN)
        active = integrator._bounce_core(scene, cfg, pk, active, bkey, lanes)
        assert torch.equal(_bits(pk), _bits(want)), f"{name} bounce {depth}"
        assert torch.equal(active, want_active), f"{name} bounce {depth}: active"
    moved = {k: bounce_kernel.launches[k] - before[k] for k in before}
    assert moved["bounce_hit"] == moved["bounce_nee"] == moved["bounce_continue"] == bounces
    if name.startswith(("media", "det")):
        assert traverse.launches["exit_march"] > marched
    if name.endswith("kill"):
        assert bool((pk[bounce_kernel.R_LK] > 0.5).any())


@contextlib.contextmanager
def _plain_bounce():
    """The bounce's plain stages swapped in for its kernels (the
    traversals, the lookups and the draws keep their kernels)."""
    kept = integrator._bounce_core

    def plain(*args, **kwargs):
        return kept(*args, **kwargs, stages=bounce_kernel.PLAIN)

    integrator._bounce_core = plain
    try:
        yield
    finally:
        integrator._bounce_core = kept


def _bounce_frame(run):
    """run() through the bounce kernels and through their plain stages, bit
    for bit -> (the image, the bounce counters' moves)."""
    before = dict(bounce_kernel.launches)
    got = run()
    moved = {k: bounce_kernel.launches[k] - before[k] for k in before}
    with _plain_bounce():
        want = run()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(_bits(g), _bits(w))
    return got, moved


@pytest.mark.parametrize("frame", ["monu_512x256", "media_128x64", "city_128x64_reorder",
                                   "monu_compact4", "light_kill"])
def test_bounce_kernel_frames_are_the_plain_frames(cuda, frame):
    """Whole frames on every bounce loop: the plain one (monu, media: K3),
    the reordered one over the city's 111 volumes, the compacted one, and
    the light kill's flags; each bit for bit, each kernel launched once a
    bounce (a traced chunk)."""
    from voxtracer_torch.scene.presets import city_xl_like_path

    if frame == "monu_512x256":
        scene, cfg = monu_like_path(512, 256, bounces=4)
    elif frame == "media_128x64":
        scene, cfg = media_path(128, 64, bounces=4)
    elif frame == "city_128x64_reorder":
        scene, cfg = city_xl_like_path(128, 64)
        cfg = dataclasses.replace(cfg, compact_min=1)
        assert integrator.path_loop(scene, cfg, 128 * 64) == "reorder"
    elif frame == "monu_compact4":
        scene, cfg = monu_like_path(128, 64, gridsize=32, bounces=4)
        cfg = dataclasses.replace(cfg, compact_chunks=4, compact_min=1)
    else:
        scene, cfg = _light_kill_media(128, 64)
    scene = scene.to(cuda)
    if frame == "light_kill":
        o, d = integrator.primary_rays(
            scene.camera, cfg.width, cfg.height,
            *(g.reshape(-1) + 0.5 for g in reversed(torch.meshgrid(
                torch.arange(cfg.height, dtype=torch.float32, device=cuda),
                torch.arange(cfg.width, dtype=torch.float32, device=cuda), indexing="ij"))))

        def run():
            rad, aux = integrator.trace_path(scene, cfg, o, d, make_key(0), return_aux=True)
            return rad, aux["in_light"]

        (img, flags), moved = _bounce_frame(run)
        assert bool(flags.any())
    else:
        img, moved = _bounce_frame(lambda: integrator.render_tiled(scene, cfg, make_key(0), 1,
                                                                   1))
    assert bool(torch.isfinite(img).all()) and 0.01 < float(img.mean()) < 10.0
    assert moved["bounce_hit"] == moved["bounce_nee"] == moved["bounce_continue"] > 0
    if frame == "monu_compact4":
        assert moved["bounce_hit"] > cfg.max_bounces + 1  # a launch a traced chunk


def test_deterministic_lights_frame_is_the_plain_frame(cuda):
    """cfg.deterministic_lights on the monu-like 128x64 path frame with every
    light type: the kernels shade each bounce (one K2 call over every
    light's segments), bit for bit."""
    scene, cfg = monu_like_path(128, 64, gridsize=32, bounces=2)
    cfg = dataclasses.replace(cfg, deterministic_lights=True)
    scene = _all_lights(scene).to(cuda)
    img, moved = _bounce_frame(lambda: integrator.render_tiled(scene, cfg, make_key(0), 1, 1))
    assert moved["bounce_hit"] == moved["bounce_nee"] == moved["bounce_continue"] > 0
    assert 0.01 < float(img.mean()) < 10.0
