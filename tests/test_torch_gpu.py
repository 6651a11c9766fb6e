"""The port's CUDA kernels against their plain PyTorch versions on the card.

Each test builds the kernels (nvcc, csrc/) on first use, launches one on
CUDA tensors and holds it against the plain version on the same tensors:
hit, vol, cell and in_vol identical, t within 1e-6, normals within 1e-5,
lookup rows identical, the lookup's backward per entry within
1e-5 * (sum of |ct| over the entry's rows) + 1e-6 (both sides sum with
atomics, in no fixed order), a whole relaxed-march gradient through
the kernels within relative L2 1e-4 of one through the plain versions,
and whitted and reproject images through the kernels with at most 0.1%
of pixels off by more than 1e-3 from ones through the plain versions
(whitted's per-pixel scatter-add runs in no fixed order).
Without a CUDA device every test skips: the
kernels have no CPU mode.  This file imports neither JAX nor the JAX
package, so it runs on a machine with the card and PyTorch alone:

    python -m pytest tests/test_torch_gpu.py -q --noconftest -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import plain_versions
from voxtracer_torch.core.types import GLASS, MAT_NONE, SMOKE_MID_DENSITY
from voxtracer_torch.diff import train, volumetric
from voxtracer_torch.kernels import lookup, traverse
from voxtracer_torch.kernels.dda import BIG
from voxtracer_torch.kernels.dda_occ import traverse_occ
from voxtracer_torch.scene.instances import VolumeSpec, build_volumes
from voxtracer_torch.core.rng import fold_in, make_key
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


def test_exit_kernel_matches_plain(cuda):
    rng = np.random.default_rng(8)
    vargs, occ, bsz = _scene(rng, 3, cuda)
    n = 65536
    o, d = _rays(rng, n, cuda, scale=0.4)
    vol = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(cuda)
    code = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(cuda)
    act = torch.from_numpy(rng.uniform(size=n) < 0.8).to(cuda)
    k = traverse.exit_march(*vargs, o, d, act, code, vol, occ, bsz)
    p = traverse.exit_march_plain(*vargs, o, d, act, code, vol, occ, bsz)
    torch.cuda.synchronize()
    assert int(k["in_vol"].sum()) > 0
    _same(k, p, ("in_vol", "cell"))


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
    with pytest.raises(ValueError):
        lookup.lookup_rows(torch.zeros((256, 6), device=cuda), torch.zeros(4, device=cuda))
    ct = torch.zeros((4, 3), device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    for bad in ((ct.double(), idx, 256), (ct, idx.long(), 256), (ct, idx[:3], 256),
                (ct.t().contiguous().t(), idx, 256), (ct, idx.cpu(), 256),
                (ct[:, :1].contiguous(), idx, 64 * 1024)):  # 256 KB: past any block
        with pytest.raises(ValueError):
            lookup.lookup_rows_bwd(*bad)


def _hold_bwd(ct, idx, k):
    got = lookup.lookup_rows_bwd(ct, idx, k)
    want = lookup.lookup_rows_bwd_plain(ct, idx, k)
    bound = 1e-5 * lookup.lookup_rows_bwd_plain(ct.abs(), idx, k) + 1e-6
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= bound).all())
    assert float(want.abs().max()) > 0


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
    """The brick-sigma table of 64 volumes of 64^3: [64 * 512, 1] f32,
    128 KB of shared memory per block."""
    k = 64 * 512
    assert lookup.smem_limit(cuda) >= k * 4
    gen = torch.Generator(device=cuda).manual_seed(3)
    tab = torch.rand((k, 1), generator=gen, device=cuda)
    idx = torch.randint(-8, k + 8, (300_007,), generator=gen, device=cuda, dtype=torch.int32)
    got = lookup.lookup_rows(tab, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, lookup.lookup_rows_plain(tab, idx))
    _hold_bwd(torch.randn((idx.shape[0], 1), generator=gen, device=cuda), idx, k)


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
