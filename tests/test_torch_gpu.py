"""The port's CUDA kernels against their plain PyTorch versions on the card.

Each test builds the kernels (nvcc, csrc/) on first use, launches one on
CUDA tensors and holds it against the plain version on the same tensors:
hit, vol, cell and in_vol identical, t within 1e-6, normals within 1e-5,
lookup rows identical.  Without a CUDA device every test skips: the
kernels have no CPU mode.  This file imports neither JAX nor the JAX
package, so it runs on a machine with the card and PyTorch alone:

    python -m pytest tests/test_torch_gpu.py -q --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from voxtracer_torch.core.types import GLASS, MAT_NONE, SMOKE_MID_DENSITY
from voxtracer_torch.kernels import lookup, traverse
from voxtracer_torch.kernels.dda import BIG
from voxtracer_torch.kernels.dda_occ import traverse_occ
from voxtracer_torch.scene.instances import VolumeSpec, build_volumes

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
