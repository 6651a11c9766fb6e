"""The work counts behind chip_smoke.py's operation bounds, on the CPU.

The plain walk (``dda_occ.traverse_occ``) counts its steps in total
(``tally``) and per ray (``ray_tally``); the two must agree.  The least
work of a K1 or K2 call (``chip_smoke.least_traversal_ops``: each volume
walked alone, K1 only up to the nearest hit, K2 only the cheapest volume
to a hit of an occluded ray) must come out below the operations of the
plain walk's own steps on the same rays, which charge every (ray, volume)
pair a full entry test and walk every pair in lockstep.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from voxtracer_torch.kernels import traverse
from voxtracer_torch.kernels.dda import BIG, EXIT_GLASS
from voxtracer_torch.kernels.dda_occ import STEPS, traverse_occ
from voxtracer_torch.scene.presets import monu_like_path

torch.set_num_threads(1)


def _call(mode, n=600, seed=4):
    """A small monu-like scene and n random rays through it, as a
    traverse() call's arguments (K2 with random t limits)."""
    scene, _ = monu_like_path(32, 16, gridsize=16)
    v = scene.volumes
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32))
    o[:, 1] = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    act = torch.from_numpy(rng.uniform(size=n) < 0.9)
    tl = torch.from_numpy(rng.uniform(0.5, 6.0, n).astype(np.float32)) \
        if mode == "occluded" else None
    return (v.grids.reshape(-1), v.gridsize, v.inv, v.fwd, v.cube_min, o, d, tl, act, None,
            v.occ, v.bricksize)


@pytest.mark.parametrize("mode", ["nearest", "occluded", "exit"])
def test_ray_tally_sums_to_tally(mode):
    args = _call("occluded" if mode == "exit" else mode)
    tally, per_ray = {}, {}
    if mode == "exit":
        n, vn = args[5].shape[0], args[1].shape[0]
        code = torch.full((n,), EXIT_GLASS, dtype=torch.int32)
        vol = torch.arange(n, dtype=torch.int32) % vn
        traverse_occ(*args[:7], torch.full((n,), BIG), args[8], torch.ones(vn, dtype=torch.bool),
                     *args[10:], mode="exit", mode_code=code, vol_match=vol, tally=tally,
                     ray_tally=per_ray)
    else:
        traverse.traverse_plain(*args, mode=mode, tally=tally, ray_tally=per_ray)
    assert set(tally) == set(per_ray) == set(STEPS)
    for k in STEPS:
        assert per_ray[k].shape == (args[5].shape[0],) and per_ray[k].dtype == torch.int64
        assert int(per_ray[k].sum()) == tally[k], k
    assert tally["walks"] > 0 and tally["rows"] > 0


@pytest.mark.parametrize("mode", ["nearest", "occluded"])
def test_least_traversal_ops_below_the_plain_walk(mode):
    args = _call(mode)
    out = traverse.traverse_plain(*args, mode=mode)
    tally = {}
    traverse.traverse_plain(*args, mode=mode, tally=tally)
    ops, steps = chip_smoke.least_traversal_ops(args, mode, out)
    assert set(steps) == set(STEPS)
    assert 0 < ops < chip_smoke.walk_ops(tally)
    for k in STEPS:
        assert steps[k] <= tally[k] + (tally["walks"] if k == "entries" else 0), k
    # at least a box test per active ray
    assert ops >= chip_smoke.BOX_OPS * int(args[8].sum())
    assert 0 < int(out["hit"].sum()) < args[5].shape[0]
