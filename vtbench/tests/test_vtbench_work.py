"""The roofline's work counts against counts made by hand."""

import numpy as np
import pytest
import torch

from vtbench import work
from vtbench.reference.kernels import traverse as rt
from vtbench.reference.scene.instances import VolumeSpec, build_volumes


def cube_args(rays, active=None):
    vols = build_volumes([VolumeSpec(position=(0, 0, 0), gridsize=8,
                                     grid=np.full((8, 8, 8), 1, np.uint8)),
                          VolumeSpec(position=(4, 0, 0), gridsize=8,
                                     grid=np.full((8, 8, 8), 255, np.uint8))])
    o = torch.tensor([r[0] for r in rays], dtype=torch.float32)
    d = torch.tensor([r[1] for r in rays], dtype=torch.float32)
    act = torch.ones(len(rays), dtype=torch.bool) if active is None else active
    return (vols.grids.reshape(-1), vols.gridsize, vols.inv, vols.fwd, vols.cube_min, o, d,
            None, act, None, vols.occ, vols.bricksize)


HIT = ((0.55, 0.55, -1.0), (0.0, 0.0, 1.0))    # into the solid cube's first cell
MISS = ((-9.0, -9.0, -1.0), (0.0, 0.0, 1.0))   # past both cubes


def test_least_ops_by_hand():
    args = cube_args([HIT, MISS])
    out = rt.traverse_plain(*args, mode="nearest")
    # per active ray a box test per enabled volume (2 x 24); the hit ray
    # then one entry test (120), a walk's set-up (146), one outer trip
    # (12), one descent (54) and one fine cell step (41)
    assert work.least_traversal_ops(args, "nearest", out) == 2 * 2 * 24 + 120 + 146 + 12 + 54 + 41
    occ = rt.traverse_plain(*args, mode="occluded")
    # occluded: one box test and the cheapest walk to a hit; the other ray
    # a box test per volume
    assert work.least_traversal_ops(args, "occluded", occ) == 24 + 120 + 146 + 12 + 54 + 41 + 48
    idle = cube_args([HIT, MISS], torch.tensor([False, False]))
    assert work.least_traversal_ops(idle, "nearest", rt.traverse_plain(*idle)) == 0


def test_traverse_bound_bytes_by_hand():
    args = cube_args([HIT, MISS])
    out = rt.traverse_plain(*args, mode="nearest")
    ops = work.least_traversal_ops(args, "nearest", out)
    # 2 active flags, 2 rays x 24 bytes, the occupancy plane (2 volumes x
    # one brick x 16 words), the outputs (hit 2 bools, t, cell, vol, n x3:
    # 6 x 2 x 4) and one grid cell for the hit
    by = 2 + 2 * 24 + 2 * 16 * 4 + (2 + 6 * 2 * 4) + 4
    assert work.traverse_bound(args, out, "nearest") == pytest.approx(
        max(by / work.HBM_BYTES_PER_S, ops / work.OPS_PER_S))


def test_lookup_bounds_by_hand():
    tab, idx = torch.zeros(256, 3), torch.zeros(1000, dtype=torch.int32)
    out = torch.zeros(1000, 3)
    assert work.lookup_bound(tab, idx, out) == pytest.approx(
        max((256 * 3 * 4 + 1000 * 4 + 1000 * 3 * 4) / 3.35e12, 3 * 3000 / 67e12))
    assert work.lookup_bwd_bound(out, idx, 256) == pytest.approx(
        max((1000 * 3 * 4 + 1000 * 4 + 256 * 3 * 4) / 3.35e12, 9000 / 67e12))


def test_recording_counts_the_program_calls():
    from voxtracer_torch.kernels import lookup

    bounds, counts = {}, {}
    tab, idx = torch.rand(8, 3), torch.arange(8, dtype=torch.int32)
    with work.recording(bounds, counts):
        assert lookup.lookup_rows is not lookup.lookup_rows_plain
    # CPU calls launch no kernel, so they count nothing
    assert counts == {} and lookup.lookup_rows(tab, idx).shape == (8, 3)
