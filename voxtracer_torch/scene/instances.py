"""Volume specs -> batched VoxVolumes (counterpart of
voxtracer/scene/instances.py).

Built in NumPy on the host, then held as CPU tensors; ``Scene.to(device)``
moves them.  The arrays equal the JAX package's on the same specs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from voxtracer_torch.core.transforms import volume_transforms
from voxtracer_torch.core.types import (GLASS, MAT_NONE, SMOKE_LOW_DENSITY,
                                        SMOKE_PLAYER, Spheres, Triangles,
                                        VoxVolumes)
from voxtracer_torch.scene.volume import empty_grid

BRICK = 8
BRICK_MIXED = -1


@dataclass
class VolumeSpec:
    """One voxel volume instance (reference Scene fields, scene.h:252-266)."""

    position: tuple = (0.0, 0.0, 0.0)
    gridsize: int = 64
    scale: tuple = (1.0, 1.0, 1.0)
    rotation: tuple = (0.0, 0.0, 0.0)
    rot_mat4: np.ndarray | None = None  # overrides rotation
    grid: np.ndarray | None = None  # [g, g, g] uint8; None = empty

    def build_grid(self) -> np.ndarray:
        if self.grid is None:
            return empty_grid(self.gridsize)
        assert self.grid.shape == (self.gridsize,) * 3
        return self.grid


def build_bricks(grid: np.ndarray, gridsize: int) -> np.ndarray:
    """Uniform-brick macro grid: the single cell value of each 8^3 brick
    (clipped to the logical gridsize) if uniform, else BRICK_MIXED."""
    m = max(1, -(-gridsize // BRICK))
    out = np.full((m, m, m), BRICK_MIXED, np.int32)
    for bx in range(m):
        for by in range(m):
            for bz in range(m):
                sub = grid[bx * BRICK:min((bx + 1) * BRICK, gridsize),
                           by * BRICK:min((by + 1) * BRICK, gridsize),
                           bz * BRICK:min((bz + 1) * BRICK, gridsize)]
                lo, hi = sub.min(), sub.max()
                out[bx, by, bz] = int(lo) if lo == hi else BRICK_MIXED
    return out


def pack_occupancy(pred: np.ndarray, mside: int) -> np.ndarray:
    """[G8, G8, G8] bool (G8 = mside * 8) -> [mside^3, 16] int32 brick
    bitmasks; bit b = (fx*8+fy)*8+fz of word b >> 5, LSB first."""
    g8 = mside * BRICK
    assert pred.shape == (g8, g8, g8)
    p = (pred.reshape(mside, BRICK, mside, BRICK, mside, BRICK)
         .transpose(0, 2, 4, 1, 3, 5)
         .reshape(mside * mside * mside, BRICK ** 3))
    bytes_ = np.packbits(p, axis=1, bitorder="little")  # [m^3, 64] u8
    return bytes_.view("<u4").astype(np.int64).astype(np.int32).reshape(-1, 16)


def build_occupancy(grids: np.ndarray) -> np.ndarray:
    """[V, G, G, G] grids -> [3, V, M^3, 16] int32 occupancy planes."""
    v, g = grids.shape[0], grids.shape[1]
    mside = max(1, -(-g // BRICK))
    g8 = mside * BRICK
    padded = np.full((v, g8, g8, g8), MAT_NONE, grids.dtype)
    padded[:, :g, :g, :g] = grids
    out = np.zeros((3, v, mside ** 3, 16), np.int32)
    preds = (
        padded != MAT_NONE,                                      # OCC_ANY
        padded != GLASS,                                         # OCC_EXIT_GLASS
        (padded < SMOKE_LOW_DENSITY) | (padded > SMOKE_PLAYER),  # OCC_EXIT_SMOKE
    )
    for k, pred in enumerate(preds):
        for i in range(v):
            out[k, i] = pack_occupancy(pred[i], mside)
    return out


def build_volumes(specs: list[VolumeSpec], pad_size: int | None = None) -> VoxVolumes:
    """Pad every instance grid to one static size and stack transforms."""
    if not specs:
        raise ValueError("scene needs at least one voxel volume")
    gmax = pad_size or max(s.gridsize for s in specs)
    mmax = max(1, -(-gmax // BRICK))
    v = len(specs)
    grids = np.full((v, gmax, gmax, gmax), MAT_NONE, dtype=np.uint8)
    bricks = np.full((v, mmax, mmax, mmax), BRICK_MIXED, dtype=np.int32)
    gridsize = np.zeros(v, np.int32)
    bricksize = np.zeros(v, np.int32)
    fwd = np.zeros((v, 4, 4), np.float32)
    inv = np.zeros((v, 4, 4), np.float32)
    cube_min = np.zeros((v, 3), np.float32)
    for i, s in enumerate(specs):
        g = s.gridsize
        grids[i, :g, :g, :g] = s.build_grid()
        gridsize[i] = g
        bsz = max(1, -(-g // BRICK))
        bricksize[i] = bsz
        bricks[i, :bsz, :bsz, :bsz] = build_bricks(grids[i, :g, :g, :g], g)
        fwd[i], inv[i] = volume_transforms(s.position, s.scale, s.rotation,
                                           s.rot_mat4)
        cube_min[i] = np.asarray(s.position, np.float32)
    t = torch.from_numpy
    return VoxVolumes(
        grids=t(grids.astype(np.int32)), gridsize=t(gridsize), inv=t(inv),
        fwd=t(fwd), cube_min=t(cube_min), bricks=t(bricks),
        bricksize=t(bricksize), occ=t(build_occupancy(grids)))


def make_spheres(items=()) -> Spheres:
    """items: iterable of (cx, cy, cz, radius, material)."""
    a = np.asarray(items, np.float32).reshape(-1, 5)
    return Spheres(center=torch.from_numpy(np.ascontiguousarray(a[:, 0:3])),
                   radius=torch.from_numpy(np.ascontiguousarray(a[:, 3])),
                   material=torch.from_numpy(a[:, 4].astype(np.int32)))


def make_triangles(items=()) -> Triangles:
    """items: iterable of (v0, v1, v2, position, material)."""
    n = len(items)
    v0, v1, v2, pos = (np.zeros((n, 3), np.float32) for _ in range(4))
    mat = np.zeros(n, np.int32)
    for i, (a, b, c, p, m) in enumerate(items):
        v0[i], v1[i], v2[i], pos[i], mat[i] = a, b, c, p, m
    t = torch.from_numpy
    return Triangles(v0=t(v0), v1=t(v1), v2=t(v2), position=t(pos),
                     material=t(mat))
