"""Host-side voxel grids: uint8 material ids, MAT_NONE = empty, and the
``.vox`` ingest (counterpart of voxtracer/scene/volume.py;
Scene::LoadModel and its variants, scene.cpp:449-711).  numpy, so the
float32 products and their int32 truncations, and ``np.unique``'s order,
are the JAX package's."""

from __future__ import annotations

import numpy as np

from voxtracer_torch.core.types import MAT_NONE
from voxtracer_torch.io.vox import VoxModel


def empty_grid(gridsize: int) -> np.ndarray:
    return np.full((gridsize, gridsize, gridsize), MAT_NONE, dtype=np.uint8)


def solid_grid(gridsize: int, material: int) -> np.ndarray:
    """Reference ResetGrid(type) (scene.cpp:358-361)."""
    return np.full((gridsize, gridsize, gridsize), material, dtype=np.uint8)


def grid_from_vox(
    model: VoxModel,
    gridsize: int,
    material_updates: dict[int, np.ndarray] | None = None,
    column_window: tuple[int, int] | None = None,
    material_override=None,
):
    """A VoxModel as a gridsize^3 material grid (Scene::LoadModel,
    scene.cpp:449-529):
      * axis remap vox -> renderer: grid[x*sm0, z*sm1, y*sm2] = index, with
        the reference's cross-axis scale (sm1 divides by the model's
        size_y but scales z);
      * the scale only when size_x > gridsize;
      * the palette index is the material id; empty (0) is skipped;
      * `material_updates`, when a dict is passed, collects the material
        table's mutations (albedo = palette rgb, scene.cpp:516-520) for the
        caller to apply, in ``np.unique`` order, the last writer winning.

    `column_window=(columns, thickness)` is LoadModelPartial's sliding
    column filter (scene.cpp:531-604); `material_override` a callable
    ``() -> material id`` called once per voxel, for
    LoadModelRandomMaterials (scene.cpp:606-683).  Voxels the cross-axis
    scale sends out of the grid are dropped (the reference writes out of
    bounds there).
    """
    grid = empty_grid(gridsize)
    sx, sy, sz = model.size
    sm = np.ones(3, np.float32)
    if sx > gridsize:
        sm = np.array([gridsize / sx, gridsize / sy, gridsize / sz], np.float32)

    occ = np.argwhere(model.grid > 0)
    if occ.size == 0:
        return grid
    x, y, z = occ[:, 0], occ[:, 1], occ[:, 2]
    ci = model.grid[x, y, z].astype(np.int32)

    if column_window is not None:
        columns, thickness = column_window
        keep = (x >= columns - thickness) & (x <= columns + thickness)
        x, y, z, ci = x[keep], y[keep], z[keep], ci[keep]

    gx = (x.astype(np.float32) * sm[0]).astype(np.int32)
    gy = (z.astype(np.float32) * sm[1]).astype(np.int32)
    gz = (y.astype(np.float32) * sm[2]).astype(np.int32)
    inb = (gx < gridsize) & (gy < gridsize) & (gz < gridsize)
    gx, gy, gz, ci = gx[inb], gy[inb], gz[inb], ci[inb]

    if material_override is not None:
        mats = np.asarray([material_override() for _ in range(ci.size)], np.int32)
    else:
        mats = ci

    if material_updates is not None and material_override is None:
        for idx in np.unique(ci):
            material_updates[int(idx)] = model.palette[idx, :3].astype(np.float32)

    grid[gx, gy, gz] = mats.astype(np.uint8)
    return grid


def emissive_sphere(grid: np.ndarray, material: int, radius: float) -> np.ndarray:
    """CreateEmmisiveSphere (scene.cpp:685-711): a copy of grid with the
    cells within `radius` of its centre set to `material`."""
    g = grid.shape[0]
    coords = np.arange(g, dtype=np.float32)
    x, y, z = np.meshgrid(coords, coords, coords, indexing="ij")
    c = g / 2.0
    inside = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) < radius
    out = grid.copy()
    out[inside] = material
    return out
