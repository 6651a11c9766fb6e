"""Host-side voxel grids: uint8 material ids, MAT_NONE = empty, and the
``.vox`` ingest (counterpart of voxtracer/scene/volume.py;
Scene::LoadModel and its variants, scene.cpp:449-711).  numpy, so the
float32 products and their int32 truncations, and ``np.unique``'s order,
are the JAX package's."""

from __future__ import annotations

import numpy as np

from vtbench.reference.core.types import MAT_NONE


def empty_grid(gridsize: int) -> np.ndarray:
    return np.full((gridsize, gridsize, gridsize), MAT_NONE, dtype=np.uint8)


def solid_grid(gridsize: int, material: int) -> np.ndarray:
    """Reference ResetGrid(type) (scene.cpp:358-361)."""
    return np.full((gridsize, gridsize, gridsize), material, dtype=np.uint8)
