"""Host-side voxel grids: uint8 material ids, MAT_NONE = empty
(counterpart of voxtracer/scene/volume.py; ``.vox`` ingest comes later)."""

from __future__ import annotations

import numpy as np

from voxtracer_torch.core.types import MAT_NONE


def empty_grid(gridsize: int) -> np.ndarray:
    return np.full((gridsize, gridsize, gridsize), MAT_NONE, dtype=np.uint8)


def solid_grid(gridsize: int, material: int) -> np.ndarray:
    """Reference ResetGrid(type) (scene.cpp:358-361)."""
    return np.full((gridsize, gridsize, gridsize), material, dtype=np.uint8)
