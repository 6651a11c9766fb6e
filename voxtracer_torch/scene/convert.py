"""Scene state carried across from the JAX package.

``scene_from_numpy`` takes a JAX ``SceneData`` flattened into a nested
dict of numpy arrays under the JAX field names and returns the port's
``Scene`` on ``device``, so both packages can render the very same
arrays.  Fields that only feed the TPU kernels' VMEM tables
(``occ_slot``, ``occ_rows0``, ``pal``, ``pal_rows0``, ``pages``) are
ignored.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from voxtracer_torch.core.types import (Camera, Lights, Materials, Scene, Sky,
                                        Spheres, Triangles, VoxVolumes)

_RECORDS = dict(volumes=VoxVolumes, materials=Materials, lights=Lights,
                spheres=Spheres, triangles=Triangles, sky=Sky, camera=Camera)


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype in (np.int64, np.uint8, np.uint32):
        a = a.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def scene_from_numpy(tree: dict, device="cpu") -> Scene:
    """tree: {"volumes": {"grids": ..., ...}, "materials": {...}, ...}."""
    parts = {}
    for name, cls in _RECORDS.items():
        sub = tree[name]
        parts[name] = cls(**{f.name: _tensor(sub[f.name], device)
                             for f in fields(cls)})
    return Scene(**parts)
