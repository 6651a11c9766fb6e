"""Scene state carried across from the JAX package.

``scene_from_numpy`` takes a JAX ``SceneData`` flattened into a nested
dict of numpy arrays under the JAX field names and returns the port's
``Scene`` on ``device`` (the card unless the caller asks for the
CPU), so both packages can render the very same arrays.  Fields that
only feed the TPU kernels' VMEM tables (``occ_slot``, ``occ_rows0``,
``pal``, ``pal_rows0``, ``pages``) are ignored.  ``diff_params_from_numpy`` does the same for the JAX
``DiffParams``.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from voxtracer_torch.core.types import (Camera, Lights, Materials, Scene, Sky,
                                        Spheres, Triangles, VoxVolumes)
from voxtracer_torch.diff.volumetric import DiffParams

_RECORDS = dict(volumes=VoxVolumes, materials=Materials, lights=Lights,
                spheres=Spheres, triangles=Triangles, sky=Sky, camera=Camera)


def _tensor(a, device):
    """A copy of `a` as a tensor: never a view of the caller's memory (a
    numpy view of a JAX CPU array is the JAX buffer itself, and the port
    updates parameters in place)."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype in (np.int64, np.uint8, np.uint32):
        a = a.astype(np.int32)
    return torch.from_numpy(np.array(a, order="C", copy=True)).to(device)


def scene_from_numpy(tree: dict, device="cuda") -> Scene:
    """tree: {"volumes": {"grids": ..., ...}, "materials": {...}, ...}."""
    parts = {}
    for name, cls in _RECORDS.items():
        sub = tree[name]
        parts[name] = cls(**{f.name: _tensor(sub[f.name], device)
                             for f in fields(cls)})
    return Scene(**parts)


def diff_params_from_numpy(tree: dict, device="cuda") -> DiffParams:
    """tree: {"density_logits": [V, G, G, G], "albedo_table": [256, 3]}."""
    return DiffParams(density_logits=_tensor(tree["density_logits"], device),
                      albedo_table=_tensor(tree["albedo_table"], device))
