"""Scene state carried across from the JAX package.

``scene_from_numpy`` takes a JAX ``SceneData`` flattened into a nested
dict of numpy arrays under the JAX field names and returns the port's
``Scene`` on ``device`` (the card unless the caller asks for the
CPU), so both packages can render the very same arrays.  Fields that
only feed the TPU kernels' VMEM tables (``occ_slot``, ``occ_rows0``,
``pal``, ``pal_rows0``) are ignored.  A paged JAX scene's pages come
across as ``tree["volumes"]["pages"]``, one dict per page in walk order
with its ``vol_off`` and its arrays (of which ``gridsize`` gives the page
its length): the port cuts the same pages out of its own arrays, so both
packages page alike.  ``diff_params_from_numpy`` does the same for the
JAX ``DiffParams``, and ``replay_pre_from_numpy`` for the JAX
``replay_precompute`` dict, so both packages' active replays can march
the very same frozen segments.
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
                             for f in fields(cls) if f.name not in ("pages", "vol_off")})
    pages = tree["volumes"].get("pages")
    if pages:
        bounds = [(int(p["vol_off"]), int(p["vol_off"]) + len(p["gridsize"])) for p in pages]
        for (lo, hi), p in zip(bounds, pages):  # a page is a slice of the parent
            if not np.array_equal(np.asarray(p["inv"]), np.asarray(tree["volumes"]["inv"])[lo:hi]):
                raise ValueError(f"page at {lo} is not volumes [{lo}, {hi}) of its parent")
        parts["volumes"] = parts["volumes"].with_pages(bounds)
    return Scene(**parts)


def diff_params_from_numpy(tree: dict, device="cuda") -> DiffParams:
    """tree: {"density_logits": [V, G, G, G], "albedo_table": [256, 3]}."""
    return DiffParams(density_logits=_tensor(tree["density_logits"], device),
                      albedo_table=_tensor(tree["albedo_table"], device))


def replay_pre_from_numpy(tree, device="cuda"):
    """The JAX package's ``replay_precompute`` dict, its leaves numpy (as
    ``jax.tree.map(np.asarray, pre)`` gives them), as the port's
    ``diff.replay_active`` takes it: arrays become tensors on `device`,
    0-d integer arrays (counts, bin bounds, march kinds) Python ints, and
    the nesting (dicts, lists of marches, bin and light tuples) stays."""
    if isinstance(tree, dict):
        return {k: replay_pre_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replay_pre_from_numpy(v, device) for v in tree)
    a = np.asarray(tree)
    if a.ndim == 0 and a.dtype.kind in "iub":
        return int(a)
    return _tensor(a, device)
