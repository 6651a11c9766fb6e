"""Checkpoint and resume (counterpart of voxtracer/utils/checkpoint.py).

A tree of dicts, lists, tuples and the port's record dataclasses
(``core.types``, ``DiffParams``) holding tensors or numpy arrays goes to
one compressed ``.npz``: its leaves as ``leaf_0``, ``leaf_1``, ... in the
order ``jax.tree_util`` flattens the same tree (dict keys sorted, a
dataclass's fields in declaration order, None an empty subtree) and one
``__treedef__`` entry, as the JAX package writes them.  So a file that
either package writes loads in the other for the same structure (the JAX
loader counts ``len(files) - 1`` leaves).  A record's fields that hold no
array (``VoxVolumes.vol_off``) are static, as in the JAX records.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float, bool))


def _children(x):
    """The subtrees of a node in jax.tree_util's order, or None for a leaf."""
    if isinstance(x, dict):
        return [x[k] for k in sorted(x)]
    if isinstance(x, (list, tuple)):
        return list(x)
    if dataclasses.is_dataclass(x):
        return [getattr(x, f.name) for f in dataclasses.fields(x)
                if not isinstance(getattr(x, f.name), (int, float, bool))]
    return None


def _flatten(tree) -> list:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        if not _is_leaf(tree):
            raise TypeError(f"not a checkpoint leaf: {type(tree).__name__}")
        return [tree]
    return [leaf for k in kids for leaf in _flatten(k)]


def _unflatten(like, leaves):
    """A tree shaped as `like` from an iterator of numpy leaves: a tensor
    leaf of `like` becomes a tensor on that leaf's device, any other leaf
    stays a numpy array."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _unflatten(getattr(like, f.name), leaves)
            for f in dataclasses.fields(like)
            if not isinstance(getattr(like, f.name), (int, float, bool))})
    a = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(a, copy=True)).to(like.device)
    return a


def save_pytree(path: str, tree) -> None:
    arrays = {f"leaf_{i}": x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
              else np.asarray(x) for i, x in enumerate(_flatten(tree))}
    # the JAX package writes str(treedef) here; no loader reads it
    arrays["__treedef__"] = np.frombuffer(f"{len(arrays)} leaves".encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_pytree(path: str, like):
    """Restore into the structure of `like` (leaf order and count must
    match); each leaf lands on the device of the matching leaf of `like`."""
    with np.load(path, allow_pickle=False) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
    n = len(_flatten(like))
    if n != len(leaves):
        raise ValueError(f"{path}: {len(leaves)} leaves, the structure has {n}")
    return _unflatten(like, iter(leaves))


def save_render_state(path: str, camera, accumulator, frames: int) -> None:
    """camera.bin analogue + progressive accumulator state."""
    save_pytree(path, {"camera": camera, "acc": accumulator, "frames": np.int64(frames)})


def load_render_state(path: str, camera_like, acc_like):
    state = load_pytree(path, {"camera": camera_like, "acc": acc_like,
                               "frames": np.int64(0)})
    return state["camera"], state["acc"], int(state["frames"])
