"""The numbers that decide ``correct``, and the control's precision.

* ``pixels_off``: the share of pixels whose largest channel lies more than
  1e-3 from the reference's (a value that is not finite counts as off).
* ``norm_gap``: per leaf, |norm(program) - norm(reference)| over the larger
  of the reference leaf's norm and the median leaf's (or, ``own``, over
  the leaf's own norm); the worst leaf.
* ``Bf16``: a mode under which every new float32 tensor an operation makes
  is rounded to bfloat16: the reference computed a precision below the
  configuration's float32, the control of every cell.
"""

from __future__ import annotations

import statistics

import torch
import torch.utils._pytree
from torch.overrides import TorchFunctionMode

PIXEL_TOL = 1e-3


def pixels_off(a, b) -> float:
    """a, b: [H, W, C] -> the share of pixels off by more than PIXEL_TOL."""
    gap = (a.float() - b.float()).abs().amax(-1)
    return float((~(gap <= PIXEL_TOL)).float().mean())


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b| (inf where b is 0 and a is not)."""
    if a == b:
        return 0.0
    return abs(a - b) / abs(b) if b != 0 else float("inf")


def leaf_gaps(prog: dict, ref: dict, leaves=None, own: bool = False) -> dict:
    """prog, ref: leaf name -> tensor.  Per leaf of `leaves` (all by
    default): |norm(program) - norm(reference)| over the larger of the
    reference leaf's norm and the median leaf's, or with `own` over the
    reference leaf's norm alone (a leaf whose gradient is small beside the
    others' is then held on its own scale)."""
    ref_n = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    med = statistics.median(ref_n.values())
    out = {}
    for k in leaves if leaves is not None else ref:
        pn = float(torch.linalg.vector_norm(prog[k].double()))
        scale = ref_n[k] if own else max(ref_n[k], med)
        gap = abs(pn - ref_n[k]) / scale if scale > 0 else (0.0 if pn == 0 else float("inf"))
        out[k] = gap if gap == gap else float("inf")
    return out


def norm_gap(prog: dict, ref: dict, leaves=None, own: bool = False) -> float:
    """The worst leaf's gap of ``leaf_gaps``."""
    return max(leaf_gaps(prog, ref, leaves, own).values(), default=0.0)


def moving_leaves(ref_grads: dict, share: float = 1e-3) -> list:
    """The leaves whose reference gradient norm is at least `share` of the
    median leaf's: the others move under Adam by round-off alone."""
    n = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref_grads.items()}
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= share * med]


def judge(numbers: dict, limits: dict) -> list:
    """[(name, value, limit, ok)] for every number; a number without a
    limit, or not finite, fails."""
    out = []
    for name, value in numbers.items():
        lim = limits.get(name, {}).get("limit")
        ok = lim is not None and value == value and value <= lim
        out.append((name, value, lim, ok))
    return out


def _round(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float32 and not x._is_view():
            return x.to(torch.bfloat16).to(torch.float32)
        return x
    if isinstance(x, tuple):
        return type(x)(_round(v) for v in x) if not hasattr(x, "_fields") \
            else type(x)(*(_round(v) for v in x))
    if isinstance(x, list):
        return [_round(v) for v in x]
    if isinstance(x, dict):
        return {k: _round(v) for k, v in x.items()}
    return x


# operations that only move or select values already made: their outputs
# keep what their inputs hold (an integer index packed into a float row
# stays exact, as it would in an integer lane of a bfloat16 program)
MOVES = frozenset({"stack", "cat", "concat", "concatenate", "hstack", "vstack",
                   "index_select", "gather", "take", "take_along_dim", "__getitem__",
                   "clone", "contiguous", "reshape", "view", "permute", "transpose",
                   "flatten", "expand", "expand_as", "repeat", "split", "chunk", "unbind",
                   "narrow", "select", "squeeze", "unsqueeze", "flip", "roll", "t",
                   "movedim", "masked_select", "split_with_sizes"})


class Bf16(TorchFunctionMode):
    """Round to bfloat16 every new float32 tensor that an operation
    computes from float inputs: not views, in-place results, pure moves of
    values (MOVES), nor what is made from integers alone (an index turned
    float stays exact)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if name.endswith("_") or name.startswith("__set") or name in MOVES:
            return out
        leaves = torch.utils._pytree.tree_leaves((args, kwargs or {}))
        if not any(isinstance(x, torch.Tensor) and x.is_floating_point() for x in leaves):
            return out
        return _round(out)
