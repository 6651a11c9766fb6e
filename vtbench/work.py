"""The yardstick of the kernels' rooflines: the table of peaks and the
work each hand-written kernel call needs, counted from the call's inputs
and outputs (copied from ``chip_smoke.py`` of the repository at
86df7ae, its ``bound``, ``WALK_OPS``, ``BOX_OPS``,
``least_traversal_ops``, ``traverse_bound``, ``exit_bound`` and the K4 /
K4-bwd bounds), with the walks' step counts from the reference's plain
walk.  ``recording`` swaps counting wrappers into every binding through
which the program reaches the kernel wrappers, so a replayed iteration
yields the bound of each launch it makes."""

from __future__ import annotations

import contextlib
import math
import sys

import torch

from vtbench.reference.kernels import traverse as ref_traverse
from vtbench.reference.kernels.dda import BIG
from vtbench.reference.kernels.dda_occ import STEPS

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
# 32-bit operations per unit of the walk of csrc/traverse.cu, counted from
# its source, per unit of dda_occ.STEPS: the entry test of a (ray, volume)
# pair, a walk's set-up, an outer iteration, a descent, a fine cell step
# and a macro brick step
WALK_OPS = dict(entries=120, walks=146, rows=12, descends=54, cells=41, bricks=17)
# a world-space slab test of one (ray, volume) pair
BOX_OPS = 24


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_s(nbytes_: int, ops: int) -> float:
    """The least time the card could take, in seconds."""
    return max(nbytes_ / HBM_BYTES_PER_S, ops / OPS_PER_S)


def walk_ops(tally: dict) -> int:
    return sum(WALK_OPS[k] * int(n) for k, n in tally.items())


def least_traversal_ops(args, mode, out) -> int:
    """The operations one K1 or K2 call needs at least, from the plain walk
    of each (volume, ray) pair alone (per-pair step counts, so no volume's
    walk is cut short or lengthened by another's): per active ray,
    * K1: a box test per enabled volume, then the entry test and the walk
      of each volume the ray enters no later than its nearest hit, each
      walk only up to that hit;
    * K2, a ray that is occluded: one box test, the entry test and the walk
      to its hit of the volume where that costs least;
    * K2, a ray that is not: a box test per enabled volume, then the entry
      test and the walk to t_limit of every volume it enters before it."""
    g, gs, inv, fwd, cmin, o, d, tl, act, ven, occ, bsz = args
    n = o.shape[0]
    if tl is None:
        tl = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    if mode == "nearest":
        above = torch.nextafter(out["t"], torch.full_like(out["t"], math.inf))
        tl = torch.where(out["hit"], torch.minimum(tl, above), tl)
    enabled = gs.shape[0] if ven is None else int(ven.sum())
    if not enabled:
        return 0
    pv, pr = ref_traverse.entering_pairs(inv, cmin, o, d, act, ven)
    total = torch.zeros(n, dtype=torch.int64, device=o.device)
    big = torch.iinfo(torch.int64).max
    cheap = torch.full((n,), big, dtype=torch.int64, device=o.device)
    if pv.numel():
        rt: dict = {}
        w = ref_traverse.walk_pairs(g, gs, inv, fwd, cmin, occ, bsz, o, d, tl, pv, pr,
                                    "occluded", ray_tally=rt)
        rt["entries"] = rt["walks"]  # the entry test only for the pairs walked
        cost = sum(WALK_OPS[k] * rt[k] for k in STEPS)
        total.scatter_add_(0, pr, cost)
        if mode == "occluded":
            cheap.scatter_reduce_(0, pr, torch.where(w["hit"], cost, big), "amin")
    boxes = BOX_OPS * enabled * act.long()
    if mode == "occluded":
        occluded = cheap < big
        total = torch.where(occluded, cheap, total)
        boxes = torch.where(occluded, BOX_OPS, boxes)
    return int(boxes.sum()) + int(total.sum())


def traverse_bound(args, out, mode) -> float:
    """One traverse() call: the bytes of its active rays (origin,
    direction, t limit where given), the active flags, the enabled flags
    where given, the occupancy plane it walks, its outputs and one grid
    cell per nearest hit; the operations it needs at least."""
    t_limit, act, ven, occ = args[7], args[8], args[9], args[10]
    na = int(act.sum())
    by = act.numel() + na * (24 + (4 if t_limit is not None else 0)) + nbytes(occ[0])
    by += nbytes(*out.values()) + (ven.numel() if ven is not None else 0)
    if "t" in out:
        by += 4 * int(out["hit"].sum())
    return bound_s(by, least_traversal_ops(args, mode, out))


def exit_bound(args, out) -> float:
    """One exit_march() call: the bytes of its marching rays (origin,
    direction, medium code, volume), the active flags, the two exit
    planes, its outputs and one grid cell per ray that left its medium
    inside the grid; the operations of the plain walk's steps."""
    act, occ = args[7], args[10]
    tally: dict = {}
    ref_traverse.exit_march_plain(*args, tally=tally)
    by = act.numel() + 32 * int(act.sum()) + nbytes(occ[1:]) + nbytes(*out.values())
    return bound_s(by + 4 * int(out["in_vol"].sum()), walk_ops(tally))


def lookup_bound(tab, idx, out) -> float:
    """K4: the table, the indices and the rows out; clamp twice and a load
    per element."""
    return bound_s(nbytes(tab, idx, out), 3 * out.numel())


def lookup_bwd_bound(ct, idx, k) -> float:
    """K4-bwd: the cotangent rows, the indices and the table out; clamp
    twice and one add per element."""
    return bound_s(nbytes(ct, idx) + k * ct.shape[1] * 4, 3 * ct.numel())


# the program's kernel wrappers: (module, function, family of each call)
WRAPPERS = (("voxtracer_torch.kernels.traverse", "traverse"),
            ("voxtracer_torch.kernels.traverse", "exit_march"),
            ("voxtracer_torch.kernels.lookup", "lookup_rows"),
            ("voxtracer_torch.kernels.lookup", "lookup_rows_bwd"))


@contextlib.contextmanager
def recording(bounds: dict, counts: dict):
    """Count the bound of every kernel-wrapper call of the program into
    ``bounds[family]`` (seconds) and ``counts[family]``: the wrappers are
    swapped in every module of the program that holds them by name, and
    restored after."""
    originals = {}
    for mod_name, fn in WRAPPERS:
        mod = sys.modules.get(mod_name)
        if mod is not None and hasattr(mod, fn):
            originals[(mod_name, fn)] = getattr(mod, fn)

    def add(fam, b):
        bounds[fam] = bounds.get(fam, 0.0) + b
        counts[fam] = counts.get(fam, 0) + 1

    def wrap(key, fn):
        name = key[1]

        def traverse(*args, mode="nearest", **kw):
            out = fn(*args, mode=mode, **kw)
            if args[5].is_cuda and args[5].shape[0]:
                add("K1" if mode == "nearest" else "K2", traverse_bound(args, out, mode))
            return out

        def exit_march(*args):
            out = fn(*args)
            if args[5].is_cuda and args[5].shape[0]:
                add("K3", exit_bound(args, out))
            return out

        def lookup_rows(tab, idx):
            out = fn(tab, idx)
            if idx.is_cuda and idx.shape[0]:
                add("K4", lookup_bound(tab, idx, out))
            return out

        def lookup_rows_bwd(ct, idx, k, *a, **kw):
            out = fn(ct, idx, k, *a, **kw)
            if ct.is_cuda and ct.shape[0]:
                add("K4bwd", lookup_bwd_bound(ct, idx, k))
            return out

        return {"traverse": traverse, "exit_march": exit_march, "lookup_rows": lookup_rows,
                "lookup_rows_bwd": lookup_rows_bwd}[name]

    swapped = []
    for key, fn in originals.items():
        w = wrap(key, fn)
        for mod_name, mod in list(sys.modules.items()):
            if mod is None or not mod_name.startswith("voxtracer_torch"):
                continue
            for attr, val in list(vars(mod).items()):
                if val is fn:
                    setattr(mod, attr, w)
                    swapped.append((mod, attr, fn))
    try:
        yield
    finally:
        for mod, attr, fn in swapped:
            setattr(mod, attr, fn)
