"""Voxel traversal wrappers over the CUDA kernels of csrc/traverse.cu
(counterpart of voxtracer/kernels/pallas_dda.py).

``traverse`` (nearest hit or occlusion over all volumes) and
``exit_march`` (each ray through its own glass or smoke volume) take the
same arguments and return the same dicts as the plain version,
``dda_occ.traverse_occ``.  A CUDA tensor goes through the kernel; a CPU
tensor goes through the plain version.  ``launches`` counts kernel
launches per kernel.  ``traverse``'s nearest mode has two profiling
variants of K1, as the JAX kernel's ``count_iters`` and ``ablate``:
``count_iters=True`` adds each ray's trips through the walk (the plain
version counts them with ``dda_occ.walk_trips``), and
``ablate=("norm",)`` skips the normal epilogue.  The JAX kernel's other
stages, "cand" (its candidate list) and "pal" (its palette fetch), have
no counterpart in K1 and are refused.

The kernels read the scene from tables packed once per volume set
(``scene_tables``, in the TPU kernel's ``_prep_tables`` layout) and kept
in a small cache keyed by the source tensors' ``data_ptr()`` and
``_version``, so an in-place edit of any of them rebuilds the tables and
a call checks only its rays.  The cache holds its sources by weak
reference: an entry goes when any of them is freed.

The kernels take any number of volumes whose stacked grids' cells can be
indexed in 32 bits (V * G^3 < 2^31: 8,191 volumes of 64^3).  ``exit_march``
marches the rays whose ``ray_active`` is set; of any other ray it returns
in_vol False, t 0, cell MAT_NONE and a zero normal (the plain version
returns such a ray's entry t; no caller reads it).
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import torch

from voxtracer_torch.kernels import build
from voxtracer_torch.kernels.dda import BIG
from voxtracer_torch.kernels.dda_occ import traverse_occ, walk_trips

VT = 26       # floats per volume in the constants table
CACHE_SIZE = 16  # volume sets whose tables are kept (a paged scene's 5 pages and itself)

launches = {"traverse_nearest": 0, "traverse_occluded": 0, "exit_march": 0,
            "traverse_nearest_count": 0, "traverse_nearest_no_normals": 0}
# K1's variants (csrc/traverse.cu VAR_*): the trip counter, no normals
VAR_COUNT, VAR_NO_NORMALS = 1, 2


def scene_tables(gridsize, inv, fwd, cube_min, occ, bricksize):
    """The packed scene the kernels read -> (vtab [V, 26] f32, bm [3, W]
    i32) on the tensors' device.

    vtab is the TPU kernel's vtab transposed: per volume the inverse
    transform's rows 0-2 (12 floats), the forward transform's 3x3 (9),
    cube_min (3), the grid size and the brick count per axis as floats.
    bm holds one brick-occupied bitmask per occupancy plane, W = ceil(V *
    M^3 / 32) words: bit (vol * M^3 + brick) % 32 of word (vol * M^3 +
    brick) // 32 is set iff any of that brick's 16 row words is not 0."""
    v, m3 = gridsize.shape[0], occ.shape[2]
    vtab = torch.cat([inv[:, :3, :].reshape(v, 12), fwd[:, :3, :3].reshape(v, 9), cube_min,
                      gridsize.to(torch.float32)[:, None],
                      bricksize.to(torch.float32)[:, None]], dim=1).contiguous()
    words = -(-v * m3 // 32)
    nz = (occ != 0).any(-1).reshape(3, v * m3).to(torch.int64)
    nz = torch.nn.functional.pad(nz, (0, 32 * words - v * m3))
    shifts = torch.arange(32, dtype=torch.int64, device=occ.device)
    bits = (nz.reshape(3, words, 32) << shifts).sum(-1)
    bm = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)
    return vtab, bm


def world_boxes(inv, cube_min):
    """[V, 8] f32: each volume's cube [b, b + 1]^3 taken to world space by
    the inverse of inv (in float64) -> its box lo xyz, hi xyz and the
    largest coordinate magnitude.  (fwd serves the normals only and is no
    exact inverse of inv for a scaled volume.)"""
    corners = torch.tensor([[i >> 2 & 1, i >> 1 & 1, i & 1] for i in range(8)],
                           dtype=torch.float64, device=inv.device)
    obj = cube_min.double()[:, None, :] + corners[None]            # [V, 8, 3]
    f = torch.linalg.inv(inv.double())
    world = torch.einsum("vij,vkj->vki", f[:, :3, :3], obj) + f[:, None, :3, 3]
    lo, hi = world.amin(1), world.amax(1)
    mag = torch.maximum(lo.abs(), hi.abs()).amax(1, keepdim=True)
    return torch.cat([lo, hi, mag, torch.zeros_like(mag)], 1).float().contiguous()


class Tables(NamedTuple):
    vtab: torch.Tensor
    bm: torch.Tensor
    wbox: torch.Tensor
    v: int
    side: int
    mside: int
    words: int
    ptrs: tuple       # data_ptr of vtab, bm, occ, grids_flat, wbox
    device: int       # CUDA device index, -1 on the CPU


_cache: dict = {}


def _check(name, x, dtype, shape, index):
    """Raise unless x is a contiguous tensor of dtype and shape on device
    `index` (get_device(): -1 is the CPU); cheap attribute reads, as the
    ray-side arguments are checked every call."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.dtype != dtype or x.shape != shape or not x.is_contiguous() \
            or x.get_device() != index:
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)} on device {index}, got {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}")


def _owner(x):
    """The tensor that owns x's memory: its base if x is a view (callers
    pass ``grids.reshape(-1)``, a new view on every call)."""
    return x if x._base is None else x._base


def tables(grids_flat, gridsize, inv, fwd, cube_min, occ, bricksize):
    """The packed tables of a volume set (``scene_tables`` plus the sizes
    and pointers), built and checked on the first call and taken from the
    cache while every source tensor keeps its memory and version.  The
    cache holds weak references to the sources' owners; when one is
    freed, its entries go (so no freed tensor's address can alias one)."""
    key = (grids_flat.data_ptr(), grids_flat.shape[0], gridsize.data_ptr(), gridsize._version,
           inv.data_ptr(), inv._version, fwd.data_ptr(), fwd._version, cube_min.data_ptr(),
           cube_min._version, occ.data_ptr(), occ._version, bricksize.data_ptr(),
           bricksize._version)
    hit = _cache.get(key)
    if hit is not None:
        return hit[0]
    index = occ.get_device()  # -1 on the CPU
    v = gridsize.shape[0]
    if v < 1 or grids_flat.shape[0] >= 2 ** 31:
        raise ValueError(f"the traversal kernels index the cells of all volumes in 32 bits: "
                         f"{v} volumes of {grids_flat.shape[0]} cells in all")
    g3 = grids_flat.shape[0] // v
    side = round(g3 ** (1.0 / 3.0))
    m3 = occ.shape[2]
    mside = round(m3 ** (1.0 / 3.0))
    if side ** 3 != g3 or mside ** 3 != m3:
        raise ValueError("grids and occupancy must be padded cubes")
    f32, i32 = torch.float32, torch.int32
    for name, x, dtype, shape in (("grids_flat", grids_flat, i32, (v * g3,)),
                                  ("gridsize", gridsize, i32, (v,)), ("inv", inv, f32, (v, 4, 4)),
                                  ("fwd", fwd, f32, (v, 4, 4)), ("cube_min", cube_min, f32, (v, 3)),
                                  ("bricksize", bricksize, i32, (v,)),
                                  ("occ", occ, i32, (3, v, m3, 16))):
        _check(name, x, dtype, torch.Size(shape), index)
    vtab, bm = scene_tables(gridsize, inv, fwd, cube_min, occ, bricksize)
    wbox = world_boxes(inv, cube_min)
    tb = Tables(vtab, bm, wbox, v, side, mside, bm.shape[1],
                (vtab.data_ptr(), bm.data_ptr(), occ.data_ptr(), grids_flat.data_ptr(),
                 wbox.data_ptr()), index)
    if len(_cache) >= CACHE_SIZE:
        del _cache[next(iter(_cache))]  # the oldest
    # the entry goes with the first of its sources' owners to be freed; the
    # references live in the entry, so they go with it
    refs = tuple(weakref.ref(_owner(x), lambda _, k=key: _cache.pop(k, None))
                 for x in (grids_flat, gridsize, inv, fwd, cube_min, occ, bricksize))
    _cache[key] = (tb, refs)
    return tb


def variant_of(mode, count_iters=False, ablate=()):
    """The kernel variant (VAR_* set) of a ``traverse`` call; raises for
    what the port does not have."""
    for stage in ablate:
        if stage in ("cand", "pal"):
            raise ValueError(
                f"ablate={stage!r}: the port's nearest-hit kernel has no such stage (it walks "
                f"the volumes in index order without a candidate list, and reads materials "
                f"from the grids, with no palette tables)")
        if stage != "norm":
            raise ValueError(f"ablate: unknown stage {stage!r}")
    var = (VAR_COUNT if count_iters else 0) | (VAR_NO_NORMALS if "norm" in ablate else 0)
    if var == VAR_COUNT | VAR_NO_NORMALS:
        raise ValueError("count_iters with ablate=('norm',): K1 has the two variants one at a "
                         "time")
    if var and mode != "nearest":
        raise ValueError(f"count_iters and ablate are nearest mode only: the JAX kernel counts "
                         f"no trips in {mode!r} mode and returns its hit alone")
    return var


def traverse_plain(grids_flat, gridsize, inv, fwd, cube_min, o, d, t_limit,
                   ray_active, vol_enabled, occ, bricksize, mode="nearest", tally=None,
                   ray_tally=None, count_iters=False, ablate=()):
    """The plain version of ``traverse``: dda_occ.traverse_occ, on any
    device, with t_limit None as BIG and vol_enabled None as every volume
    (``tally`` and ``ray_tally`` as there); count_iters adds the kernel's
    trips (``dda_occ.walk_trips``), ablate=("norm",) zeroes the normals."""
    var = variant_of(mode, count_iters, ablate)
    dev = o.device
    if t_limit is None:
        t_limit = torch.full((o.shape[0],), BIG, dtype=torch.float32, device=dev)
    if vol_enabled is None:
        vol_enabled = torch.ones(gridsize.shape[0], dtype=torch.bool, device=dev)
    args = (grids_flat, gridsize, inv, fwd, cube_min, o, d, t_limit, ray_active, vol_enabled,
            occ, bricksize)
    out = traverse_occ(*args, mode=mode, tally=tally, ray_tally=ray_tally)
    if var & VAR_NO_NORMALS:
        out.update({c: torch.zeros_like(out[c]) for c in ("nx", "ny", "nz")})
    if var & VAR_COUNT:
        out["iters"] = walk_trips(*args)
    return out


def traverse(grids_flat, gridsize, inv, fwd, cube_min, o, d, t_limit,
             ray_active, vol_enabled, occ, bricksize, mode="nearest", count_iters=False,
             ablate=()):
    """Nearest hit (K1) or any hit before t_limit (K2) over all volumes.

    o, d: [N, 3] f32; t_limit [N] f32 or None (no limit: BIG); ray_active
    [N] bool; vol_enabled [V] bool or None (every volume).  Returns
    dict(hit, t, cell, vol, nx, ny, nz) for "nearest", dict(hit) for
    "occluded".  Nearest mode only, each a variant of K1: count_iters adds
    ``iters`` [N] int32, each ray's outer trips through the walk summed over
    the volumes it walks (0 for an inactive ray); ablate=("norm",) skips
    the normal epilogue and returns zero normals.  hit, t, vol and cell are
    the same with either."""
    if mode == "nearest":
        code = 0
    elif mode == "occluded":
        code = 1
    else:
        raise ValueError(f"mode {mode!r}")
    var = variant_of(mode, count_iters, ablate)
    if not o.is_cuda:
        if o.is_cpu:
            return traverse_plain(grids_flat, gridsize, inv, fwd, cube_min, o, d, t_limit,
                                  ray_active, vol_enabled, occ, bricksize, mode=mode,
                                  count_iters=count_iters, ablate=ablate)
        raise ValueError(f"no traversal for device {o.device}")
    index = o.get_device()
    tb = tables(grids_flat, gridsize, inv, fwd, cube_min, occ, bricksize)
    if tb.device != index:
        raise ValueError(f"the volumes are on cuda:{tb.device}, the rays on cuda:{index}")
    n = o.shape[0]
    n3, n1 = torch.Size((n, 3)), torch.Size((n,))
    _check("o", o, torch.float32, n3, index)
    _check("d", d, torch.float32, n3, index)
    _check("ray_active", ray_active, torch.bool, n1, index)
    if t_limit is not None:
        _check("t_limit", t_limit, torch.float32, n1, index)
    if vol_enabled is not None:
        _check("vol_enabled", vol_enabled, torch.bool, torch.Size((tb.v,)), index)
    if code == 0:
        # one allocation: t, vol, cell, nx, ny, nz (the trips), then the hit bytes
        fields = 7 if var & VAR_COUNT else 6
        buf = torch.empty(fields * n + -(-n // 4), dtype=torch.float32, device=o.device)
        t, vol, cell, nx, ny, nz, *iters, hb = buf.split_with_sizes((n,) * fields
                                                                    + (-(-n // 4),))
        hit = hb.view(torch.bool)
        if n % 4:
            hit = hit[:n]
    else:
        buf = hit = torch.empty(n, dtype=torch.bool, device=o.device)
    build.check(build.lib().vt_traverse(
        code, var, o.data_ptr(), d.data_ptr(),
        None if t_limit is None else t_limit.data_ptr(), ray_active.data_ptr(),
        None if vol_enabled is None else vol_enabled.data_ptr(), *tb.ptrs, n, tb.v, tb.side,
        tb.mside, tb.words, buf.data_ptr(),
        # the current stream as an int, without building a Stream object
        torch._C._cuda_getCurrentRawStream(index)), f"traverse({mode})")
    if code == 1:
        launches["traverse_occluded"] += 1
        return dict(hit=hit)
    launches[("traverse_nearest", "traverse_nearest_count", "traverse_nearest_no_normals")[var]] += 1
    out = dict(hit=hit, t=t, cell=cell.view(torch.int32), vol=vol.view(torch.int32),
               nx=nx, ny=ny, nz=nz)
    if iters:
        out["iters"] = iters[0].view(torch.int32)
    return out


def exit_march_plain(grids_flat, gridsize, inv, fwd, cube_min, o, d,
                     ray_active, mode_code, vol_match, occ, bricksize, tally=None):
    """The plain version of ``exit_march``: dda_occ.traverse_occ in exit
    mode, on any device (``tally`` as there)."""
    dev = o.device
    return traverse_occ(grids_flat, gridsize, inv, fwd, cube_min, o, d,
                        torch.full((o.shape[0],), BIG, dtype=torch.float32, device=dev),
                        ray_active, torch.ones(gridsize.shape[0], dtype=torch.bool, device=dev),
                        occ, bricksize, mode="exit", mode_code=mode_code,
                        vol_match=vol_match, tally=tally)


def exit_march(grids_flat, gridsize, inv, fwd, cube_min, o, d, ray_active,
               mode_code, vol_match, occ, bricksize):
    """Material-exit march (K3): each ray through its own volume vol_match
    [N] i32 until it leaves the medium mode_code [N] i32 selects
    (dda.EXIT_GLASS / EXIT_SMOKE) or the grid.  Returns dict(in_vol, t,
    cell, nx, ny, nz)."""
    if not o.is_cuda:
        if o.is_cpu:
            return exit_march_plain(grids_flat, gridsize, inv, fwd, cube_min, o, d,
                                    ray_active, mode_code, vol_match, occ, bricksize)
        raise ValueError(f"no exit march for device {o.device}")
    index = o.get_device()
    tb = tables(grids_flat, gridsize, inv, fwd, cube_min, occ, bricksize)
    if tb.device != index:
        raise ValueError(f"the volumes are on cuda:{tb.device}, the rays on cuda:{index}")
    n = o.shape[0]
    n3, n1 = torch.Size((n, 3)), torch.Size((n,))
    _check("o", o, torch.float32, n3, index)
    _check("d", d, torch.float32, n3, index)
    _check("ray_active", ray_active, torch.bool, n1, index)
    _check("mode_code", mode_code, torch.int32, n1, index)
    _check("vol_match", vol_match, torch.int32, n1, index)
    # one allocation: t, cell, nx, ny, nz, then the in-volume bytes
    buf = torch.empty(5 * n + -(-n // 4), dtype=torch.float32, device=o.device)
    t, cell, nx, ny, nz, ib = buf.split_with_sizes((n, n, n, n, n, -(-n // 4)))
    build.check(build.lib().vt_exit_march(
        o.data_ptr(), d.data_ptr(), ray_active.data_ptr(), mode_code.data_ptr(),
        vol_match.data_ptr(), *tb.ptrs, n, tb.v, tb.side, tb.mside, tb.words, buf.data_ptr(),
        torch._C._cuda_getCurrentRawStream(index)), "exit_march")
    launches["exit_march"] += 1
    in_vol = ib.view(torch.bool)
    return dict(in_vol=in_vol[:n] if n % 4 else in_vol, t=t, cell=cell.view(torch.int32),
                nx=nx, ny=ny, nz=nz)


def launch_floor(n, device):
    """Launch K1-K3's grid for n rays with a kernel that does nothing, on
    the current stream of CUDA `device`: what a launch of that grid costs
    (a measuring aid; no path calls it)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    build.check(build.lib().vt_launch_floor(n, torch._C._cuda_getCurrentRawStream(index)),
                "launch_floor")
