"""Voxel traversal wrappers over the CUDA kernels of csrc/traverse.cu
(counterpart of voxtracer/kernels/pallas_dda.py).

``traverse`` (nearest hit or occlusion over all volumes) and
``exit_march`` (each ray through its own glass or smoke volume) take the
same arguments and return the same dicts as the plain version,
``dda_occ.traverse_occ``.  A CUDA tensor goes through the kernel; a CPU
tensor goes through the plain version.  ``launches`` counts kernel
launches per kernel.
"""

from __future__ import annotations

import torch

from voxtracer_torch.kernels import build
from voxtracer_torch.kernels.dda import BIG
from voxtracer_torch.kernels.dda_occ import traverse_occ

MAX_V = 64  # candidate list held per thread (csrc/traverse.cu MAX_V)

launches = {"traverse_nearest": 0, "traverse_occluded": 0, "exit_march": 0}


def _require(name, x, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _scene_args(grids_flat, gridsize, inv, fwd, cube_min, occ, bricksize, device):
    """Check the volume tables and return (ptrs, v, side, mside)."""
    v = gridsize.shape[0]
    if not 1 <= v <= MAX_V:
        raise ValueError(f"the traversal kernel takes 1..{MAX_V} volumes, got {v}")
    g3 = grids_flat.shape[0] // v
    side = round(g3 ** (1.0 / 3.0))
    m3 = occ.shape[2]
    mside = round(m3 ** (1.0 / 3.0))
    if side ** 3 != g3 or mside ** 3 != m3:
        raise ValueError("grids and occupancy must be padded cubes")
    f32, i32 = torch.float32, torch.int32
    _require("grids_flat", grids_flat, i32, (v * g3,), device)
    _require("gridsize", gridsize, i32, (v,), device)
    _require("inv", inv, f32, (v, 4, 4), device)
    _require("fwd", fwd, f32, (v, 4, 4), device)
    _require("cube_min", cube_min, f32, (v, 3), device)
    _require("bricksize", bricksize, i32, (v,), device)
    _require("occ", occ, i32, (3, v, m3, 16), device)
    if occ.data_ptr() % 16:
        raise ValueError("occ: rows are read as 16-byte vectors; must be 16-byte aligned")
    ptrs = [x.data_ptr() for x in (grids_flat, gridsize, inv, fwd, cube_min,
                                   bricksize, occ)]
    return ptrs, v, side, mside


def traverse(grids_flat, gridsize, inv, fwd, cube_min, o, d, t_limit,
             ray_active, vol_enabled, occ, bricksize, mode="nearest"):
    """Nearest hit (K1) or any hit before t_limit (K2) over all volumes.

    o, d: [N, 3] f32; t_limit [N] f32; ray_active [N] bool; vol_enabled
    [V] bool.  Returns dict(hit, t, cell, vol, nx, ny, nz) for "nearest",
    dict(hit) for "occluded"."""
    if mode not in ("nearest", "occluded"):
        raise ValueError(f"mode {mode!r}")
    if o.device.type == "cpu":
        return traverse_occ(grids_flat, gridsize, inv, fwd, cube_min, o, d,
                            t_limit, ray_active, vol_enabled, occ, bricksize,
                            mode=mode)
    if o.device.type != "cuda":
        raise ValueError(f"no traversal for device {o.device}")
    dev = o.device
    n = o.shape[0]
    ptrs, v, side, mside = _scene_args(grids_flat, gridsize, inv, fwd,
                                       cube_min, occ, bricksize, dev)
    _require("o", o, torch.float32, (n, 3), dev)
    _require("d", d, torch.float32, (n, 3), dev)
    _require("t_limit", t_limit, torch.float32, (n,), dev)
    _require("ray_active", ray_active, torch.bool, (n,), dev)
    _require("vol_enabled", vol_enabled, torch.bool, (v,), dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    if mode == "nearest":
        t = torch.empty(n, dtype=torch.float32, device=dev)
        vol = torch.empty(n, dtype=torch.int32, device=dev)
        cell = torch.empty(n, dtype=torch.int32, device=dev)
        nx, ny, nz = (torch.empty(n, dtype=torch.float32, device=dev)
                      for _ in range(3))
        outs = [x.data_ptr() for x in (hit, t, vol, cell, nx, ny, nz)]
    else:
        outs = [hit.data_ptr()] + [None] * 6
    status = build.lib().vt_traverse(
        0 if mode == "nearest" else 1, o.data_ptr(), d.data_ptr(),
        t_limit.data_ptr(), ray_active.data_ptr(), vol_enabled.data_ptr(),
        *ptrs, n, v, side, mside, *outs,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, f"traverse({mode})")
    launches[f"traverse_{mode}"] += 1
    if mode == "occluded":
        return dict(hit=hit)
    return dict(hit=hit, t=t, cell=cell, vol=vol, nx=nx, ny=ny, nz=nz)


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
    if o.device.type == "cpu":
        return exit_march_plain(grids_flat, gridsize, inv, fwd, cube_min, o, d,
                                ray_active, mode_code, vol_match, occ, bricksize)
    if o.device.type != "cuda":
        raise ValueError(f"no exit march for device {o.device}")
    dev = o.device
    n = o.shape[0]
    ptrs, v, side, mside = _scene_args(grids_flat, gridsize, inv, fwd,
                                       cube_min, occ, bricksize, dev)
    _require("o", o, torch.float32, (n, 3), dev)
    _require("d", d, torch.float32, (n, 3), dev)
    _require("ray_active", ray_active, torch.bool, (n,), dev)
    _require("mode_code", mode_code, torch.int32, (n,), dev)
    _require("vol_match", vol_match, torch.int32, (n,), dev)
    in_vol = torch.empty(n, dtype=torch.bool, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    cell = torch.empty(n, dtype=torch.int32, device=dev)
    nx, ny, nz = (torch.empty(n, dtype=torch.float32, device=dev) for _ in range(3))
    status = build.lib().vt_exit_march(
        o.data_ptr(), d.data_ptr(), ray_active.data_ptr(), mode_code.data_ptr(),
        vol_match.data_ptr(), *ptrs, n, v, side, mside,
        *(x.data_ptr() for x in (in_vol, t, cell, nx, ny, nz)),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "exit_march")
    launches["exit_march"] += 1
    return dict(in_vol=in_vol, t=t, cell=cell, nx=nx, ny=ny, nz=nz)
