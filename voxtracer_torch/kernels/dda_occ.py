"""Occupancy-bitmask traversal in plain torch: the plain version of the
CUDA traversal kernels (counterpart of voxtracer/kernels/dda_occ.py's
dense ``traverse_occ``).

All rays x all volumes walk as [V, N] pairs in lockstep.  One outer
iteration fetches the 512-bit occupancy row of each pair's current brick,
takes one macro DDA step for pairs over an empty brick, descends into an
occupied brick (re-seeding the fine DDA at t + 5e-5 and clamping it into
the brick), and takes up to INNER fine cell steps that test register
bits.  The hit t is the crossing t, updated before the bounds checks.
The nearest merge is an argmin over volumes, so the earliest volume wins
exact ties — the same results as the JAX package's ``traverse_occ_topk``
and as the sorted per-ray walk of csrc/traverse.cu.
"""

from __future__ import annotations

import torch

from voxtracer_torch.core.types import MAT_NONE, OCC_EXIT_GLASS, OCC_EXIT_SMOKE
from voxtracer_torch.kernels.dda import (BIG, BRICK, EXIT_SMOKE, cell_index,
                                         inside_cube, object_rays, pick_axis,
                                         setup, slab_entry)

INNER = 8  # fine steps per outer iteration
MAX_OUTER = 1024
# what ``tally`` counts, over [V, N] pairs: pairs tested for entry, pairs
# whose walk starts, outer iterations (one row fetch each), descents into
# a brick, fine cell steps and macro brick steps
STEPS = ("entries", "walks", "rows", "descends", "cells", "bricks")


def normals_from(r, gs_f, fwd_rows, t):
    """GetNormalVoxel (scene.cpp:121-148) with per-pair forward-matrix
    components fwd_rows = (m00, m01, ..., m22)."""
    def frac(o, dc):
        i1 = (o + t * dc) * gs_f
        fg = i1 - torch.floor(i1)
        return torch.minimum(fg, 1.0 - fg)

    ddx = frac(r["ox"], r["dx"])
    ddy = frac(r["oy"], r["dy"])
    ddz = frac(r["oz"], r["dz"])
    mind = torch.minimum(ddx, torch.minimum(ddy, ddz))
    nx = torch.where(ddx == mind, r["sx"] * 2.0 - 1.0, 0.0)
    ny = torch.where(ddy == mind, r["sy"] * 2.0 - 1.0, 0.0)
    nz = torch.where(ddz == mind, r["sz"] * 2.0 - 1.0, 0.0)
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = fwd_rows
    wx = m00 * nx + m01 * ny + m02 * nz
    wy = m10 * nx + m11 * ny + m12 * nz
    wz = m20 * nx + m21 * ny + m22 * nz
    inv_len = torch.rsqrt(torch.clamp(wx * wx + wy * wy + wz * wz, min=1e-20))
    return wx * inv_len, wy * inv_len, wz * inv_len


def _core(r, c, occ_flat, tl, active0, mode, tally=None):
    """The fetch / descend / step loop over [P, N] pair state.  Returns the
    final hit, t_hit, gidx, in_vol and t_out, and adds the walk's STEPS to
    the dict ``tally`` if one is given."""
    is_exit = mode == "exit"
    bx, by, bz = c["bx"], c["by"], c["bz"]
    gs_f, gs_i, ms_i = c["gs_f"], c["gs_i"], c["ms_i"]
    side, mside = c["side"], c["mside"]
    cellw = 1.0 / gs_f

    s = setup(r, bx, by, bz, gs_f, gs_i)         # fine level
    sm = setup(r, bx, by, bz, c["ms_f"], ms_i)   # macro level
    valid, t0 = sm["valid"], sm["t0"]
    active = active0 & valid
    if not is_exit:
        active = active & (t0 < tl)
    shape = active.shape
    steps = None if tally is None else torch.zeros(len(STEPS), dtype=torch.int64,
                                                   device=active.device)

    def count(step, x):
        if steps is not None:
            steps[STEPS.index(step)] += x.sum()

    count("entries", active0)
    count("walks", active)

    def full(x):
        return x.expand(shape).clone()

    t = full(t0)
    level = torch.zeros(shape, dtype=torch.bool, device=t.device)
    hit = torch.zeros_like(level)
    in_vol = torch.zeros_like(level)
    t_hit = torch.zeros_like(t)
    gidx = torch.zeros(shape, dtype=torch.int32, device=t.device)
    t_out = full(torch.where(valid, t0, 0.0))
    px, py, pz = full(s["px"]), full(s["py"]), full(s["pz"])
    tmx, tmy, tmz = full(s["tmx"]), full(s["tmy"]), full(s["tmz"])
    mpx, mpy, mpz = full(sm["px"]), full(sm["py"]), full(sm["pz"])
    mtmx, mtmy, mtmz = full(sm["tmx"]), full(sm["tmy"]), full(sm["tmz"])
    stx, sty, stz = s["stx"], s["sty"], s["stz"]
    nrows = occ_flat.shape[0]

    def fine_init_at(tt):
        """Setup3DDDA position seeding (scene.cpp:736-745) at t."""
        def axis(oc, dc, rdc, sc, b0):
            pos = gs_f * ((oc - b0) + (tt + 5e-5) * dc)
            pln = (torch.ceil(pos) - sc) * cellw
            return cell_index(pos, gs_i), (pln - (oc - b0)) * rdc

        fx, ftx = axis(r["ox"], r["dx"], r["rdx"], r["sx"], bx)
        fy, fty = axis(r["oy"], r["dy"], r["rdy"], r["sy"], by)
        fz, ftz = axis(r["oz"], r["dz"], r["rdz"], r["sz"], bz)
        return fx, fy, fz, ftx, fty, ftz

    outer = 0
    while outer < MAX_OUTER and bool(active.any()):
        # a ray's best recorded hit bounds all of its pairs; any hit
        # retires an occlusion ray.  Pruning is strictly-greater, so exact
        # ties stay alive for the earliest-volume tie-break.
        if mode == "occluded":
            active = active & ~hit.any(0, keepdim=True)
        elif not is_exit:
            best = torch.where(hit, t_hit, BIG).amin(0, keepdim=True)
            active = active & (t <= best)
        count("rows", active)

        # one row fetch per pair: the current brick's 512 occupancy bits
        midx = (mpx * mside + mpy) * mside + mpz
        rows = occ_flat[torch.clamp(c["occ_base"] + midx, 0, nrows - 1).long()]
        occupied = (rows != 0).any(-1)
        act_m = active & ~level
        descend = act_m & occupied
        skip = act_m & ~occupied
        count("descends", descend)

        # descend: (re)seed the fine DDA at t, clamped into the brick
        fpx, fpy, fpz, ftmx, ftmy, ftmz = fine_init_at(t)
        blox, bloy, bloz = mpx * BRICK, mpy * BRICK, mpz * BRICK
        fpx = torch.minimum(torch.maximum(fpx, blox), torch.minimum(blox + BRICK - 1, gs_i - 1))
        fpy = torch.minimum(torch.maximum(fpy, bloy), torch.minimum(bloy + BRICK - 1, gs_i - 1))
        fpz = torch.minimum(torch.maximum(fpz, bloz), torch.minimum(bloz + BRICK - 1, gs_i - 1))
        px = torch.where(descend, fpx, px)
        py = torch.where(descend, fpy, py)
        pz = torch.where(descend, fpz, pz)
        tmx = torch.where(descend, ftmx, tmx)
        tmy = torch.where(descend, ftmy, tmy)
        tmz = torch.where(descend, ftmz, tmz)

        # fine steps: register bit tests, no fetch
        act_f = active & (level | descend)
        go_macro = torch.zeros_like(act_f)
        for _ in range(INNER):
            count("cells", act_f)
            b = ((px - blox) * 8 + (py - bloy)) * 8 + (pz - bloz)
            word = torch.gather(rows, -1, ((b >> 5) & 15).long()[..., None])[..., 0]
            bit = (torch.bitwise_right_shift(word, b & 31) & 1) == 1
            pred = act_f & bit
            if not is_exit:
                pred = pred & (t < tl)
            hit = hit | pred
            t_hit = torch.where(pred, t, t_hit)
            gidx = torch.where(pred, c["cell_base"] + (px * side + py) * side + pz, gidx)
            if is_exit:
                in_vol = in_vol | pred
                t_out = torch.where(pred, t, t_out)
            act_f = act_f & ~pred

            use_x, use_y, use_z = pick_axis(tmx, tmy, tmz)
            t_new = torch.where(use_x, tmx, torch.where(use_y, tmy, tmz))
            px = px + torch.where(act_f & use_x, stx, 0)
            py = py + torch.where(act_f & use_y, sty, 0)
            pz = pz + torch.where(act_f & use_z, stz, 0)
            moved = torch.where(use_x, px, torch.where(use_y, py, pz))
            out_grid = (moved < 0) | (moved >= gs_i)
            blo = torch.where(use_x, blox, torch.where(use_y, bloy, bloz))
            out_brick = (moved < blo) | (moved >= blo + BRICK)
            tmx = tmx + torch.where(act_f & use_x, s["tdx"], 0.0)
            tmy = tmy + torch.where(act_f & use_y, s["tdy"], 0.0)
            tmz = tmz + torch.where(act_f & use_z, s["tdz"], 0.0)
            t = torch.where(act_f, t_new, t)
            if is_exit:
                t_out = torch.where(act_f & out_grid, t_new, t_out)
            else:
                act_f = act_f & (t_new < tl)
            go_macro = go_macro | (act_f & out_brick & ~out_grid)
            act_f = act_f & ~out_grid & ~out_brick

        # fine pairs end on a hit, off the grid or past the t limit
        was_fine = level | descend
        active = torch.where(was_fine, act_f | go_macro, active)
        level = was_fine & act_f

        # macro advance: empty-brick skips + fine walks that left a brick
        do_m = skip | go_macro
        count("bricks", do_m)
        mx, my, mz = pick_axis(mtmx, mtmy, mtmz)
        mt_new = torch.where(mx, mtmx, torch.where(my, mtmy, mtmz))
        mpx = mpx + torch.where(do_m & mx, stx, 0)
        mpy = mpy + torch.where(do_m & my, sty, 0)
        mpz = mpz + torch.where(do_m & mz, stz, 0)
        mmoved = torch.where(mx, mpx, torch.where(my, mpy, mpz))
        m_out = (mmoved < 0) | (mmoved >= ms_i)
        mtmx = mtmx + torch.where(do_m & mx, sm["tdx"], 0.0)
        mtmy = mtmy + torch.where(do_m & my, sm["tdy"], 0.0)
        mtmz = mtmz + torch.where(do_m & mz, sm["tdz"], 0.0)
        t = torch.where(do_m, mt_new, t)
        if is_exit:
            t_out = torch.where(do_m & m_out, mt_new, t_out)
        active = active & ~(do_m & m_out)
        if not is_exit:
            active = active & ~(do_m & ~(mt_new < tl))
        outer += 1

    if steps is not None:
        for step, n in zip(STEPS, steps.tolist()):
            tally[step] = tally.get(step, 0) + n
    return dict(hit=hit, t_hit=t_hit, gidx=gidx, in_vol=in_vol, t_out=t_out)


def traverse_occ(grids_flat, gridsize, inv, fwd, cube_min, o, d, t_limit,
                 ray_active, vol_enabled, occ, bricksize, mode="nearest",
                 mode_code=None, vol_match=None, tally=None):
    """All rays x all volumes over occupancy bitmasks.

    occ: [3, V, M^3, 16] int32 (core.types OCC_* planes).  Returns per-ray
    [N] results: mode "nearest": hit, t, cell, vol, nx, ny, nz;
    "occluded": hit; "exit": in_vol, t, cell, nx, ny, nz (vol_match [N]
    names each ray's own volume, mode_code [N] its medium).  A dict
    ``tally`` gains the walk's STEPS: the work these rays need, which sets
    the kernels' operation bound."""
    v = gridsize.shape[0]
    is_exit = mode == "exit"
    dev = o.device
    r = object_rays(inv, o, d)

    g3 = grids_flat.shape[0] // v
    side = round(g3 ** (1.0 / 3.0))
    assert side ** 3 == g3, "grids must be padded cubes"
    m3 = occ.shape[2]
    mside = round(m3 ** (1.0 / 3.0))
    assert mside ** 3 == m3, "occ must be padded cubes"
    occ_flat = occ.reshape(3 * v * m3, 16)
    vids = torch.arange(v, dtype=torch.int32, device=dev)[:, None]
    if is_exit:
        plane = torch.where(mode_code[None, :] == EXIT_SMOKE, OCC_EXIT_SMOKE,
                            OCC_EXIT_GLASS).to(torch.int32) * (v * m3)
        match = vol_match[None, :] == vids
        occ_base = plane + vids * m3
        active0 = ray_active[None, :] & match
    else:
        occ_base = vids * m3
        active0 = ray_active[None, :] & vol_enabled[:, None]

    gs_f = gridsize.to(torch.float32)[:, None]
    c = dict(bx=cube_min[:, 0:1], by=cube_min[:, 1:2], bz=cube_min[:, 2:3],
             gs_f=gs_f, gs_i=gridsize[:, None],
             ms_f=bricksize.to(torch.float32)[:, None], ms_i=bricksize[:, None],
             side=side, mside=mside, cell_base=vids * g3, occ_base=occ_base)
    st = _core(r, c, occ_flat, t_limit[None, :], active0, mode, tally)

    if mode == "occluded":
        return dict(hit=st["hit"].any(0))

    fwd_rows = tuple(fwd[:, i, j][:, None] for i in range(3) for j in range(3))
    nmax = grids_flat.shape[0] - 1
    if is_exit:
        nx, ny, nz = normals_from(r, gs_f, fwd_rows, st["t_out"])

        def pick(a):
            return torch.where(match, a, 0).sum(0)

        gidx_ray = pick(torch.where(st["in_vol"], st["gidx"], 0))
        cell = grids_flat[torch.clamp(gidx_ray, 0, nmax).long()]
        in_v = (st["in_vol"] & match).any(0)
        iv = st["in_vol"]
        return dict(in_vol=in_v, t=pick(st["t_out"]),
                    cell=torch.where(in_v, cell, MAT_NONE),
                    nx=pick(torch.where(iv, nx, 0.0)),
                    ny=pick(torch.where(iv, ny, 0.0)),
                    nz=pick(torch.where(iv, nz, 0.0)))

    # nearest: merge volumes, the earliest volume wins ties (argmin is first-min)
    t_pair = torch.where(st["hit"], st["t_hit"], BIG)
    win = torch.argmin(t_pair, dim=0)
    winm = (win[None, :] == vids) & st["hit"]
    nx, ny, nz = normals_from(r, gs_f, fwd_rows, st["t_hit"])

    def pick(a, zero):
        return torch.where(winm, a, zero).sum(0)

    any_hit = st["hit"].any(0)
    gidx_ray = pick(st["gidx"], 0)
    mat = grids_flat[torch.clamp(gidx_ray, 0, nmax).long()]
    return dict(
        hit=any_hit,
        t=torch.where(any_hit, t_pair.amin(0), BIG),
        cell=torch.where(any_hit, mat, MAT_NONE),
        vol=torch.where(any_hit, win.to(torch.int32), -2),
        nx=pick(nx, 0.0), ny=pick(ny, 0.0), nz=pick(nz, 0.0),
    )


def entry_t(inv, cube_min, o, d):
    """Per-pair cube entry t [V, N] (BIG on a miss, 0 when inside)."""
    r = object_rays(inv, o, d)
    bx, by, bz = cube_min[:, 0:1], cube_min[:, 1:2], cube_min[:, 2:3]
    return torch.where(inside_cube(bx, by, bz, r), 0.0, slab_entry(bx, by, bz, r))
