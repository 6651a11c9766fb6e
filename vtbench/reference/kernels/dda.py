"""3D-DDA in plain torch (counterpart of voxtracer/kernels/dda.py): the
building blocks (object-space rays, the cube slab test, the Setup3DDDA
seeding and the reference's axis pick), ``traverse`` (nearest with a
material skip range, occluded and exit; one level or over bricks) and
its single-volume wrappers.

Every function works on broadcastable [P, N] pair tensors and rounds as
the JAX version does; the CUDA traversal (csrc/traverse.cu) spells out
the same arithmetic in the same order.  Float -> int conversions go
through ``cell_index``, which saturates as XLA and CUDA do (torch's CPU
cast does not).
"""

from __future__ import annotations

import torch

from vtbench.reference.core.types import GLASS, MAT_NONE, SMOKE_LOW_DENSITY, SMOKE_PLAYER

BIG = 1e34
BRICK = 8
UNROLL = 4  # DDA steps between two tests for a pair still walking

# leave-predicate codes for exit marches
EXIT_GLASS = 0  # leave when cell != GLASS        (FindMaterialExit)
EXIT_SMOKE = 1  # leave when cell outside smoke   (FindSmokeExit)


def cell_index(pos, gs_i):
    """clip(int32(pos), 0, gs_i - 1) with a saturating, NaN -> 0 cast."""
    p = torch.clamp(pos, -1.0, 16777216.0).to(torch.int32)
    return torch.minimum(torch.clamp(p, min=0), gs_i - 1)


def object_rays(inv, o, d):
    """World rays [N, 3] -> object-space components [V, N] per volume
    (the SSE transform block, renderer.cpp:959-975)."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]

    def tr(row, px, py, pz, point):
        c = row[:, None, :]  # [V, 1, 4]
        out = c[..., 0] * px + c[..., 1] * py + c[..., 2] * pz
        return out + c[..., 3] if point else out

    vdx = tr(inv[:, 0], dx, dy, dz, False)
    vdy = tr(inv[:, 1], dx, dy, dz, False)
    vdz = tr(inv[:, 2], dx, dy, dz, False)
    return dict(
        ox=tr(inv[:, 0], ox, oy, oz, True), oy=tr(inv[:, 1], ox, oy, oz, True),
        oz=tr(inv[:, 2], ox, oy, oz, True),
        dx=vdx, dy=vdy, dz=vdz,
        rdx=1.0 / vdx, rdy=1.0 / vdy, rdz=1.0 / vdz,
        sx=torch.signbit(vdx).to(torch.float32),
        sy=torch.signbit(vdy).to(torch.float32),
        sz=torch.signbit(vdz).to(torch.float32),
    )


def slab_entry(bx, by, bz, r):
    """Cube::Intersect (scene.cpp:166-202) for the cube [b, b + 1]."""
    def axis(b0, o, d, rd):
        neg = d < 0.0
        lo = torch.where(neg, b0 + 1.0, b0)
        hi = torch.where(neg, b0, b0 + 1.0)
        return (lo - o) * rd, (hi - o) * rd

    tminx, tmaxx = axis(bx, r["ox"], r["dx"], r["rdx"])
    tminy, tmaxy = axis(by, r["oy"], r["dy"], r["rdy"])
    tminz, tmaxz = axis(bz, r["oz"], r["dz"], r["rdz"])
    miss = (tminx > tmaxy) | (tminy > tmaxx)
    t0 = torch.maximum(tminx, tminy)
    t1 = torch.minimum(tmaxx, tmaxy)
    miss = miss | (t0 > tmaxz) | (tminz > t1)
    t0 = torch.maximum(t0, tminz)
    return torch.where(miss | (t0 <= 0.0), BIG, t0)


def inside_cube(bx, by, bz, r):
    return ((r["ox"] >= bx) & (r["ox"] <= bx + 1.0)
            & (r["oy"] >= by) & (r["oy"] <= by + 1.0)
            & (r["oz"] >= bz) & (r["oz"] <= bz + 1.0))


def setup(r, bx, by, bz, gs_f, gs_i):
    """Setup3DDDA (scene.cpp:719-749) at one grid level."""
    t0 = torch.where(inside_cube(bx, by, bz, r), 0.0, slab_entry(bx, by, bz, r))
    cell = 1.0 / gs_f

    def axis(o, d, rd, sgn, b0):
        pos = gs_f * ((o - b0) + (t0 + 5e-5) * d)
        plane = (torch.ceil(pos) - sgn) * cell
        stepf = 1.0 - sgn * 2.0
        return (cell_index(pos, gs_i), stepf.to(torch.int32),
                cell * stepf * rd, (plane - (o - b0)) * rd)

    px, stx, tdx, tmx = axis(r["ox"], r["dx"], r["rdx"], r["sx"], bx)
    py, sty, tdy, tmy = axis(r["oy"], r["dy"], r["rdy"], r["sy"], by)
    pz, stz, tdz, tmz = axis(r["oz"], r["dz"], r["rdz"], r["sz"], bz)
    return dict(valid=t0 < 1e33, t0=t0,
                px=px, py=py, pz=pz, stx=stx, sty=sty, stz=stz,
                tdx=tdx, tdy=tdy, tdz=tdz, tmx=tmx, tmy=tmy, tmz=tmz)


def pick_axis(tmx, tmy, tmz):
    """Reference branch structure (scene.cpp:773-801), NaN semantics kept."""
    first = tmx < tmy
    use_x = first & (tmx < tmz)
    use_y = ~first & (tmy < tmz)
    return use_x, use_y, ~(use_x | use_y)


def traverse(grids_flat, gridsize, inv, fwd, cube_min, o, d, t_limit, ray_active,
             vol_enabled, skip_lo, skip_hi, mode: str = "nearest", mode_code=None,
             vol_match=None, bricks_flat=None, bricksize=None, max_steps: int = 4096):
    """Every ray walked through all volumes: the JAX package's
    ``dda.traverse``.  All [V, N] (volume, ray) pairs walk in lockstep,
    UNROLL DDA steps between two tests for a pair still walking, until no
    pair walks or max_steps.  The hit t is the crossing t, updated before
    the bounds test.

    mode "nearest": the nearest cell whose material is not MAT_NONE and
    not in [skip_lo, skip_hi] (no skip range when skip_lo > skip_hi),
    before t_limit, over the enabled volumes (vol_enabled [V]); volumes
    merge by argmin, the earliest winning exact ties.  -> dict(hit, t,
    cell, vol, nx, ny, nz) of [N]; a miss has vol -2.  mode "occluded":
    whether there is such a cell -> dict(hit).  mode "exit": the march
    out of the material each ray is in (FindMaterialExit /
    FindSmokeExit; scene.cpp:719-1047 holds the reference's walks): mode_code [N] (EXIT_GLASS: leave
    at a cell other than GLASS; EXIT_SMOKE: leave at a cell outside the
    smoke materials), each ray in volume vol_match [N], no t limit ->
    dict(in_vol, t, cell, nx, ny, nz), the cell and normals only where
    in_vol (the march ended in a cell of the grid); a ray that falls off
    the grid gets the crossing t of its boundary.

    Without bricks_flat the walk is the one-level DDA over cells.  With
    bricks_flat (the uniform value of each 8^3 brick, BRICK_MIXED where
    mixed) and bricksize it is the two-level walk (FindNearestPlayer's,
    renderer.cpp:1020-1071, which the game's probe runs): a pair on the
    macro level skips a brick it may pass (empty or in the skip range;
    in exit mode: uniformly of the material it marches through) with one
    macro DDA step, else descends, re-seeding the fine DDA at t + 5e-5
    clamped into the brick, and walks cells until it stops, leaves the
    brick (back to the macro level) or leaves the grid.  o, d: [N, 3];
    t_limit, ray_active: [N].
    """
    from vtbench.reference.kernels.dda_occ import normals_from

    v = gridsize.shape[0]
    dev = o.device
    i32 = torch.int32
    is_exit = mode == "exit"
    use_bricks = bricks_flat is not None
    r = object_rays(inv, o, d)
    bx, by, bz = cube_min[:, 0:1], cube_min[:, 1:2], cube_min[:, 2:3]
    gs_f, gs_i = gridsize.to(torch.float32)[:, None], gridsize[:, None]
    g3 = grids_flat.shape[0] // v
    side = round(g3 ** (1.0 / 3.0))
    assert side ** 3 == g3, "grids must be padded cubes"
    vol_base = (torch.arange(v, dtype=i32, device=dev) * g3)[:, None]
    tl = t_limit[None, :]
    if is_exit:
        match = vol_match[None, :] == torch.arange(v, dtype=i32, device=dev)[:, None]
        glass_mode = mode_code[None, :] == EXIT_GLASS

    def in_skip(vals):
        return (vals >= skip_lo) & (vals <= skip_hi) & (skip_hi >= skip_lo)

    def leave(act, vals, t):
        """Where a pair on a fine cell stops: a hit, or leaving its material."""
        if is_exit:
            return act & torch.where(glass_mode, vals != GLASS,
                                     (vals > SMOKE_PLAYER) | (vals < SMOKE_LOW_DENSITY))
        return act & (vals != MAT_NONE) & (t < tl) & ~in_skip(vals)

    def passable(vals):
        """Whether a macro step may skip a uniform brick of value vals."""
        if is_exit:
            return torch.where(glass_mode, vals == GLASS,
                               (vals >= SMOKE_LOW_DENSITY) & (vals <= SMOKE_PLAYER))
        return (vals == MAT_NONE) | in_skip(vals)

    s = setup(r, bx, by, bz, gs_f, gs_i)    # fine level
    if use_bricks:
        ms_f, ms_i = bricksize.to(torch.float32)[:, None], bricksize[:, None]
        m3 = bricks_flat.shape[0] // v
        mside = round(m3 ** (1.0 / 3.0))
        assert mside ** 3 == m3, "bricks must be padded cubes"
        macro_base = (grids_flat.shape[0]
                      + (torch.arange(v, dtype=i32, device=dev) * m3)[:, None])
        table = torch.cat([grids_flat.to(i32), bricks_flat.to(i32)])
        sm = setup(r, bx, by, bz, ms_f, ms_i)   # macro level, same cube
    else:
        table = grids_flat.to(i32)
        sm = s
    last = table.shape[0] - 1
    if is_exit:
        active = ray_active[None, :] & match & sm["valid"]
    else:
        active = ray_active[None, :] & vol_enabled[:, None] & sm["valid"] & (sm["t0"] < tl)
    shape = active.shape

    def full(x):
        return x.expand(shape).clone()

    t = full(sm["t0"])
    t_out = full(torch.where(sm["valid"], sm["t0"], 0.0))
    hit = torch.zeros(shape, dtype=torch.bool, device=dev)
    in_vol = torch.zeros_like(hit)
    t_hit = torch.zeros_like(t)
    cell = torch.full(shape, MAT_NONE, dtype=i32, device=dev)
    px, py, pz = full(s["px"]), full(s["py"]), full(s["pz"])
    tmx, tmy, tmz = full(s["tmx"]), full(s["tmy"]), full(s["tmz"])
    stx, sty, stz = s["stx"], s["sty"], s["stz"]
    tdx, tdy, tdz = s["tdx"], s["tdy"], s["tdz"]
    if use_bricks:
        level = torch.zeros_like(hit)  # False: macro, True: fine
        mpx, mpy, mpz = full(sm["px"]), full(sm["py"]), full(sm["pz"])
        mtmx, mtmy, mtmz = full(sm["tmx"]), full(sm["tmy"]), full(sm["tmz"])
        blox = torch.zeros(shape, dtype=i32, device=dev)
        bloy, bloz = blox.clone(), blox.clone()
        mtdx, mtdy, mtdz = sm["tdx"], sm["tdy"], sm["tdz"]
    else:
        level = torch.ones_like(hit)   # every pair on the fine level
    cellw = 1.0 / gs_f

    def fine_init_at(tt):
        """Setup3DDDA's position seeding (scene.cpp:736-745) at t."""
        def axis(oc, dc, rdc, sc, b0):
            pos = gs_f * ((oc - b0) + (tt + 5e-5) * dc)
            pln = (torch.ceil(pos) - sc) * cellw
            return cell_index(pos, gs_i), (pln - (oc - b0)) * rdc

        fx, ftx = axis(r["ox"], r["dx"], r["rdx"], r["sx"], bx)
        fy, fty = axis(r["oy"], r["dy"], r["rdy"], r["sy"], by)
        fz, ftz = axis(r["oz"], r["dz"], r["rdz"], r["sz"], bz)
        return fx, fy, fz, ftx, fty, ftz

    def zi(m, a):
        return torch.where(m, a, 0)

    steps = 0
    while steps < max_steps and bool(active.any()):
        for _ in range(UNROLL):
            at_fine = level
            idx = (px * side + py) * side + pz + vol_base
            if use_bricks:
                macro_idx = macro_base + (mpx * mside + mpy) * mside + mpz
                idx = torch.where(at_fine, idx, macro_idx)
            vals = table[torch.clamp(idx, 0, last).long()]

            # fine pairs: the stop test, then one cell step
            act_f = active & at_fine
            pred = leave(act_f, vals, t)
            hit = hit | pred
            t_hit = torch.where(pred, t, t_hit)
            cell = torch.where(pred, vals, cell)
            if is_exit:
                in_vol = in_vol | pred
                t_out = torch.where(pred, t, t_out)
            act_f = act_f & ~pred
            use_x, use_y, use_z = pick_axis(tmx, tmy, tmz)
            t_new = torch.where(use_x, tmx, torch.where(use_y, tmy, tmz))
            npx = px + zi(act_f & use_x, stx)
            npy = py + zi(act_f & use_y, sty)
            npz = pz + zi(act_f & use_z, stz)
            moved = torch.where(use_x, npx, torch.where(use_y, npy, npz))
            out_grid = (moved < 0) | (moved >= gs_i)
            ntmx = tmx + torch.where(act_f & use_x, tdx, 0.0)
            ntmy = tmy + torch.where(act_f & use_y, tdy, 0.0)
            ntmz = tmz + torch.where(act_f & use_z, tdz, 0.0)
            nt = torch.where(act_f, t_new, t)
            if not use_bricks:
                if is_exit:
                    t_out = torch.where(act_f & out_grid, t_new, t_out)
                active = act_f & ~out_grid
                if not is_exit:
                    active = active & (t_new < tl)
                px, py, pz, tmx, tmy, tmz, t = npx, npy, npz, ntmx, ntmy, ntmz, nt
                continue
            if not is_exit:
                act_f = act_f & (t_new < tl)
            blo = torch.where(use_x, blox, torch.where(use_y, bloy, bloz))
            out_brick = (moved < blo) | (moved >= blo + BRICK)
            go_macro = act_f & out_brick & ~out_grid
            term_f = act_f & out_grid
            if is_exit:
                t_out = torch.where(term_f, t_new, t_out)
            nlevel = at_fine & ~go_macro
            nactive = torch.where(at_fine, act_f & ~term_f & ~go_macro | go_macro, active)

            # macro pairs: skip the brick or descend into it
            act_m = active & ~at_fine
            skip_ok = passable(vals) & act_m
            descend = act_m & ~skip_ok
            fpx, fpy, fpz, ftmx, ftmy, ftmz = fine_init_at(t)
            # the entry cell clamped into the brick, so that the macro and
            # fine bookkeeping agree where the seeding epsilon lands one
            # cell over a brick face
            nblox, nbloy, nbloz = mpx * BRICK, mpy * BRICK, mpz * BRICK
            fpx = torch.clamp(fpx, nblox, torch.minimum(nblox + BRICK - 1, gs_i - 1))
            fpy = torch.clamp(fpy, nbloy, torch.minimum(nbloy + BRICK - 1, gs_i - 1))
            fpz = torch.clamp(fpz, nbloz, torch.minimum(nbloz + BRICK - 1, gs_i - 1))
            px, py, pz = (torch.where(descend, fpx, npx), torch.where(descend, fpy, npy),
                          torch.where(descend, fpz, npz))
            tmx, tmy, tmz = (torch.where(descend, ftmx, ntmx), torch.where(descend, ftmy, ntmy),
                             torch.where(descend, ftmz, ntmz))
            blox, bloy, bloz = (torch.where(descend, nblox, blox),
                                torch.where(descend, nbloy, bloy),
                                torch.where(descend, nbloz, bloz))
            level = nlevel | descend

            # macro step: skipped bricks and fine walks that left a brick
            do_m = skip_ok | go_macro
            muse_x, muse_y, muse_z = pick_axis(mtmx, mtmy, mtmz)
            mt_new = torch.where(muse_x, mtmx, torch.where(muse_y, mtmy, mtmz))
            mpx = mpx + zi(do_m & muse_x, stx)
            mpy = mpy + zi(do_m & muse_y, sty)
            mpz = mpz + zi(do_m & muse_z, stz)
            mmoved = torch.where(muse_x, mpx, torch.where(muse_y, mpy, mpz))
            m_out = (mmoved < 0) | (mmoved >= ms_i)
            mtmx = mtmx + torch.where(do_m & muse_x, mtdx, 0.0)
            mtmy = mtmy + torch.where(do_m & muse_y, mtdy, 0.0)
            mtmz = mtmz + torch.where(do_m & muse_z, mtdz, 0.0)
            t = torch.where(do_m, mt_new, nt)
            if is_exit:
                t_out = torch.where(do_m & m_out, mt_new, t_out)
            active = nactive & ~(do_m & m_out)
            if not is_exit:
                active = active & ~(do_m & ~(mt_new < tl))
        steps += UNROLL

    if mode == "occluded":
        return dict(hit=hit.any(0))
    fwd_rows = tuple(fwd[:, i, j][:, None] for i in range(3) for j in range(3))
    if is_exit:
        nx, ny, nz = normals_from(r, gs_f, fwd_rows, t_out)

        def pick(a):
            return torch.where(match, a, 0).sum(0)

        return dict(in_vol=(in_vol & match).any(0), t=pick(t_out),
                    cell=pick(torch.where(in_vol, cell, MAT_NONE)).to(i32),
                    nx=pick(torch.where(in_vol, nx, 0.0)), ny=pick(torch.where(in_vol, ny, 0.0)),
                    nz=pick(torch.where(in_vol, nz, 0.0)))

    # merge the volumes: the earliest volume wins exact ties (argmin is first-min)
    t_pair = torch.where(hit, t_hit, BIG)
    win = torch.argmin(t_pair, dim=0)
    winm = (win[None, :] == torch.arange(v, device=dev)[:, None]) & hit
    nx, ny, nz = normals_from(r, gs_f, fwd_rows, t_hit)
    any_hit = hit.any(0)

    def pick_win(a, zero):
        return torch.where(winm, a, zero).sum(0)

    return dict(
        hit=any_hit,
        t=torch.where(any_hit, t_pair.amin(0), BIG),
        cell=torch.where(any_hit, pick_win(cell, 0).to(i32), MAT_NONE),
        vol=torch.where(any_hit, win.to(i32), -2),
        nx=pick_win(nx, 0.0), ny=pick_win(ny, 0.0), nz=pick_win(nz, 0.0),
    )


# --------------------------------------------------------------------------
# Single-volume wrappers (tests and simple callers): object space is world
# space, one volume with its cube at cube_min
# --------------------------------------------------------------------------

def _wrap_single(grid_flat, gridsize, gpad, cube_min):
    """One volume's traverse arguments: (grids, gridsize [1], inv, fwd
    (identities [1, 4, 4]), cube_min [1, 3]).  gpad, the padded side, is
    grid_flat's; unused, as in the JAX package."""
    dev = grid_flat.device
    eye = torch.eye(4, dtype=torch.float32, device=dev)[None]
    return (grid_flat, torch.as_tensor(gridsize, dtype=torch.int32, device=dev).reshape(1),
            eye, eye.clone(), torch.as_tensor(cube_min, dtype=torch.float32,
                                              device=dev).reshape(1, 3))


def dda_nearest(grid_flat, gridsize, gpad, cube_min, o, d, rd, dsign, t_limit, active_in,
                skip_lo, skip_hi, max_steps: int = 4096):
    """Single-volume FindNearest -> (hit, t (0 on a miss), cell).  rd and
    dsign are recomputed from d, as in the JAX package."""
    g, gs, inv, fwd, cm = _wrap_single(grid_flat, gridsize, gpad, cube_min)
    o3 = o if o.ndim == 2 else o.reshape(-1, 3)
    res = traverse(g, gs, inv, fwd, cm, o3, d, t_limit, active_in,
                   torch.ones(1, dtype=torch.bool, device=o.device), skip_lo, skip_hi,
                   mode="nearest", max_steps=max_steps)
    return res["hit"], torch.where(res["hit"], res["t"], 0.0), res["cell"]


def dda_occluded(grid_flat, gridsize, gpad, cube_min, o, d, rd, dsign, t_limit, active_in,
                 max_steps: int = 4096):
    """Single-volume IsOccluded -> hit [N]."""
    g, gs, inv, fwd, cm = _wrap_single(grid_flat, gridsize, gpad, cube_min)
    res = traverse(g, gs, inv, fwd, cm, o, d, t_limit, active_in,
                   torch.ones(1, dtype=torch.bool, device=o.device), 1, 0, mode="occluded",
                   max_steps=max_steps)
    return res["hit"]


def dda_exit(grid_flat, gridsize, gpad, cube_min, o, d, rd, dsign, active_in, mode_code,
             glass_mat, smoke_lo, smoke_hi, max_steps: int = 4096):
    """Single-volume FindMaterialExit / FindSmokeExit -> (in_vol, t,
    cell).  The materials are the core types' (glass_mat, smoke_lo and
    smoke_hi are unused, as in the JAX package)."""
    g, gs, inv, fwd, cm = _wrap_single(grid_flat, gridsize, gpad, cube_min)
    n = o.shape[0]
    res = traverse(g, gs, inv, fwd, cm, o, d,
                   torch.full((n,), BIG, dtype=torch.float32, device=o.device), active_in,
                   torch.ones(1, dtype=torch.bool, device=o.device), 1, 0, mode="exit",
                   mode_code=mode_code, vol_match=torch.zeros(n, dtype=torch.int32,
                                                              device=o.device),
                   max_steps=max_steps)
    return res["in_vol"], res["t"], res["cell"]


def normal_voxel(gridsize, fwd, o, d, t, dsign):
    """GetNormalVoxel (scene.cpp:121-148) of [N, 3] object-space rays at
    their hit t [N], taken to world space by fwd ([4, 4] or [1, 4, 4])
    -> [N, 3]."""
    from vtbench.reference.kernels.dda_occ import normals_from

    r = dict(ox=o[:, 0][None], oy=o[:, 1][None], oz=o[:, 2][None],
             dx=d[:, 0][None], dy=d[:, 1][None], dz=d[:, 2][None],
             sx=dsign[:, 0][None], sy=dsign[:, 1][None], sz=dsign[:, 2][None])
    gs_f = torch.as_tensor(gridsize, dtype=torch.float32, device=o.device).reshape(1, 1)
    fwd3 = fwd if fwd.ndim == 3 else fwd[None]
    rows = tuple(fwd3[:, i, j][:, None] for i in range(3) for j in range(3))
    return torch.stack([c[0] for c in normals_from(r, gs_f, rows, t[None, :])], dim=-1)
