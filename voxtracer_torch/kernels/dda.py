"""3D-DDA in plain torch (counterpart of voxtracer/kernels/dda.py): the
building blocks (object-space rays, the cube slab test, the Setup3DDDA
seeding and the reference's axis pick) and ``traverse``, the nearest
walk with a material skip range.

Every function works on broadcastable [P, N] pair tensors and rounds as
the JAX version does; the CUDA traversal (csrc/traverse.cu) spells out
the same arithmetic in the same order.  Float -> int conversions go
through ``cell_index``, which saturates as XLA and CUDA do (torch's CPU
cast does not).
"""

from __future__ import annotations

import torch

from voxtracer_torch.core.types import MAT_NONE

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
             vol_enabled, skip_lo: int, skip_hi: int, bricks_flat, bricksize,
             max_steps: int = 4096):
    """The nearest hit of every ray over all volumes, with cells whose
    material lies in [skip_lo, skip_hi] counted as empty (none when
    skip_lo > skip_hi): the JAX package's ``dda.traverse`` in nearest mode,
    its two-level variant (FindNearestPlayer's traversal,
    renderer.cpp:1020-1071, which the game's probe runs).

    All [V, N] (volume, ray) pairs walk in lockstep.  A pair on the macro
    level looks up its brick in ``bricks_flat`` (the uniform value of each
    8^3 brick, BRICK_MIXED where mixed) and skips a brick that is empty or
    uniformly in the skip range with one macro DDA step; else it descends,
    re-seeding the fine DDA at t + 5e-5 clamped into the brick, and walks
    cells until it hits, leaves the brick (back to the macro level) or
    leaves the grid.  The hit t is the crossing t, updated before the
    bounds test.  Volumes merge by argmin, the earliest winning exact ties.
    o, d: [N, 3]; t_limit [N]; ray_active [N]; vol_enabled [V].  Returns
    dict(hit, t, cell, vol, nx, ny, nz) of [N]; a miss has vol -2.
    """
    from voxtracer_torch.kernels.dda_occ import normals_from

    v = gridsize.shape[0]
    dev = o.device
    i32 = torch.int32
    r = object_rays(inv, o, d)
    bx, by, bz = cube_min[:, 0:1], cube_min[:, 1:2], cube_min[:, 2:3]
    gs_f, gs_i = gridsize.to(torch.float32)[:, None], gridsize[:, None]
    ms_f, ms_i = bricksize.to(torch.float32)[:, None], bricksize[:, None]
    g3 = grids_flat.shape[0] // v
    side = round(g3 ** (1.0 / 3.0))
    assert side ** 3 == g3, "grids must be padded cubes"
    m3 = bricks_flat.shape[0] // v
    mside = round(m3 ** (1.0 / 3.0))
    assert mside ** 3 == m3, "bricks must be padded cubes"
    vol_base = (torch.arange(v, dtype=i32, device=dev) * g3)[:, None]
    macro_base = grids_flat.shape[0] + (torch.arange(v, dtype=i32, device=dev) * m3)[:, None]
    table = torch.cat([grids_flat.to(i32), bricks_flat.to(i32)])
    last = table.shape[0] - 1
    tl = t_limit[None, :]

    def in_skip(vals):
        return (vals >= skip_lo) & (vals <= skip_hi) & (skip_hi >= skip_lo)

    s = setup(r, bx, by, bz, gs_f, gs_i)    # fine level
    sm = setup(r, bx, by, bz, ms_f, ms_i)   # macro level, same cube
    active = ray_active[None, :] & vol_enabled[:, None] & sm["valid"] & (sm["t0"] < tl)
    shape = active.shape

    def full(x):
        return x.expand(shape).clone()

    t = full(sm["t0"])
    level = torch.zeros(shape, dtype=torch.bool, device=dev)  # False: macro, True: fine
    hit = torch.zeros_like(level)
    t_hit = torch.zeros_like(t)
    cell = torch.full(shape, MAT_NONE, dtype=i32, device=dev)
    px, py, pz = full(s["px"]), full(s["py"]), full(s["pz"])
    tmx, tmy, tmz = full(s["tmx"]), full(s["tmy"]), full(s["tmz"])
    mpx, mpy, mpz = full(sm["px"]), full(sm["py"]), full(sm["pz"])
    mtmx, mtmy, mtmz = full(sm["tmx"]), full(sm["tmy"]), full(sm["tmz"])
    blox = torch.zeros(shape, dtype=i32, device=dev)
    bloy, bloz = blox.clone(), blox.clone()
    stx, sty, stz = s["stx"], s["sty"], s["stz"]
    tdx, tdy, tdz = s["tdx"], s["tdy"], s["tdz"]
    mtdx, mtdy, mtdz = sm["tdx"], sm["tdy"], sm["tdz"]
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
            fine_idx = (px * side + py) * side + pz + vol_base
            macro_idx = macro_base + (mpx * mside + mpy) * mside + mpz
            vals = table[torch.clamp(torch.where(at_fine, fine_idx, macro_idx), 0, last).long()]

            # fine pairs: the hit test, then one cell step
            act_f = active & at_fine
            pred = act_f & (vals != MAT_NONE) & (t < tl) & ~in_skip(vals)
            hit = hit | pred
            t_hit = torch.where(pred, t, t_hit)
            cell = torch.where(pred, vals, cell)
            act_f = act_f & ~pred
            use_x, use_y, use_z = pick_axis(tmx, tmy, tmz)
            t_new = torch.where(use_x, tmx, torch.where(use_y, tmy, tmz))
            npx = px + zi(act_f & use_x, stx)
            npy = py + zi(act_f & use_y, sty)
            npz = pz + zi(act_f & use_z, stz)
            moved = torch.where(use_x, npx, torch.where(use_y, npy, npz))
            out_grid = (moved < 0) | (moved >= gs_i)
            blo = torch.where(use_x, blox, torch.where(use_y, bloy, bloz))
            out_brick = (moved < blo) | (moved >= blo + BRICK)
            ntmx = tmx + torch.where(act_f & use_x, tdx, 0.0)
            ntmy = tmy + torch.where(act_f & use_y, tdy, 0.0)
            ntmz = tmz + torch.where(act_f & use_z, tdz, 0.0)
            nt = torch.where(act_f, t_new, t)
            act_f = act_f & (t_new < tl)
            go_macro = act_f & out_brick & ~out_grid
            term_f = act_f & out_grid
            nlevel = at_fine & ~go_macro
            nactive = torch.where(at_fine, act_f & ~term_f & ~go_macro | go_macro, active)

            # macro pairs: skip the brick or descend into it
            act_m = active & ~at_fine
            skip_ok = ((vals == MAT_NONE) | in_skip(vals)) & act_m
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
            active = nactive & ~(do_m & m_out) & ~(do_m & ~(mt_new < tl))
        steps += UNROLL

    # merge the volumes: the earliest volume wins exact ties (argmin is first-min)
    t_pair = torch.where(hit, t_hit, BIG)
    win = torch.argmin(t_pair, dim=0)
    winm = (win[None, :] == torch.arange(v, device=dev)[:, None]) & hit
    fwd_rows = tuple(fwd[:, i, j][:, None] for i in range(3) for j in range(3))
    nx, ny, nz = normals_from(r, gs_f, fwd_rows, t_hit)
    any_hit = hit.any(0)

    def pick(a, zero):
        return torch.where(winm, a, zero).sum(0)

    return dict(
        hit=any_hit,
        t=torch.where(any_hit, t_pair.amin(0), BIG),
        cell=torch.where(any_hit, pick(cell, 0).to(i32), MAT_NONE),
        vol=torch.where(any_hit, win.to(i32), -2),
        nx=pick(nx, 0.0), ny=pick(ny, 0.0), nz=pick(nz, 0.0),
    )
