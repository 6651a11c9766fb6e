"""3D-DDA building blocks in plain torch (counterpart of the helpers in
voxtracer/kernels/dda.py): object-space rays, the cube slab test, the
Setup3DDDA seeding and the reference's axis pick.

Every function works on broadcastable [P, N] pair tensors and rounds as
the JAX version does; the CUDA traversal (csrc/traverse.cu) spells out
the same arithmetic in the same order.  Float -> int conversions go
through ``cell_index``, which saturates as XLA and CUDA do (torch's CPU
cast does not).
"""

from __future__ import annotations

import torch

BIG = 1e34
BRICK = 8

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
