"""The traversal of the reference: plain torch only.

``traverse`` (nearest hit or occlusion) and ``exit_march`` walk only the
(volume, ray) pairs whose ray enters the volume's cube: the pairs are
listed first, then walked in lockstep by ``dda_occ._core`` laid out as
one row of pairs, each with its own volume's constants, in blocks of at
most PAIR_BLOCK pairs.  A ray's nearest hit is the least t over its
pairs, the earliest volume on an exact tie, as ``dda_occ.traverse_occ``
merges its [V, N] pairs (whose pruning of a ray's later pairs by its best
hit changes no result).  A 1080p frame over 111 volumes holds 230 million
pairs, of which a few per cent enter a cube.  ``traverse_plain`` and
``exit_march_plain`` are the dense walks of all pairs."""

from __future__ import annotations

import torch

from vtbench.reference.core.types import MAT_NONE, OCC_EXIT_GLASS, OCC_EXIT_SMOKE
from vtbench.reference.kernels.dda import BIG, EXIT_SMOKE
from vtbench.reference.kernels.dda_occ import _core, entry_t, normals_from, traverse_occ

PAIR_BLOCK = 4 << 20


def traverse_plain(grids_flat, gridsize, inv, fwd, cube_min, o, d, t_limit,
                   ray_active, vol_enabled, occ, bricksize, mode="nearest", tally=None,
                   ray_tally=None):
    """dda_occ.traverse_occ with t_limit None as BIG and vol_enabled None as
    every volume (``tally`` and ``ray_tally`` as there)."""
    dev = o.device
    if t_limit is None:
        t_limit = torch.full((o.shape[0],), BIG, dtype=torch.float32, device=dev)
    if vol_enabled is None:
        vol_enabled = torch.ones(gridsize.shape[0], dtype=torch.bool, device=dev)
    return traverse_occ(grids_flat, gridsize, inv, fwd, cube_min, o, d, t_limit, ray_active,
                        vol_enabled, occ, bricksize, mode=mode, tally=tally,
                        ray_tally=ray_tally)


def exit_march_plain(grids_flat, gridsize, inv, fwd, cube_min, o, d,
                     ray_active, mode_code, vol_match, occ, bricksize, tally=None):
    """dda_occ.traverse_occ in exit mode over all pairs (``tally`` as there)."""
    dev = o.device
    return traverse_occ(grids_flat, gridsize, inv, fwd, cube_min, o, d,
                        torch.full((o.shape[0],), BIG, dtype=torch.float32, device=dev),
                        ray_active, torch.ones(gridsize.shape[0], dtype=torch.bool, device=dev),
                        occ, bricksize, mode="exit", mode_code=mode_code,
                        vol_match=vol_match, tally=tally)


def entering_pairs(inv, cube_min, o, d, active, vol_enabled=None):
    """(volume, ray) index pairs [P] each: the active rays that enter each
    enabled volume's cube."""
    vs, rs = [], []
    enabled = None if vol_enabled is None else vol_enabled.tolist()
    for i in range(inv.shape[0]):
        if enabled is not None and not enabled[i]:
            continue
        rays = (active & (entry_t(inv[i:i + 1], cube_min[i:i + 1], o, d)[0] < 1e33)).nonzero()[:, 0]
        vs.append(torch.full_like(rays, i))
        rs.append(rays)
    if not rs:
        e = torch.zeros(0, dtype=torch.long, device=o.device)
        return e, e
    return torch.cat(vs), torch.cat(rs)


def _pair_rays(inv_p, o, d):
    """object_rays for pairs: inv_p [M, 4, 4], o, d [M, 3] -> [1, M] each."""
    def tr(row, px, py, pz, point):
        out = row[:, 0] * px + row[:, 1] * py + row[:, 2] * pz
        return (out + row[:, 3] if point else out)[None]

    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    vdx = tr(inv_p[:, 0], dx, dy, dz, False)
    vdy = tr(inv_p[:, 1], dx, dy, dz, False)
    vdz = tr(inv_p[:, 2], dx, dy, dz, False)
    return dict(ox=tr(inv_p[:, 0], ox, oy, oz, True), oy=tr(inv_p[:, 1], ox, oy, oz, True),
                oz=tr(inv_p[:, 2], ox, oy, oz, True), dx=vdx, dy=vdy, dz=vdz,
                rdx=1.0 / vdx, rdy=1.0 / vdy, rdz=1.0 / vdz,
                sx=torch.signbit(vdx).to(torch.float32), sy=torch.signbit(vdy).to(torch.float32),
                sz=torch.signbit(vdz).to(torch.float32))


def walk_pairs(grids_flat, gridsize, inv, fwd, cube_min, occ, bricksize, o, d, t_limit,
               pv, pr, mode, mode_code=None, ray_tally=None):
    """The walk of each pair (volume pv, ray pr) alone -> per pair: hit,
    t_hit, gidx, in_vol, t_out and (nearest, exit) the normal at its
    end; ray_tally gains each pair's STEPS ([P] int64)."""
    v = gridsize.shape[0]
    g3 = grids_flat.shape[0] // v
    side = round(g3 ** (1.0 / 3.0))
    m3 = occ.shape[2]
    mside = round(m3 ** (1.0 / 3.0))
    occ_flat = occ.reshape(3 * v * m3, 16)
    parts = []
    for lo in range(0, pv.shape[0], PAIR_BLOCK):
        bv, br = pv[lo:lo + PAIR_BLOCK], pr[lo:lo + PAIR_BLOCK]
        r = _pair_rays(inv[bv], o[br], d[br])
        gs = gridsize[bv][None]
        ms = bricksize[bv][None]
        occ_base = bv.to(torch.int32)[None] * m3
        if mode == "exit":
            plane = torch.where(mode_code[br] == EXIT_SMOKE, OCC_EXIT_SMOKE, OCC_EXIT_GLASS)
            occ_base = occ_base + plane.to(torch.int32)[None] * (v * m3)
        cm = cube_min[bv]
        c = dict(bx=cm[:, 0][None], by=cm[:, 1][None], bz=cm[:, 2][None],
                 gs_f=gs.to(torch.float32), gs_i=gs, ms_f=ms.to(torch.float32), ms_i=ms,
                 side=side, mside=mside, cell_base=bv.to(torch.int32)[None] * g3,
                 occ_base=occ_base)
        tl = t_limit[br][None]
        act = torch.ones_like(tl, dtype=torch.bool)
        rt = {} if ray_tally is not None else None
        st = _core(r, c, occ_flat, tl, act, mode, ray_tally=rt)
        out = {k: x[0] for k, x in st.items()}
        if mode != "occluded":
            f = fwd[bv]
            rows = tuple(f[:, i, j][None] for i in range(3) for j in range(3))
            n = normals_from(r, c["gs_f"], rows, st["t_out"] if mode == "exit" else st["t_hit"])
            out.update(nx=n[0][0], ny=n[1][0], nz=n[2][0])
        if rt is not None:
            out["tally"] = rt
        parts.append(out)
    if not parts:
        return None
    res = {k: torch.cat([p[k] for p in parts]) for k in parts[0] if k != "tally"}
    if ray_tally is not None:
        for k in parts[0]["tally"]:
            ray_tally[k] = torch.cat([p["tally"][k] for p in parts])
    return res


def traverse(grids_flat, gridsize, inv, fwd, cube_min, o, d, t_limit, ray_active,
             vol_enabled, occ, bricksize, mode="nearest"):
    """Nearest hit or any hit before t_limit over all volumes -> the dict of
    ``traverse_occ`` (hit, t, cell, vol, nx, ny, nz; or hit)."""
    if mode not in ("nearest", "occluded"):
        raise ValueError(f"mode {mode!r}")
    n, dev = o.shape[0], o.device
    if t_limit is None:
        t_limit = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    pv, pr = entering_pairs(inv, cube_min, o, d, ray_active, vol_enabled)
    w = walk_pairs(grids_flat, gridsize, inv, fwd, cube_min, occ, bricksize, o, d, t_limit,
                   pv, pr, mode)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    if mode == "occluded":
        if w is not None:
            hit[pr[w["hit"]]] = True
        return dict(hit=hit)
    out = dict(hit=hit, t=torch.full((n,), BIG, dtype=torch.float32, device=dev),
               cell=torch.full((n,), MAT_NONE, dtype=torch.int32, device=dev),
               vol=torch.full((n,), -2, dtype=torch.int32, device=dev),
               **{k: torch.zeros(n, dtype=torch.float32, device=dev) for k in ("nx", "ny", "nz")})
    if w is None:
        return out
    h = w["hit"]
    t_pair = torch.where(h, w["t_hit"], BIG)
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_t.scatter_reduce_(0, pr, t_pair, "amin")
    cand = h & (t_pair == best_t[pr])
    best_v = torch.full((n,), gridsize.shape[0], dtype=torch.long, device=dev)
    best_v.scatter_reduce_(0, pr, torch.where(cand, pv, gridsize.shape[0]), "amin")
    win = cand & (pv == best_v[pr])
    wr = pr[win]
    hit[wr] = True
    out["t"][wr] = w["t_hit"][win]
    nmax = grids_flat.shape[0] - 1
    out["cell"][wr] = grids_flat[torch.clamp(w["gidx"][win], 0, nmax).long()].to(torch.int32)
    out["vol"][wr] = pv[win].to(torch.int32)
    for k in ("nx", "ny", "nz"):
        out[k][wr] = w[k][win]
    return out


def exit_march(grids_flat, gridsize, inv, fwd, cube_min, o, d, ray_active,
               mode_code, vol_match, occ, bricksize):
    """Each active ray through its own volume vol_match until it leaves the
    medium mode_code selects or the grid -> dict(in_vol, t, cell, nx, ny,
    nz); an idle ray: in_vol False, t 0, cell MAT_NONE, a zero normal."""
    n, dev = o.shape[0], o.device
    out = dict(in_vol=torch.zeros(n, dtype=torch.bool, device=dev),
               t=torch.zeros(n, dtype=torch.float32, device=dev),
               cell=torch.full((n,), MAT_NONE, dtype=torch.int32, device=dev),
               **{k: torch.zeros(n, dtype=torch.float32, device=dev) for k in ("nx", "ny", "nz")})
    pr = ray_active.nonzero()[:, 0]
    pv = vol_match[pr].long()
    w = walk_pairs(grids_flat, gridsize, inv, fwd, cube_min, occ, bricksize, o, d,
                   torch.full((n,), BIG, dtype=torch.float32, device=dev), pv, pr, "exit",
                   mode_code=mode_code)
    if w is None:
        return out
    iv = w["in_vol"]
    nmax = grids_flat.shape[0] - 1
    cell = grids_flat[torch.clamp(torch.where(iv, w["gidx"], 0), 0, nmax).long()]
    out["in_vol"][pr] = iv
    out["t"][pr] = w["t_out"]
    out["cell"][pr] = torch.where(iv, cell, MAT_NONE).to(torch.int32)
    for k in ("nx", "ny", "nz"):
        out[k][pr] = torch.where(iv, w[k], 0.0)
    return out
