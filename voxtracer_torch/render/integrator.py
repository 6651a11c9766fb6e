"""Wavefront integrators (counterpart of voxtracer/render/integrator.py).

The whole ray population advances one bounce at a time; each bounce runs
one nearest traversal (kernels/traverse.py), one material-row lookup
(kernels/lookup.py), one shadow traversal for next-event estimation and,
on bounces where a ray is inside glass or smoke, the exit march.  Every
material lobe is computed for all rays and selected with masks, as the
JAX package does.  Per-ray vectors travel as component tuples (x, y, z)
of [N] tensors; the public functions take and return [N, 3] or [H, W, 3].
The path integrator carries its state as one packed matrix, a component
a row (``_pack_path``), from the first bounce to the deferred sky, and
has one bounce (``_bounce_core``): its shading runs in place in three
stages (kernels/bounce.py), the kernels of csrc/bounce.cu on the card
and their plain versions on any other device.

Modes: "primary" (flat albedo at the first hit), "whitted" (the
deterministic NEE sum with perfect mirrors and Fresnel-split glass, run
as a branch queue: ``trace_whitted_iter``) and "path" (full stochastic
light transport, renderer.cpp:1076-1328); render/reproject.py builds the
"reproject" frame on the functions here.  Random streams are the counter
hash of core/rng.py or, with cfg.rng = "threefry", jax.random's threefry
streams, under keys derived with ``fold_in``, so both packages draw the
same samples.
"""

from __future__ import annotations

import math

import torch

from voxtracer_torch.config import RenderConfig
from voxtracer_torch.core import mathx
from voxtracer_torch.core.rng import (fold_in, hash_normal, hash_uniform, threefry_normal,
                                      threefry_uniform)
from voxtracer_torch.core.types import (EMISSIVE, GLASS, MAT_NONE, METAL_HIGH,
                                        METAL_LOW, SMOKE_LOW_DENSITY,
                                        SMOKE_PLAYER, Scene)
from voxtracer_torch.kernels import bounce, dda
from voxtracer_torch.kernels.dda import EXIT_GLASS, EXIT_SMOKE
from voxtracer_torch.kernels.dda_occ import entry_t
from voxtracer_torch.kernels.lookup import lookup_rows
from voxtracer_torch.kernels.primitives import (spheres_nearest,
                                                spheres_occluded,
                                                triangles_nearest,
                                                triangles_occluded)
from voxtracer_torch.kernels.traverse import exit_march, traverse
from voxtracer_torch.render.camera import primary_rays
from voxtracer_torch.render.sky import sample_sky
from voxtracer_torch.utils.profiling import span

BIG = 1e34
F32 = torch.float32


def _uni(cfg: RenderConfig, key, salt: int, shape, dev, lanes=None):
    """f32 uniforms in [0, 1) of stream `salt` under `key`: the counter
    hash, or with cfg.rng == "threefry" ``jax.random.uniform`` of
    ``fold_in(key, salt)``; the rays' `lanes` (``core.rng.counters``) run
    along the last axis."""
    if cfg.rng == "hash":
        return hash_uniform(key, salt, shape, dev, lanes)
    return threefry_uniform(fold_in(key, salt), shape, dev, lanes, -1)


def _nrml(cfg: RenderConfig, key, salt: int, shape, dev, lanes=None):
    """Standard normals of stream `salt`, as ``_uni``."""
    if cfg.rng == "hash":
        return hash_normal(key, salt, shape, dev, lanes)
    return threefry_normal(fold_in(key, salt), shape, dev, lanes, -1)


# --------------------------------------------------------------------------
# Component-tuple vector helpers
# --------------------------------------------------------------------------

def cpack(a):
    """[N, 3] -> (x, y, z)."""
    return a[..., 0], a[..., 1], a[..., 2]


def cstack(c):
    return torch.stack(c, dim=-1)


def cdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def csub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def cmul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def cscale(s, a):
    return (s * a[0], s * a[1], s * a[2])


def cneg(a):
    return (-a[0], -a[1], -a[2])


def cwhere(m, a, b):
    return tuple(torch.where(m, a[i], b[i]) for i in range(3))


def cunit(a):
    return cscale(torch.rsqrt(torch.clamp(cdot(a, a), min=1e-20)), a)


def creflect(d, n):
    """renderer.cpp:913-916."""
    return csub(d, cscale(2.0 * cdot(d, n), n))


def crefract(d, n, ratio):
    """renderer.cpp:919-925."""
    cos_t = torch.clamp(cdot(cneg(d), n), max=1.0)
    rp = cscale(ratio, cadd(d, cscale(cos_t, n)))
    rpar = -mathx.sqrt(torch.abs(1.0 - cdot(rp, rp)))
    return cadd(rp, cscale(rpar, n))


def coffset(p, n):
    """OffsetRay per component (tmpl8math.cpp:473-487)."""
    return tuple(mathx.offset_ray(p[i], n[i]) for i in range(3))


def coctant_dir(g):
    """RandomDirection positive-octant quirk (tmpl8math.cpp:76-93)."""
    return cunit((g[0].abs() + 1e-12, g[1].abs() + 1e-12, g[2].abs() + 1e-12))


# --------------------------------------------------------------------------
# Scene intersection
# --------------------------------------------------------------------------

def _vol_args(scene: Scene, vols=None):
    v = scene.volumes if vols is None else vols
    return (v.grids.reshape(-1), v.gridsize, v.inv, v.fwd, v.cube_min)


def _is_paged(scene: Scene) -> bool:
    """A paginated scene of more than 64 volumes (the JAX package pages
    its TPU kernels from there on)."""
    return scene.volumes.pages is not None and scene.volumes.n > 64


def _pages(scene: Scene, rays):
    """The pages to traverse one by one, or None for one traversal over
    all volumes.  CPU rays walk a paged scene page by page, as the JAX
    package walks it where its TPU kernels run.  On the card one launch
    takes all volumes: the kernels keep no per-volume state, and a launch
    a page with this entry pass in plain torch was timed at nine times the
    111-volume 1080p frame (PERF.md)."""
    return scene.volumes.pages if _is_paged(scene) and rays.is_cpu else None


# How far above the best t a later page's walk limit sits, relative.  The
# float just above it (the JAX package's limit) is not enough: the walk
# ends a ray whose fine crossing t reaches the limit, and the fine and the
# macro DDA round the crossing of one plane a few ulps apart, so a tying
# hit entered by a macro step can lie one fine crossing beyond that limit
# and the tie would go to the page walked first.  84 ulps cover the at most
# 8 + 8 additions that separate the two.  A hit returned above the best t
# loses the merge, so the slack changes no result.
TIE_SLACK = 1e-5


def _paged_traverse(scene: Scene, o3, d3, t_limit, active, vol_enabled, mode):
    """``traverse`` one page of volumes at a time, merged -> the dict of
    one traversal over all volumes (t_limit and vol_enabled may be None).

    A page can only improve a ray's result if the ray enters one of the
    page's cubes before its best t so far, so each page gets its earliest
    entry t per ray first (disabled volumes and NaN count as a miss) and
    walks only the rays that pass.  In nearest mode a later page's limit
    sits a little above the best t (TIE_SLACK): an exact tie still comes
    back and the merge gives it to the lower volume id of the whole set
    (``vol_off`` restores it), so the walk order changes no result.
    Occluded rays leave the later pages."""
    pages = scene.volumes.pages
    pmins = []
    for pv in pages:
        ent = entry_t(pv.inv, pv.cube_min, o3, d3)  # [pn, N]
        if vol_enabled is not None:
            ent = torch.where(vol_enabled[pv.vol_off:pv.vol_off + pv.n, None], ent, BIG)
        ent = torch.where(torch.isnan(ent), BIG, ent)
        pmins.append(ent.amin(0))
    best = None
    for pv, pmin in zip(pages, pmins):
        off = pv.vol_off
        lim = t_limit
        if best is not None and mode != "occluded":
            lim = torch.maximum(torch.nextafter(best["t"], torch.full_like(best["t"], math.inf)),
                                best["t"] * (1.0 + TIE_SLACK))
            if t_limit is not None:
                lim = torch.minimum(t_limit, lim)
        if best is not None and mode == "occluded":
            active = active & ~best["hit"]
        act_p = active & (pmin < (BIG if lim is None else lim))
        res = traverse(*_vol_args(scene, pv), o3, d3, lim, act_p,
                       None if vol_enabled is None else vol_enabled[off:off + pv.n].contiguous(),
                       pv.occ, pv.bricksize, mode=mode)
        if mode != "occluded":
            res["vol"] = torch.where(res["hit"], res["vol"] + off, res["vol"])
        if best is None:
            best = res
        elif mode == "occluded":
            best["hit"] = best["hit"] | res["hit"]
        else:
            # strict (t, volume id of the whole set) adoption
            adopt = res["hit"] & (~best["hit"] | (res["t"] < best["t"])
                                  | ((res["t"] == best["t"]) & (res["vol"] < best["vol"])))
            best = {k: torch.where(adopt, res[k], best[k]) for k in best}
            best["hit"] = (best["hit"] | res["hit"]) & active
    return best


def _traverse_world(scene: Scene, o3, d3, t_limit, active, mode, vol_enabled=None):
    """``traverse`` over the scene's volumes (vol_enabled None: all of
    them): page by page where ``_pages`` says so, else in one call."""
    if _pages(scene, o3) is not None:
        return _paged_traverse(scene, o3, d3, t_limit, active, vol_enabled, mode)
    vols = scene.volumes
    return traverse(*_vol_args(scene), o3, d3, t_limit, active, vol_enabled, vols.occ,
                    vols.bricksize, mode=mode)


def find_nearest_world(scene: Scene, o, d, active, skip_lo: int = 1, skip_hi: int = 0,
                       skip_first: bool = False):
    """Renderer::FindNearest (renderer.cpp:946-1018): all volumes in one
    traversal (page by page where ``_pages`` says so), then spheres and
    triangles merged.  With skip_lo <= skip_hi, cells whose material lies
    in [skip_lo, skip_hi] count as empty and the walk is the plain-torch
    ``dda.traverse`` over the uniform-brick table, as in the JAX package
    (the game's probe, FindNearestPlayer); skip_first leaves volume 0 out.
    o, d: [N, 3] or component tuples.  Returns dict with t, mat, vol, hit,
    nx, ny, nz, prim_adopt and prim_inside."""
    o3 = (cstack(o) if isinstance(o, tuple) else o).contiguous()
    d3 = (cstack(d) if isinstance(d, tuple) else d).contiguous()
    vols = scene.volumes
    vol_enabled = None
    if skip_first:
        vol_enabled = torch.ones(vols.n, dtype=torch.bool, device=o3.device)
        vol_enabled[0] = False
    if skip_lo > skip_hi:
        res = _traverse_world(scene, o3, d3, None, active, "nearest", vol_enabled)  # no t limit
    else:
        if vol_enabled is None:
            vol_enabled = torch.ones(vols.n, dtype=torch.bool, device=o3.device)
        res = dda.traverse(*_vol_args(scene), o3, d3,
                           torch.full((o3.shape[0],), BIG, dtype=F32, device=o3.device),
                           active, vol_enabled, skip_lo, skip_hi,
                           bricks_flat=vols.bricks.reshape(-1), bricksize=vols.bricksize)
    t, vol = res["t"], res["vol"]
    mat = torch.where(res["hit"], res["cell"], MAT_NONE)
    nrm = (res["nx"], res["ny"], res["nz"])

    # spheres + triangles on a fresh ray, then min-merge (renderer.cpp:996-1016)
    st, smat, snrm, sinside = spheres_nearest(scene.spheres, o3, d3)
    tt, tmat, tnrm = triangles_nearest(scene.triangles, o3, d3)
    prim_t = torch.minimum(st, tt)
    use_tri = tt < st
    prim_mat = torch.where(use_tri, tmat, smat)
    prim_nrm = cwhere(use_tri, cpack(tnrm), cpack(snrm))
    adopt = active & (t > prim_t)
    nrm = cwhere(adopt, prim_nrm, nrm)
    out = dict(
        t=torch.where(adopt, prim_t, t),
        mat=torch.where(adopt, prim_mat, mat),
        nx=nrm[0], ny=nrm[1], nz=nrm[2],
        vol=torch.where(adopt, -1, vol),
        # sphere hits replace isInsideGlass on adoption (renderer.cpp:1013),
        # from the closest sphere even when a triangle won
        prim_adopt=adopt,
        prim_inside=sinside,
    )
    out["hit"] = active & (out["mat"] != MAT_NONE)
    return out


def is_occluded_world(scene: Scene, o, d, t_limit, active):
    """Renderer::IsOccluded (renderer.cpp:209-243) in one traversal."""
    o3 = (cstack(o) if isinstance(o, tuple) else o).contiguous()
    d3 = (cstack(d) if isinstance(d, tuple) else d).contiguous()
    occ = _traverse_world(scene, o3, d3, t_limit, active, "occluded")["hit"]
    occ = occ | spheres_occluded(scene.spheres, o3, d3, t_limit)
    return occ | triangles_occluded(scene.triangles, o3, d3, t_limit)


def material_exit_world(scene: Scene, o, d, vol_idx, mode_code, mask):
    """FindMaterialExit / FindSmokeExit through each ray's own volume
    (renderer.cpp:1160-1179, 1265-1280).  Returns (in_volume, t, normal
    components).  Page by page, each ray marches in the one page that
    holds its volume."""
    o3, d3 = o.contiguous(), d.contiguous()
    vols = scene.volumes
    pages = _pages(scene, o3)
    if pages is None:
        res = exit_march(*_vol_args(scene), o3, d3, mask, mode_code, vol_idx, vols.occ,
                         vols.bricksize)
    else:
        res = None
        for pv in pages:
            in_page = (vol_idx >= pv.vol_off) & (vol_idx < pv.vol_off + pv.n)
            local = torch.clamp(vol_idx - pv.vol_off, 0, pv.n - 1)
            r = exit_march(*_vol_args(scene, pv), o3, d3, mask & in_page, mode_code, local,
                           pv.occ, pv.bricksize)
            res = r if res is None else {k: torch.where(in_page, r[k], res[k]) for k in res}
    return res["in_vol"], res["t"], (res["nx"], res["ny"], res["nz"])


# --------------------------------------------------------------------------
# Next-event estimation (renderer.cpp:102-207, 738-764)
# --------------------------------------------------------------------------

def _light_row(tab, i):
    """Row i of an [L, 3] light table as three scalar tensors."""
    return tab[i, 0], tab[i, 1], tab[i, 2]


def _det_illumination(scene: Scene, cfg: RenderConfig, p, nrm, alb, active, key, lanes=None):
    """The deterministic all-lights NEE sum (renderer.cpp:102-207, 738-764)
    with one shadow traversal: every light's shadow segments start at the
    same offset origin, so they are concatenated into one [L*N]-ray
    occlusion call, and the per-light contributions are added afterwards
    in the reference's summation order.  Area lights take
    cfg.num_area_samples samples each, drawn at the rays' `lanes` (as in
    ``core.rng.counters``; None: lanes 0 .. N-1)."""
    L = scene.lights
    nrays, dev = p[0].shape[0], p[0].device
    zero = tuple(torch.zeros(nrays, dtype=F32, device=dev) for _ in range(3))
    origin = coffset(p, nrm)
    segs = []  # (direction, shadow t, need, per-sample contribution)
    plan = []  # in summation order: ("one", seg) or ("area", [seg, ...])
    for i in range(L.n_point):
        lpos, lcol = _light_row(L.point_pos, i), _light_row(L.point_color, i)
        to_l = csub(lpos, p)
        dst = mathx.sqrt(cdot(to_l, to_l))
        dirn = cscale(1.0 / dst, to_l)
        cos_t = cdot(dirn, nrm)
        plan.append(("one", len(segs)))
        segs.append((dirn, dst, active & (cos_t > 0.0),
                     cmul(cscale(cos_t / (dst * dst), lcol), alb)))
    for i in range(L.n_area):
        ki = fold_in(key, 1000 + i)
        lpos, lcol = _light_row(L.area_pos, i), _light_row(L.area_color, i)
        lmul, lrad = L.area_mult[i], L.area_radius[i]
        sidx = []
        for k in range(cfg.num_area_samples):
            gk = _nrml(cfg, ki, 200 + k, (3, nrays), dev, lanes)
            rnd = coctant_dir((gk[0], gk[1], gk[2]))
            to_l = csub(cadd(cscale(lrad, rnd), lpos), p)
            dst = mathx.sqrt(cdot(to_l, to_l))
            dirn = cscale(1.0 / dst, to_l)
            cos_t = cdot(dirn, nrm)
            scale = cos_t * lmul * lrad * lrad * (4.0 * math.pi) / (dst * dst)
            sidx.append(len(segs))
            segs.append((dirn, dst, active & (cos_t > 0.0), cscale(scale, lcol)))
        plan.append(("area", sidx))
    for i in range(L.n_spot):
        lpos, ldir = _light_row(L.spot_pos, i), _light_row(L.spot_dir, i)
        lcol, lcos = _light_row(L.spot_color, i), L.spot_cos_angle[i]
        to_l = csub(lpos, p)
        dst = mathx.sqrt(cdot(to_l, to_l))
        dirn = cscale(1.0 / dst, to_l)
        cos_t = cdot(dirn, ldir)
        alpha = 1.0 - (1.0 - cos_t) / (1.0 - lcos)
        plan.append(("one", len(segs)))
        segs.append((dirn, dst, active & (cos_t > lcos),
                     cmul(cscale(cos_t / (dst * dst) * alpha, lcol), alb)))
    # the directional light; a black one (the reference default)
    # contributes zero, so its rays are gated off
    dirn = tuple((-L.dir_direction[i]).expand(nrays) for i in range(3))
    cos_d = cdot(dirn, nrm)
    dir_on = (L.dir_color != 0.0).any()
    plan.append(("one", len(segs)))
    segs.append((dirn, torch.full((nrays,), BIG, dtype=F32, device=dev),
                 active & (cos_d > 0.0) & dir_on,
                 cmul(cscale(cos_d, tuple(L.dir_color[i] for i in range(3))), alb)))

    nseg = len(segs)
    o_all = torch.stack([torch.cat([origin[c]] * nseg) for c in range(3)], dim=1)
    d_all = torch.stack([torch.cat([s[0][c] for s in segs]) for c in range(3)], dim=1)
    occ_all = is_occluded_world(scene, o_all, d_all, torch.cat([s[1] for s in segs]),
                                torch.cat([s[2] for s in segs]))
    lits = [segs[k][2] & ~occ_all[k * nrays:(k + 1) * nrays] for k in range(nseg)]

    acc = zero
    for kind, which in plan:
        if kind == "one":
            acc = cadd(acc, cwhere(lits[which], segs[which][3], zero))
        else:
            a_acc = zero
            for k in which:
                a_acc = cwhere(lits[k], cadd(a_acc, segs[k][3]), a_acc)
            acc = cadd(acc, cmul(cscale(1.0 / cfg.num_area_samples, a_acc), alb))
    return acc


def illumination(scene: Scene, cfg: RenderConfig, p, nrm, active, key, alb, lanes=None):
    """Renderer::Illumination: one random light, scaled by the light count,
    with all light types sharing one shadow traversal; or, with
    cfg.deterministic_lights, the all-lights sum (same expectation).  In
    the random branch area lights use a one-sample estimate of the
    reference's N-sample mean (same expectation).  p, nrm, alb: component
    tuples; the rays draw at `lanes` (as in ``core.rng.counters``).
    Returns a tuple."""
    if cfg.deterministic_lights:
        return _det_illumination(scene, cfg, p, nrm, alb, active, key, lanes)
    L = scene.lights
    n_p, n_a, n_s = L.n_point, L.n_area, L.n_spot
    total = L.count
    nrays, dev = p[0].shape[0], p[0].device
    zero = tuple(torch.zeros(nrays, dtype=F32, device=dev) for _ in range(3))

    u = _uni(cfg, key, 7, (nrays,), dev, lanes)
    idx = torch.clamp((u * total).to(torch.int32), max=total - 1)
    dirn = zero
    intensity = zero
    shadow_t = torch.full((nrays,), BIG, dtype=F32, device=dev)
    gate = torch.zeros(nrays, dtype=torch.bool, device=dev)

    if n_p:
        sel = idx < n_p
        i_p = torch.clamp(idx, 0, n_p - 1).long()
        lpos = cpack(L.point_pos[i_p])
        lcol = cpack(L.point_color[i_p])
        to_l = csub(lpos, p)
        dst = mathx.sqrt(cdot(to_l, to_l))
        d_p = cscale(1.0 / dst, to_l)
        cos_t = cdot(d_p, nrm)
        dirn = cwhere(sel, d_p, dirn)
        intensity = cwhere(sel, cscale(cos_t / (dst * dst), lcol), intensity)
        shadow_t = torch.where(sel, dst, shadow_t)
        gate = torch.where(sel, cos_t > 0.0, gate)
    if n_a:
        sel = (idx >= n_p) & (idx < n_p + n_a)
        i_a = torch.clamp(idx - n_p, 0, n_a - 1).long()
        lpos = cpack(L.area_pos[i_a])
        lcol = cpack(L.area_color[i_a])
        lmul = L.area_mult[i_a]
        lrad = L.area_radius[i_a]
        gk = _nrml(cfg, key, 11, (3, nrays), dev, lanes)
        rnd = coctant_dir((gk[0], gk[1], gk[2]))
        target = cadd(cscale(lrad, rnd), lpos)
        to_l = csub(target, p)
        dst = mathx.sqrt(cdot(to_l, to_l))
        d_a = cscale(1.0 / dst, to_l)
        cos_t = cdot(d_a, nrm)
        scale = cos_t * lmul * lrad * lrad * (4.0 * math.pi) / (dst * dst)
        dirn = cwhere(sel, d_a, dirn)
        intensity = cwhere(sel, cscale(scale, lcol), intensity)
        shadow_t = torch.where(sel, dst, shadow_t)
        gate = torch.where(sel, cos_t > 0.0, gate)
    if n_s:
        sel = (idx >= n_p + n_a) & (idx < n_p + n_a + n_s)
        i_s = torch.clamp(idx - n_p - n_a, 0, n_s - 1).long()
        lpos = cpack(L.spot_pos[i_s])
        ldir = cpack(L.spot_dir[i_s])
        lcol = cpack(L.spot_color[i_s])
        lcos = L.spot_cos_angle[i_s]
        to_l = csub(lpos, p)
        dst = mathx.sqrt(cdot(to_l, to_l))
        d_s = cscale(1.0 / dst, to_l)
        cos_t = cdot(d_s, ldir)
        alpha = 1.0 - (1.0 - cos_t) / (1.0 - lcos)
        dirn = cwhere(sel, d_s, dirn)
        intensity = cwhere(sel, cscale(cos_t / (dst * dst) * alpha, lcol), intensity)
        shadow_t = torch.where(sel, dst, shadow_t)
        gate = torch.where(sel, cos_t > lcos, gate)
    sel_d = idx >= n_p + n_a + n_s
    d_d = tuple((-L.dir_direction[i]).expand(nrays) for i in range(3))
    cos_d = cdot(d_d, nrm)
    dirn = cwhere(sel_d, d_d, dirn)
    intensity = cwhere(sel_d, cscale(cos_d, tuple(L.dir_color[i] for i in range(3))),
                       intensity)
    shadow_t = torch.where(sel_d, BIG, shadow_t)
    # a black directional light (the reference default) contributes zero
    # whatever the occlusion says: no shadow ray for it
    dir_on = (L.dir_color != 0.0).any()
    gate = torch.where(sel_d, (cos_d > 0.0) & dir_on, gate)

    need = active & gate
    occ = is_occluded_world(scene, coffset(p, nrm), dirn, shadow_t, need)
    lit = need & ~occ
    acc = cwhere(lit, cadd(zero, cmul(intensity, alb)), zero)
    return cscale(float(total), acc)


# --------------------------------------------------------------------------
# Path integrator (renderer.cpp:1076-1328 flattened)
# --------------------------------------------------------------------------

def _material_rows(scene: Scene, mat):
    """One [256, 6] row lookup for all material properties -> [n, 6]:
    albedo, roughness, emissive, ior."""
    m = scene.materials
    mtab = torch.cat([m.albedo, m.roughness[:, None], m.emissive[:, None],
                      m.ior[:, None]], dim=1)
    return lookup_rows(mtab, mat)


def _bounce_core(scene: Scene, cfg: RenderConfig, pk, active, bkey, lanes=None, stages=None):
    """One wavefront bounce of the packed path state pk (``_pack_path``'s
    rows; a column window of a wider one works), shaded in place: K1 and
    K4, the stage ``hit``, K3 where a ray marches, ``nee``, K2 on every
    shadow segment (twice with the light kill) and ``continue_``
    (``kernels.bounce``).  active: pk's active row as bools.  Inactive rays
    pass through unchanged; with cfg.detect_light_kill the last row ORs the
    light-kill flags over the bounces.  The rays draw their samples at
    `lanes` (as in ``core.rng.counters``; None: lanes 0 .. n-1), all before
    the stages: they depend on bkey and the lanes alone.

    The state's device picks the stages: ``bounce.KERNELS`` on a CUDA
    state, ``bounce.PLAIN`` on any other; `stages` runs another set (the
    plain stages on a CUDA state, the kernels' oracle).  -> the active
    flags the bounce wrote, bool [n]."""
    if stages is None:
        stages = bounce.KERNELS if pk.is_cuda else bounce.PLAIN
    n, dev = pk.shape[1], pk.device
    L, det = scene.lights, cfg.deterministic_lights
    nee_key = fold_in(bkey, 2)
    lk_key = fold_in(bkey, 9) if cfg.detect_light_kill else None

    def area_samples(key):
        """_det_illumination's area-light samples, light by light."""
        if key is None or not det or not L.n_area * cfg.num_area_samples:
            return None
        return torch.stack([_nrml(cfg, fold_in(key, 1000 + i), 200 + k, (3, n), dev, lanes)
                            for i in range(L.n_area) for k in range(cfg.num_area_samples)])

    def random_light(key):
        """illumination's random branch's draws: the pick and the area sample."""
        if key is None or det:
            return None, None
        return (_uni(cfg, key, 7, (n,), dev, lanes),
                _nrml(cfg, key, 11, (3, n), dev, lanes) if L.n_area else None)

    draws = bounce.Draws(
        _uni(cfg, bkey, 1, (n,), dev, lanes), _uni(cfg, bkey, 3, (3, n), dev, lanes),
        _nrml(cfg, bkey, 4, (3, n), dev, lanes), _uni(cfg, bkey, 5, (n,), dev, lanes),
        _uni(cfg, bkey, 6, (2, n), dev, lanes), _nrml(cfg, bkey, 8, (3, n), dev, lanes),
        *random_light(nee_key), *random_light(lk_key), area_samples(nee_key),
        area_samples(lk_key))
    o3, d3 = pk[0:3].T, pk[3:6].T
    rec = find_nearest_world(scene, o3, d3, active)
    b = bounce.Bounce(pk, rec, _material_rows(scene, rec["mat"]), draws, L, cfg)
    stages.hit(b)
    # the medium march, skipped on bounces where no ray is inside a medium
    if bool(b.march.any()):
        in_vol, t_exit, nrm_exit = material_exit_world(
            scene, o3.contiguous(), d3.contiguous(), rec["vol"], b.mode, b.march)
        b.exit = (in_vol, t_exit, *nrm_exit)
    stages.nee(b)
    b.occ = is_occluded_world(scene, b.sh_o, b.sh_d, b.sh_t, b.need)
    if cfg.detect_light_kill:
        b.lk_occ = is_occluded_world(scene, b.sh_o, b.lk_d, b.lk_t, b.lk_need)
    stages.continue_(b)
    return b.out_active


def _apply_deferred_sky(scene: Scene, cfg: RenderConfig, pk):
    """rad + sky_tp * sky(sky_d) of the packed state pk: the one sky read
    per frame -> component tuple."""
    c = pk.unbind(0)
    sky = cpack(sample_sky(scene.sky, cstack(c[18:21]), cfg.activate_sky, cfg.sky_fallback))
    return cadd(c[9:12], cmul(c[15:18], sky))


# the packed path state's rows: origin, direction, throughput, radiance,
# inside-medium flag, active flag, the ray's first lane (exact in f32 below
# 2^24 rays), deferred sky throughput and direction; then, only where the
# state carries the light-kill flags (cfg.detect_light_kill), in_light
# (the JAX package's columns, in_light moved to the end)
_PK_ACTIVE, _PK_PIX, _PK_ROWS = 13, 14, 21


def _pack_path(st, pix):
    """The path state dict (component tuples, bool flags) as one [21, n]
    f32 matrix ([22, n] with in_light), a state component a row: the state
    every bounce loop carries from the first bounce to the deferred sky, so
    that a bounce shades it in place and a permutation of the wavefront is
    one gather along it.  (The JAX package packs [n, 22] and gathers rows;
    here that layout's strided rows cost more than its row gather saved:
    PERF.md.)"""
    rows = (list(st["o"]) + list(st["d"]) + list(st["tp"]) + list(st["rad"])
            + [st["in_glass"].to(F32), st["active"].to(F32), pix]
            + list(st["sky_tp"]) + list(st["sky_d"]))
    if "in_light" in st:
        rows.append(st["in_light"].to(F32))
    return torch.stack(rows, dim=0)


def _first_path(cfg: RenderConfig, o, d, first: int = 0):
    """trace_path's first state of the rays o, d [n, 3], the lanes [first,
    first + n): unit throughput, no radiance, every ray active, outside
    any medium (and out of the light with cfg.detect_light_kill) ->
    (packed state, its active flags bool [n])."""
    n, dev = o.shape[0], o.device
    zero3 = tuple(torch.zeros(n, dtype=F32, device=dev) for _ in range(3))
    state = dict(
        o=cpack(o), d=cpack(d),
        tp=tuple(torch.ones(n, dtype=F32, device=dev) for _ in range(3)),
        rad=zero3,
        in_glass=torch.zeros(n, dtype=torch.bool, device=dev),
        active=torch.ones(n, dtype=torch.bool, device=dev),
        sky_tp=zero3, sky_d=cpack(d),
    )
    if cfg.detect_light_kill:
        state["in_light"] = torch.zeros(n, dtype=torch.bool, device=dev)
    pix = torch.arange(first, first + n, dtype=F32, device=dev)
    return _pack_path(state, pix), state["active"]


def _world_bounds(scene: Scene):
    """World box over all instances (lo, hi: [3] each): the 8 corners of
    every volume's object-space cube taken through fwd."""
    vols = scene.volumes
    lo = hi = None
    for cx in (0.0, 1.0):
        for cy in (0.0, 1.0):
            for cz in (0.0, 1.0):
                p = vols.cube_min + torch.tensor([cx, cy, cz], dtype=F32,
                                                 device=vols.cube_min.device)
                w = torch.einsum("vij,vj->vi", vols.fwd[:, :3, :3], p) + vols.fwd[:, :3, 3]
                lo = w if lo is None else torch.minimum(lo, w)
                hi = w if hi is None else torch.maximum(hi, w)
    return lo.amin(0), hi.amax(0)


def _morton_code(o, d, lo, span):
    """[n] i32: the morton code of each origin o (a component tuple) in the
    world box (5 bits an axis) above the octant of its direction d."""
    q = []
    for c in range(3):
        f = (o[c] - lo[c]) / span[c]
        # a saturating cast, NaN -> 0, as XLA's
        q.append(torch.clamp(torch.nan_to_num(f * 32.0, nan=0.0), -1.0, 32.0)
                 .to(torch.int32).clamp(0, 31))
    m = torch.zeros(o[0].shape[0], dtype=torch.int32, device=o[0].device)
    for bit in range(5):
        for c in range(3):
            m = m | (((q[c] >> bit) & 1) << (3 * bit + c + 3))
    return m | ((d[0] < 0).to(torch.int32) + 2 * (d[1] < 0).to(torch.int32)
                + 4 * (d[2] < 0).to(torch.int32))


def _morton_key(pk, lo, span):
    """The sort key of each packed ray, [n] i32: ``_morton_code`` of its
    origin and direction; 1 << 30 for a terminated ray, which sorts it to
    the tail."""
    return torch.where(pk[_PK_ACTIVE] <= 0.5, 1 << 30, _morton_code(pk[0:3], pk[3:6], lo, span))


def _reorder_perm(pk, lo, span):
    """The stable permutation that sorts the packed rays by ``_morton_key``."""
    return torch.sort(_morton_key(pk, lo, span), stable=True)[1]


def _any_active(active, comm):
    """Whether any ray is still active: on this rank, or with `comm` on
    any rank of the wavefront (one sum over the ranks)."""
    alive = active.any()
    if comm is not None:
        alive = comm.sum(alive.to(torch.int32).reshape(1), "alive")[0] > 0
    return bool(alive)


def _trace_chunks(scene: Scene, cfg: RenderConfig, pk, bkey, live_end: int, ch: int,
                  first: int = 0):
    """One bounce of the packed wavefront pk [21, n] in chunks of ch lanes:
    chunk j, the global lanes [j * ch, (j + 1) * ch), is traced under
    ``fold_in(bkey, j)`` with its lanes numbered from the chunk's start,
    for j = 0, 1, ... while j * ch < live_end (the global lane after the
    last live one); the lanes past the last chunk traced stay as they are.
    pk holds the global lanes [first, first + n) and traces its share of
    each chunk -> pk, written in place."""
    n = pk.shape[1]
    j = 0
    while j * ch < live_end:
        lo, hi = max(j * ch, first), min((j + 1) * ch, first + n)
        if lo < hi:
            view = pk[:, lo - first:hi - first]
            at = None if hi - lo == ch else (lo - j * ch, ch)
            with span("vt.bounce"):
                _bounce_core(scene, cfg, view, view[_PK_ACTIVE] > 0.5, fold_in(bkey, j), at)
        j += 1
    return pk


def _unpermute(scene: Scene, cfg: RenderConfig, pk, first: int, total: int, comm=None):
    """A permuted wavefront's radiance and light-kill flags in the first
    lane order.  The packed state pk holds the global lanes [first, first +
    n) of a wavefront of `total`, each with its first lane; with `comm` the
    other ranks hold the rest and their rows come through one gather ->
    (radiance [n, 3], flags [n] or None) of the first lanes [first, first +
    n)."""
    n, dev = pk.shape[1], pk.device
    rows = list(_apply_deferred_sky(scene, cfg, pk)) + [pk[_PK_PIX]]
    with span("vt.reorder.undo"):
        if pk.shape[0] > _PK_ROWS:
            rows.append(pk[_PK_ROWS])
        out = torch.stack(rows)
        if comm is not None:
            out = comm.gather(out, "unpermute")
        inv = torch.empty(total, dtype=torch.int64, device=dev)
        inv[out[3].to(torch.int64)] = torch.arange(total, device=dev)
        out = out.index_select(1, inv[first:first + n])
        return out[:3].T.contiguous(), out[4] > 0.5 if len(rows) > 4 else None


def _trace_path_reordered(scene: Scene, cfg: RenderConfig, o, d, key, lanes=None, comm=None):
    """The bounce loop with the wavefront re-clustered in space: before
    bounce 1 and then every cfg.bounce_reorder_period-th bounce the state
    is sorted by ``_morton_key`` (one stable sort and one gather of the
    packed state), so a block's rays start in the same coarse world cell
    heading the same way and the terminated rays gather at the tail.
    Bounce 0 keeps the camera's order.  The packed state of the rays o, d
    (``_first_path``) carries each ray's first lane, and the radiance goes
    back to it at the end by the inverse permutation.  With
    cfg.reorder_compact_chunks = k > 1 dividing the wavefront, each bounce
    traces chunks of n / k lanes and stops after the one that holds the
    last live lane (``_trace_chunks``; the sort puts the terminated rays
    last).  -> (radiance [n, 3], the state's light-kill flags [n] or
    None), both in the first order.

    With lanes = (first, total) and `comm` (the collectives of the ranks
    that share one wavefront of `total` rays, ``dist.mesh.RankComm``) this
    rank holds lanes [first, first + n): each reorder gathers every rank's
    packed state, sorts the whole wavefront as one process would and keeps
    this rank's window of it, the bounces draw at the global lanes, the
    chunks are global lane ranges (the last live lane comes from one
    gather of each rank's), the loop stops when no lane of any rank is
    active, and the radiance comes back to its first lane through the
    gathered first-lane ids.  The result is the window's slice of the
    one-process result, bit for bit."""
    n, dev = o.shape[0], o.device
    first, total = (0, n) if lanes is None else lanes
    pk, active = _first_path(cfg, o, d, first)
    lo, hi = _world_bounds(scene)
    box = torch.clamp(hi - lo, min=1e-6)
    per = max(cfg.bounce_reorder_period, 1)
    kc = cfg.reorder_compact_chunks
    chunked = kc > 1 and total % kc == 0
    for depth in range(cfg.max_bounces + 1):
        if not _any_active(active, comm):
            break
        if depth > 0 and (depth - 1) % per == 0:
            with span("vt.reorder"):
                if comm is not None:
                    pk = comm.gather(pk, "reorder")
                pk = pk.index_select(1, _reorder_perm(pk, lo, box)[first:first + n])
                active = pk[_PK_ACTIVE] > 0.5
        bkey = fold_in(key, depth)
        if chunked:
            lane = torch.arange(first + 1, first + n + 1, device=dev)
            live_end = torch.where(active, lane, 0).amax().reshape(1)
            if comm is not None:
                live_end = comm.gather(live_end, "live")
            _trace_chunks(scene, cfg, pk, bkey, int(live_end.max()), total // kc, first)
            active = pk[_PK_ACTIVE] > 0.5
        else:
            with span("vt.bounce"):
                active = _bounce_core(scene, cfg, pk, active, bkey, lanes)
    return _unpermute(scene, cfg, pk, first, total, comm)


def _trace_path_compacted(scene: Scene, cfg: RenderConfig, o, d, key, lanes=None, comm=None):
    """The bounce loop with the wavefront compacted: before each bounce the
    live rays move to a prefix in their order and the terminated ones
    after them (a stable partition of the packed state of the rays o, d),
    and the bounce traces chunks of n / cfg.compact_chunks lanes up to the
    one that holds the last live ray (``_trace_chunks``), so the traversals
    of the later bounces run on the chunks that still hold rays.  ->
    (radiance [n, 3], light-kill flags [n] or None) in the first order, as
    ``_trace_path_reordered``.

    With lanes = (first, total) and `comm`, each bounce gathers every
    rank's packed state, partitions the whole wavefront and keeps this
    rank's window; the gathered state says how many rays live, so every
    rank stops on the same bounce.  Bit for bit the window's slice of the
    one-process result."""
    n = o.shape[0]
    first, total = (0, n) if lanes is None else lanes
    pk = _first_path(cfg, o, d, first)[0]
    for depth in range(cfg.max_bounces + 1):
        if comm is not None:
            pk = comm.gather(pk, "compact")
        act = pk[_PK_ACTIVE] > 0.5
        live = int(act.sum())
        if live == 0:
            pk = pk[:, first:first + n]
            break
        perm = torch.cat([act.nonzero()[:, 0], (~act).nonzero()[:, 0]])
        pk = _trace_chunks(scene, cfg, pk.index_select(1, perm[first:first + n]),
                           fold_in(key, depth), live, total // cfg.compact_chunks, first)
    return _unpermute(scene, cfg, pk, first, total, comm)


def path_loop(scene: Scene, cfg: RenderConfig, n: int) -> str:
    """Which bounce loop trace_path runs on a wavefront of n rays:
    "compact" (cfg.compact_chunks), "reorder" (cfg.bounce_reorder) or
    "plain"; the compaction comes first, as in the JAX package."""
    if cfg.compact_chunks > 1 and n >= cfg.compact_min and n % cfg.compact_chunks == 0:
        return "compact"
    if cfg.max_bounces >= 1 and (
            cfg.bounce_reorder == "always"
            or (cfg.bounce_reorder == "auto" and _is_paged(scene) and n >= cfg.compact_min)):
        return "reorder"
    return "plain"


def trace_path(scene: Scene, cfg: RenderConfig, o, d, key, return_aux: bool = False,
               lanes=None, comm=None):
    """Full stochastic light transport; o, d: [N, 3] -> radiance [N, 3],
    and with return_aux a dict with the per-ray light-kill flags
    ``in_light`` [N] (renderer.cpp:1437-1450; all false unless
    cfg.detect_light_kill).  Up to max_bounces + 1 segments
    (renderer.cpp:1076-1083), stopping early once every ray has
    terminated.  With cfg.compact_chunks the live rays are compacted
    between bounces (``_trace_path_compacted``), else with
    cfg.bounce_reorder the wavefront may be re-sorted
    (``_trace_path_reordered``).  The rays draw their samples at `lanes` =
    (first, total), lanes [first, first + N) of a wavefront of total rays
    (``core.rng.counters``; None: (0, N)).  A compacted or re-sorted
    wavefront is the whole one, so a window of lanes other than (0, N)
    traces such a frame only with `comm`, the collectives of the ranks
    that hold the other lanes; without it the frame is refused."""
    n, dev = o.shape[0], o.device
    if lanes is not None and tuple(lanes) == (0, n):
        lanes = None
    loop = path_loop(scene, cfg, n if lanes is None else lanes[1])
    if loop != "plain" and lanes is not None and comm is None:
        what = "compaction partitions" if loop == "compact" else "bounce reorder sorts"
        raise ValueError(f"the {what} the whole wavefront: a window of lanes "
                         f"{tuple(lanes)} cannot trace its share without the other ranks "
                         "(comm)")
    if loop == "compact":
        rad, in_light = _trace_path_compacted(scene, cfg, o, d, key, lanes, comm)
    elif loop == "reorder":
        rad, in_light = _trace_path_reordered(scene, cfg, o, d, key, lanes, comm)
    else:
        pk, active = _first_path(cfg, o, d, 0 if lanes is None else lanes[0])
        for depth in range(cfg.max_bounces + 1):
            if not bool(active.any()):
                break
            with span("vt.bounce"):
                active = _bounce_core(scene, cfg, pk, active, fold_in(key, depth), lanes)
        rad = cstack(_apply_deferred_sky(scene, cfg, pk))
        in_light = pk[_PK_ROWS] > 0.5 if cfg.detect_light_kill else None
    if not return_aux:
        return rad
    if in_light is None:
        in_light = torch.zeros(n, dtype=torch.bool, device=dev)
    return rad, dict(in_light=in_light)


# --------------------------------------------------------------------------
# Deterministic Whitted integrator: the recursive parity oracle and the
# branch-queue wavefront the renderer runs
# --------------------------------------------------------------------------

NO_KEY = (0, 0)  # jax.random.PRNGKey(0): whitted's area-light samples


def _unit(v):
    """[N, 3] -> unit vectors; zero vectors stay zero."""
    return v / torch.clamp(mathx.sqrt(mathx.dot3(v, v)), min=1e-20)[:, None]


def _media_split(in_glass, is_glass_m, is_smoke, glass_mask, smoke_mask,
                 march, t, ior, emis, alb, cos_g):
    """Fresnel coefficient and media colour of a glass or smoke hit: the
    refraction ratio, the reflected share r (1 under total internal
    reflection, 0 for smoke) and the colour both branches carry (glass
    albedo inside glass, Beer-Lambert transmittance through smoke).  alb,
    returned colour: component tuples."""
    ratio = torch.where(in_glass, ior, 1.0 / ior)
    ratio = torch.where(is_smoke, 1.0, ratio)
    sin_g = mathx.sqrt(torch.clamp(1.0 - cos_g * cos_g, min=0.0))
    cannot_refract = (ratio * sin_g > 1.0) & glass_mask
    r_coef = torch.where(cannot_refract, 1.0, mathx.schlick(cos_g, ratio))
    r_coef = torch.where(smoke_mask, 0.0, r_coef)
    one = torch.ones_like(t)
    glass_color = cwhere(in_glass, alb, (one, one, one))
    intensity = torch.where(in_glass & is_smoke, emis, 0.0)
    dist = torch.where(march, t, 0.0)
    smoke_trans = tuple(torch.exp(-dist * intensity * (1.0 - alb[i])) for i in range(3))
    return ratio, r_coef, cwhere(smoke_mask, smoke_trans, glass_color)


def trace_whitted(scene: Scene, cfg: RenderConfig, o, d, depth: int,
                  in_glass=None, active=None):
    """Recursive Whitted (renderer.cpp:1076-1328 with the NEE sum, perfect
    mirrors and the Fresnel split): every branch is a full-width call, so
    the tree costs 3^depth traversals.  The parity oracle of
    ``trace_whitted_iter``.  o, d: [N, 3] -> radiance [N, 3]."""
    n, dev = o.shape[0], o.device
    if in_glass is None:
        in_glass = torch.zeros(n, dtype=torch.bool, device=dev)
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    if depth < 0:
        return torch.zeros((n, 3), dtype=F32, device=dev)

    rec = find_nearest_world(scene, o, d, active)
    t, mat, vol = rec["t"], rec["mat"], rec["vol"]
    nrm = torch.stack([rec["nx"], rec["ny"], rec["nz"]], dim=-1)
    in_glass = torch.where(rec["prim_adopt"], rec["prim_inside"], in_glass)
    sky = sample_sky(scene.sky, d, cfg.activate_sky, cfg.sky_fallback)
    miss = active & (mat == MAT_NONE)
    color = torch.where(miss[:, None], sky, 0.0)

    m, mi = scene.materials, mat.long()
    alb, emis, ior = m.albedo[mi], m.emissive[mi], m.ior[mi]
    is_metal = (mat >= METAL_HIGH) & (mat <= METAL_LOW)
    is_glass_m = mat == GLASS
    is_smoke = (mat >= SMOKE_LOW_DENSITY) & (mat <= SMOKE_PLAYER)
    is_emissive = mat == EMISSIVE
    is_model = (mat > EMISSIVE) & (mat != MAT_NONE)
    is_diffuse = (mat < METAL_HIGH) | is_model

    march = active & in_glass & (is_glass_m | is_smoke) & (vol >= 0)
    if bool(march.any()):
        mode_code = torch.where(is_glass_m, EXIT_GLASS, EXIT_SMOKE).to(torch.int32)
        in_vol, t_exit, nrm_exit = material_exit_world(scene, o, d, vol, mode_code, march)
        t = torch.where(march, t_exit, t)
        nrm = torch.where((march & in_vol)[:, None], cstack(nrm_exit), nrm)
        fell = march & ~in_vol
        o = torch.where(fell[:, None], o + t[:, None] * d, o)
        t = torch.where(fell, 0.0, t)
    p_hit = o + t[:, None] * d

    color = color + torch.where((active & is_emissive)[:, None], alb * emis[:, None], 0.0)
    nee_mask = active & is_diffuse
    inc = cstack(illumination(scene, cfg, cpack(p_hit), cpack(nrm), nee_mask, NO_KEY,
                              cpack(alb)))
    color = color + torch.where((nee_mask & ~is_model)[:, None], inc, 0.0)
    color = color + torch.where((nee_mask & is_model)[:, None], inc * alb, 0.0)
    if depth == 0:
        return color

    # metal: perfect mirror
    refl = _unit(mathx.reflect(d, nrm))
    metal_mask = active & is_metal
    mo = cstack(coffset(cpack(p_hit), cpack(nrm)))
    sub = trace_whitted(scene, cfg, mo, refl, depth - 1,
                        torch.zeros(n, dtype=torch.bool, device=dev), metal_mask)
    color = color + torch.where(metal_mask[:, None], sub * alb, 0.0)

    if not cfg.whitted_glass_split:
        return color
    # glass: the Fresnel split; smoke passes straight through
    glass_mask = active & is_glass_m
    smoke_mask = active & is_smoke
    media_mask = glass_mask | smoke_mask
    cos_g = torch.clamp(mathx.dot3(-d, nrm), max=1.0)
    ratio, r_coef, media_color = _media_split(
        in_glass, is_glass_m, is_smoke, glass_mask, smoke_mask, march, t,
        ior, emis, cpack(alb), cos_g)
    media_color = cstack(media_color)
    need_refl = glass_mask & (r_coef > 0.0)
    sub_r = trace_whitted(scene, cfg, mo, refl, depth - 1, in_glass, need_refl)
    color = color + torch.where(need_refl[:, None],
                                sub_r * media_color * r_coef[:, None], 0.0)
    refr_dir = torch.where(smoke_mask[:, None], d, mathx.refract(d, nrm, ratio))
    need_refr = media_mask & (r_coef < 1.0)
    fo = cstack(coffset(cpack(p_hit), cpack(-nrm)))
    sub_t = trace_whitted(scene, cfg, fo, _unit(refr_dir), depth - 1,
                          torch.where(media_mask, ~in_glass, in_glass), need_refr)
    color = color + torch.where(need_refr[:, None],
                                sub_t * media_color * (1.0 - r_coef[:, None]), 0.0)
    return color


# the queue's packed columns: origin, direction, RGB weight, inside-medium
# flag, depth left, pixel id, and in an exact queue the branch code (1 for
# a pixel's first branch; the children of branch c are 2c and 2c + 1)
_QO, _QD, _QW, _QGL, _QDEP, _QPIX, _QCODE = 0, 3, 6, 9, 10, 11, 12


def _qpack(o, d, w, gl, dep, pix, code=None):
    cols = [o[0], o[1], o[2], d[0], d[1], d[2], w[0], w[1], w[2], gl, dep, pix]
    return torch.stack(cols if code is None else cols + [code], dim=1)


def trace_whitted_iter(scene: Scene, cfg: RenderConfig, o, d, depth: int,
                       return_iters: bool = False):
    """Iterative Whitted (``whitted_queue``): o, d [N, 3] -> radiance
    [N, 3]; with return_iters, (radiance, iterations)."""
    img, it, _ = whitted_queue(scene, cfg, o, d, depth)
    return (img, it) if return_iters else img


def _sum_in_branch_order(n, log, depth):
    """Each pixel's logged contributions summed one at a time in the order
    of their branch codes -> radiance [n, 3].  log: (pixel ids [M] i64,
    branch codes [M] i64, contributions [M, 3]) chunks."""
    dev = log[0][2].device
    img = torch.zeros((n, 3), dtype=F32, device=dev)
    pix = torch.cat([c[0] for c in log])
    order = torch.sort(pix * (1 << (depth + 2)) + torch.cat([c[1] for c in log]))[1]
    pix, val = pix[order], torch.cat([c[2] for c in log])[order]
    rank = torch.arange(pix.shape[0], device=dev) - torch.searchsorted(pix, pix)
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        at = (rank == r).nonzero()[:, 0]  # at most one entry a pixel
        img[pix[at]] += val[at]
    return img


def _queue_batch(scene: Scene, cfg: RenderConfig, batch, live, mtab, lanes=None):
    """One batch of the branch queue: the rows `batch` [B, cols] of the
    packed queue, of which `live` [B] hold a branch: one nearest
    traversal, the emissive and NEE radiance and up to two weighted
    children per branch (metal mirror or refracted branch; reflected glass
    branch), those whose weight is at most cfg.whitted_cull_eps invalid.
    The light samples are drawn at `lanes` (``core.rng.counters``; None:
    the batch's rows).  A queue with the branch-code column gives child c
    of code k the code 2k + c - 1.  -> (contribution, a component tuple;
    the children [2B, cols], child 1 of every row, then child 2 of every
    row; valid [2B])."""
    b, dev = batch.shape[0], batch.device
    zero = (torch.zeros(b, dtype=F32, device=dev),) * 3
    to, td = batch[:, _QO:_QO + 3], batch[:, _QD:_QD + 3]
    toc, tdc = cpack(to), cpack(td)
    w = cpack(batch[:, _QW:_QW + 3])
    in_glass = batch[:, _QGL] > 0.5
    dep = batch[:, _QDEP].to(torch.int32)
    pixf = batch[:, _QPIX]
    code = batch[:, _QCODE] if batch.shape[1] > _QCODE else None

    rec = find_nearest_world(scene, to, td, live)
    t, mat, vol = rec["t"], rec["mat"], rec["vol"]
    nrm = (rec["nx"], rec["ny"], rec["nz"])
    in_glass = torch.where(rec["prim_adopt"], rec["prim_inside"], in_glass)
    sky = cpack(sample_sky(scene.sky, td, cfg.activate_sky, cfg.sky_fallback))
    miss = live & (mat == MAT_NONE)
    contrib = cwhere(miss, cmul(w, sky), zero)
    live_hit = live & ~miss

    mrow = lookup_rows(mtab, torch.clamp(mat, 0, 255))
    alb = (mrow[:, 0], mrow[:, 1], mrow[:, 2])
    emis, ior = mrow[:, 3], mrow[:, 4]
    is_metal = (mat >= METAL_HIGH) & (mat <= METAL_LOW)
    is_glass_m = mat == GLASS
    is_smoke = (mat >= SMOKE_LOW_DENSITY) & (mat <= SMOKE_PLAYER)
    is_emissive = mat == EMISSIVE
    is_model = (mat > EMISSIVE) & (mat != MAT_NONE)
    is_diffuse = (mat < METAL_HIGH) | is_model

    # medium march, skipped on iterations with no ray inside a medium
    march = live_hit & in_glass & (is_glass_m | is_smoke) & (vol >= 0)
    if bool(march.any()):
        mode_code = torch.where(is_glass_m, EXIT_GLASS, EXIT_SMOKE).to(torch.int32)
        in_vol, t_exit, nrm_exit = material_exit_world(scene, to, td, vol, mode_code, march)
        t = torch.where(march, t_exit, t)
        nrm = cwhere(march & in_vol, nrm_exit, nrm)
        fell = march & ~in_vol
        toc = cwhere(fell, cadd(toc, cscale(t, tdc)), toc)
        t = torch.where(fell, 0.0, t)
    p_hit = cadd(toc, cscale(t, tdc))

    contrib = cwhere(live_hit & is_emissive, cadd(contrib, cmul(w, cscale(emis, alb))), contrib)
    nee_mask = live_hit & is_diffuse & (dep >= 0)
    inc = illumination(scene, cfg, p_hit, nrm, nee_mask, NO_KEY, alb, lanes)
    contrib = cwhere(nee_mask & ~is_model, cadd(contrib, cmul(w, inc)), contrib)
    contrib = cwhere(nee_mask & is_model, cadd(contrib, cmul(w, cmul(alb, inc))), contrib)

    can_rec = dep > 0
    refl = cunit(creflect(tdc, nrm))
    metal_go = live_hit & is_metal & can_rec
    mo = coffset(p_hit, nrm)
    glass_mask = live_hit & is_glass_m
    smoke_mask = live_hit & is_smoke
    media_mask = (glass_mask | smoke_mask) & can_rec
    cos_g = torch.clamp(cdot(cneg(tdc), nrm), max=1.0)
    ratio, r_coef, media_color = _media_split(
        in_glass, is_glass_m, is_smoke, glass_mask, smoke_mask, march, t,
        ior, emis, alb, cos_g)
    refr_dir = cunit(cwhere(smoke_mask, tdc, crefract(tdc, nrm, ratio)))
    fo = coffset(p_hit, cneg(nrm))
    need_refr = media_mask & (r_coef < 1.0)
    need_refl = media_mask & glass_mask & (r_coef > 0.0)
    if not cfg.whitted_glass_split:  # a dielectric hit ends its branch
        need_refr = need_refl = torch.zeros_like(media_mask)

    # child 1: the metal mirror or the refracted branch; child 2: the
    # reflected glass branch
    c1 = metal_go | need_refr
    c1_w = cwhere(metal_go, cmul(w, alb), cscale(1.0 - r_coef, cmul(w, media_color)))
    gl = in_glass.to(F32)
    c1_gl = torch.where(metal_go, 0.0, torch.where(media_mask, 1.0 - gl, gl))
    w_refl = cscale(r_coef, cmul(w, media_color))
    c2 = need_refl
    if cfg.whitted_cull_eps > 0.0:
        eps = cfg.whitted_cull_eps
        c1 = c1 & (torch.maximum(torch.maximum(c1_w[0], c1_w[1]), c1_w[2]) > eps)
        c2 = c2 & (torch.maximum(torch.maximum(w_refl[0], w_refl[1]), w_refl[2]) > eps)
    dep_c = (dep - 1).to(F32)
    children = torch.cat([
        _qpack(cwhere(metal_go, mo, fo), cwhere(metal_go, refl, refr_dir), c1_w,
               c1_gl, dep_c, pixf, None if code is None else 2.0 * code),
        _qpack(mo, refl, w_refl, gl, dep_c, pixf, None if code is None else 2.0 * code + 1.0)])
    return contrib, children, torch.cat([c1, c2])


def whitted_queue(scene: Scene, cfg: RenderConfig, o, d, depth: int, exact: bool = False,
                  lanes=None, comm=None):
    """Iterative Whitted as a fixed-width wavefront queue over branches.

    All pixels' pending branches sit in one packed [5N, 12] f32 queue
    (columns as _QO.._QPIX).  Each iteration takes the first W = N rows,
    whoever's they are (``_queue_batch``): one nearest traversal, the
    emissive and NEE radiance (a flat [3N] scatter-add per pixel and
    channel), then up to two weighted children per branch.  The children
    are compacted stably (cumsum and a position scatter), all first
    children before all second ones, and appended behind the rest of the
    queue, which moves down by W; past 4N the newest branches are dropped
    first.  The loop stops when the queue is empty or after
    4 * (depth + 2) + 8 iterations.  Per-branch maths is
    ``trace_whitted``'s; only each pixel's summation order differs.  With
    cfg.whitted_sort_batch each batch is sorted by (live, morton code of
    the origin, direction octant) before it is traced (``_batch_key``), as
    the JAX package sorts it: the children follow the sorted order.  The
    queue population is read on the host once per iteration.  o, d:
    [N, 3] -> (radiance [N, 3], iterations, largest queue population).

    exact (``_exact_queue``): the same queue with no branch dropped (it
    grows past 5N and runs until it is empty) and each pixel's
    contributions logged and summed in the order of their branch codes
    (a 13th column, ``_QCODE``; ``_sum_in_branch_order``), not as the
    batches meet them; the batch sort there changes only the order in
    which a batch's rows are traced.  With lanes = (first, total) and `comm` (the
    collectives of the ranks that hold the other rays,
    ``dist.mesh.RankComm``), these rays are lanes [first, first + N) of
    one queue of `total` rays split over the ranks."""
    if exact:
        return _exact_queue(scene, cfg, o, d, depth, lanes, comm)
    if lanes is not None or comm is not None:
        raise ValueError("a queue split over ranks runs in its exact order (exact=True)")
    n, dev = o.shape[0], o.device
    w_, cap = n, 5 * n
    one = torch.ones(n, dtype=F32, device=dev)
    fr = torch.zeros((cap, _QCODE), dtype=F32, device=dev)
    fr[:n] = _qpack(cpack(o), cpack(d), (one, one, one), torch.zeros_like(one),
                    torch.full_like(one, float(depth)), torch.arange(n, dtype=F32, device=dev))
    img = torch.zeros(3 * n, dtype=F32, device=dev)
    mtab = _queue_table(scene)
    lane = torch.arange(w_, device=dev)
    chan = torch.arange(3, device=dev)[:, None]
    box = _batch_box(scene, cfg)
    count, it, peak = n, 0, n
    while count > 0 and it < 4 * (depth + 2) + 8:
        batch = fr[:w_]
        live = lane < min(count, w_)
        if box is not None:
            # traced in the sorted order: the children follow it, and each
            # branch draws its light samples at its sorted slot
            skey, perm = torch.sort(torch.where(live, _batch_key(batch, box), 1 << 30),
                                    stable=True)
            batch, live = batch[perm], skey < (1 << 30)
        contrib, children, valid = _queue_batch(scene, cfg, batch, live, mtab)
        pix = batch[:, _QPIX].to(torch.int64)
        img.index_add_(0, (pix * 3 + chan).reshape(-1),
                       torch.where(live, cstack(contrib).T, 0.0).reshape(-1))
        # stable compaction: each valid child's destination is its rank
        # among the valid ones; invalid children land in a spill slot
        dest = torch.cumsum(valid.to(torch.int64), 0) - 1
        nc = int(dest[-1]) + 1
        src = torch.zeros(2 * w_ + 1, dtype=torch.int64, device=dev)
        src.scatter_(0, torch.where(valid, dest, 2 * w_), torch.arange(2 * w_, device=dev))
        # pop the batch, append the children behind what remains
        rem = min(max(count - w_, 0), 4 * n - 2 * w_)
        fr = torch.roll(fr, -w_, dims=0)
        fr[rem:rem + nc] = children[src[:nc]]
        count = rem + nc
        peak = max(peak, count)
        it += 1
    return img.reshape(n, 3), it, peak


def _batch_box(scene: Scene, cfg: RenderConfig):
    """With cfg.whitted_sort_batch, the world box the queue's batch key
    quantises origins in (lo, span); else None."""
    if not cfg.whitted_sort_batch:
        return None
    lo, hi = _world_bounds(scene)
    return lo, torch.clamp(hi - lo, min=1e-6)


def _batch_key(batch, box):
    """The queue rows' ``_morton_code`` (origin, direction) in the box."""
    return _morton_code(cpack(batch[:, _QO:_QO + 3]), cpack(batch[:, _QD:_QD + 3]), *box)


def _queue_table(scene: Scene):
    """The queue's [256, 5] material rows: albedo, emissive, ior."""
    m = scene.materials
    return torch.cat([m.albedo, m.emissive[:, None], m.ior[:, None]], dim=1)


def _exact_queue(scene: Scene, cfg: RenderConfig, o, d, depth: int, lanes=None, comm=None):
    """``whitted_queue(exact=True)``.  Every row carries its position in
    the one queue of all `total` rays (an int64 side tensor: positions
    reach 5 * total, past f32's exact integers at 1080p), and each
    iteration takes the rows at positions below W = total, each drawing
    its light samples at its position: its slot in the batch, as the
    global queue draws.  A child's position is the start of the child
    block plus its rank among all valid children, keyed (which child,
    the parent's slot); with `comm` one sum over the ranks of a [2W]
    uint8 indicator of those keys gives it (the children's global ranks
    and count), so every rank keeps its own rows and knows the global
    count.  The queue stops when no rank holds a row.

    Each pixel's radiance is then the one-process queue's bit for bit,
    on any split of the rays over ranks; it equals the JAX package's
    global FIFO queue (``trace_whitted_iter`` on all `total` rays) wherever
    that queue never holds more than 4 * total branches and ends within
    its 4 * (depth + 2) + 8 iterations, up to the order of each pixel's
    sum.  Without `comm` the rays are a queue of their own (lanes (0, N))."""
    n, dev = o.shape[0], o.device
    if depth > 21:
        raise ValueError(f"depth {depth}: branch codes past 2^23 are not exact in the "
                         "queue's f32 columns")
    if comm is None and lanes is not None and tuple(lanes) != (0, n):
        raise ValueError(f"lanes {tuple(lanes)} of a queue split over ranks need comm")
    first, w_ = (0, n) if lanes is None else lanes
    one = torch.ones(n, dtype=F32, device=dev)
    fr = _qpack(cpack(o), cpack(d), (one, one, one), torch.zeros_like(one),
                torch.full_like(one, float(depth)), torch.arange(n, dtype=F32, device=dev), one)
    pos = torch.arange(first, first + n, dtype=torch.int64, device=dev)
    mtab = _queue_table(scene)
    box = _batch_box(scene, cfg)
    log = []
    count, it, peak = w_, 0, w_
    while count > 0:
        b = int((pos < w_).sum())  # the rows are in position order
        batch, slot = fr[:b], pos[:b]
        key = slot[:0]
        if b:
            live = torch.ones(b, dtype=torch.bool, device=dev)
            if box is None:
                contrib, children, valid = _queue_batch(scene, cfg, batch, live, mtab,
                                                        (slot, w_))
            else:
                # dispatch order only: the rows are traced sorted, each still
                # drawing at its slot, and the results go back to slot order,
                # so the queue and every pixel are the unsorted queue's
                perm = torch.sort(_batch_key(batch, box), stable=True)[1]
                contrib, children, valid = _queue_batch(scene, cfg, batch[perm], live, mtab,
                                                        (slot[perm], w_))
                inv = torch.empty_like(perm)
                inv[perm] = torch.arange(b, device=dev)
                inv2 = torch.cat([inv, inv + b])
                contrib = tuple(c[inv] for c in contrib)
                children, valid = children[inv2], valid[inv2]
            c3 = cstack(contrib)
            at = (c3 != 0.0).any(-1).nonzero()[:, 0]
            log.append((batch[at, _QPIX].to(torch.int64), batch[at, _QCODE].to(torch.int64),
                        c3[at]))
            keep = valid.nonzero()[:, 0]  # first children, then second, by slot
            key = torch.cat([slot, slot + w_])[keep]
        rem = max(count - w_, 0)
        if comm is None:
            born = key.shape[0]
            new_pos = rem + torch.arange(born, device=dev)
        else:
            ind = torch.zeros(2 * w_, dtype=torch.uint8, device=dev)
            ind[key] = 1
            upto = torch.cumsum(comm.sum(ind, "queue"), 0, dtype=torch.int64)
            born = int(upto[-1])
            new_pos = rem + upto[key] - 1
        fr = torch.cat([fr[b:], children[keep]]) if b else fr
        pos = torch.cat([pos[b:] - w_, new_pos])
        count = rem + born
        peak = max(peak, count)
        it += 1
    img = _sum_in_branch_order(n, log, depth) if log else torch.zeros((n, 3), dtype=F32,
                                                                         device=dev)
    return img, it, peak


# --------------------------------------------------------------------------
# Top-level rendering
# --------------------------------------------------------------------------

def _sample_pixels(scene: Scene, cfg: RenderConfig, key, px, py, return_aux: bool = False):
    """One sample for the given pixel coordinates -> radiance [N, 3] (with
    return_aux also trace_path's aux dict; its flags are all false outside
    path mode).  Primary and whitted rays go through the pixel corner,
    unjittered and through a pinhole; path rays are jittered and, with
    cfg.use_dof, take a thin-lens sample."""
    n, dev = px.shape[0], px.device
    lens = None
    if cfg.mode == "path":
        u = _uni(cfg, key, 100, (n, 2), dev)
        px = px + u[:, 0] * cfg.aa_strength
        py = py + u[:, 1] * cfg.aa_strength
        if cfg.use_dof:
            lens = _uni(cfg, key, 101, (n, 2), dev)
    o, d = primary_rays(scene.camera, cfg.width, cfg.height, px, py, lens)
    o = o.contiguous()
    if cfg.mode == "path":
        return trace_path(scene, cfg, o, d, key, return_aux)
    if cfg.mode == "primary":
        rec = find_nearest_world(scene, o, d, torch.ones(n, dtype=torch.bool, device=dev))
        sky = sample_sky(scene.sky, d, cfg.activate_sky, cfg.sky_fallback)
        rad = torch.where(rec["hit"][:, None], scene.materials.albedo[rec["mat"].long()], sky)
    elif cfg.mode == "whitted":
        rad = trace_whitted_iter(scene, cfg, o, d, cfg.max_bounces)
    else:
        raise ValueError(f"mode {cfg.mode!r} has no per-pixel sample (reproject frames "
                     "come from render/reproject.render_reproject_frame)")
    if return_aux:
        return rad, dict(in_light=torch.zeros(n, dtype=torch.bool, device=dev))
    return rad


def _pixel_grid(cfg: RenderConfig, dev):
    """The pixels' corner coordinates in scanline order -> (px, py), [H*W] each."""
    py, px = torch.meshgrid(torch.arange(cfg.height, dtype=F32, device=dev),
                            torch.arange(cfg.width, dtype=F32, device=dev),
                            indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def render_sample(scene: Scene, cfg: RenderConfig, key):
    """One sample per pixel, scanline order -> radiance [H*W, 3]."""
    return _sample_pixels(scene, cfg, key, *_pixel_grid(cfg, scene.device))


def render_game_frame(scene: Scene, cfg: RenderConfig, key, spp: int = 1):
    """The game loop's frame: the average of spp scanline-order samples
    (sample i under ``fold_in(key, i)``) -> (radiance [H, W, 3], the
    light-kill flag: a 0-d bool tensor, whether any ray of any sample saw a
    lit player-smoke cell, renderer.cpp:1437-1450).  Needs path mode and
    cfg.detect_light_kill for a flag that can be true."""
    px, py = _pixel_grid(cfg, scene.device)
    acc = torch.zeros((cfg.width * cfg.height, 3), dtype=F32, device=scene.device)
    lit = torch.zeros((), dtype=torch.bool, device=scene.device)
    for i in range(spp):
        rad, aux = _sample_pixels(scene, cfg, fold_in(key, i), px, py, return_aux=True)
        acc = acc + rad
        lit = lit | aux["in_light"].any()
    return (acc / spp).reshape(cfg.height, cfg.width, 3), lit


def render(scene: Scene, cfg: RenderConfig, key, spp: int = 1):
    """The average of spp scanline-order samples -> radiance [H, W, 3]."""
    acc = torch.zeros((cfg.width * cfg.height, 3), dtype=F32, device=scene.device)
    for i in range(spp):
        acc = acc + render_sample(scene, cfg, fold_in(key, i))
    return (acc / spp).reshape(cfg.height, cfg.width, 3)


def _tile_shape(cfg: RenderConfig):
    """(tile_h, tile_w) for ray_order "tile", else (None, None)."""
    if cfg.ray_order != "tile" or cfg.width % 128 != 0:
        return None, None
    return 8, 128


def _band_radiance(scene: Scene, cfg: RenderConfig, key, row0: int, rows: int,
                   spp: int):
    """spp-averaged radiance [rows * W, 3] of `rows` scanlines from row0;
    rows past the image bottom repeat the last scanline.  With tile ray
    order the rays are generated in 8x128-pixel tiles and the radiance is
    un-tiled afterwards."""
    dev = scene.device
    th, tw = _tile_shape(cfg)
    if th is None:
        x = torch.arange(cfg.width, dtype=F32, device=dev)
        y = torch.clamp(torch.arange(rows, dtype=F32, device=dev) + float(row0),
                        max=cfg.height - 1)
        py, px = torch.meshgrid(y, x, indexing="ij")
        px, py = px.reshape(-1), py.reshape(-1)
        rows_p = rows
    else:
        rows_p = -(-rows // th) * th
        ntx = cfg.width // tw
        i = torch.arange(rows_p * cfg.width, dtype=torch.int64, device=dev)
        tile, rem = i // (th * tw), i % (th * tw)
        ty, tx = tile // ntx, tile % ntx
        iy, ix = rem // tw, rem % tw
        px = (tx * tw + ix).to(F32)
        py = torch.clamp((ty * th + iy).to(F32) + float(row0), max=cfg.height - 1)

    acc = torch.zeros((rows_p * cfg.width, 3), dtype=F32, device=dev)
    for s in range(spp):
        acc = acc + _sample_pixels(scene, cfg, fold_in(fold_in(key, s), row0), px, py)
    acc = acc / spp
    if th is not None:
        acc = acc.reshape(rows_p // th, ntx, th, tw, 3).permute(0, 2, 1, 3, 4)
        acc = acc.reshape(rows_p, cfg.width, 3)[:rows].reshape(rows * cfg.width, 3)
    return acc


def render_tiled(scene: Scene, cfg: RenderConfig, key, spp: int = 1,
                 tiles: int = 8):
    """Render in `tiles` row bands -> radiance [H, W, 3] on the scene's
    device.  A band bounds the wavefront's memory; the image does not
    depend on the band count beyond which key each band folds in."""
    h, w = cfg.height, cfg.width
    rows = -(-h // tiles)
    bands = [_band_radiance(scene, cfg, key, b * rows, rows, spp)
             for b in range(tiles)]
    return torch.cat(bands).reshape(tiles * rows, w, 3)[:h]
