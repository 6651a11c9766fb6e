"""Wavefront path integrator (counterpart of the path subset of
voxtracer/render/integrator.py).

The whole ray population advances one bounce at a time; each bounce runs
one nearest traversal (kernels/traverse.py), one material-row lookup
(kernels/lookup.py), one shadow traversal for next-event estimation and,
on bounces where a ray is inside glass or smoke, the exit march.  Every
material lobe is computed for all rays and selected with masks, as the
JAX package does.  Per-ray vectors travel as component tuples (x, y, z)
of [N] tensors; the public functions take and return [N, 3] or [H, W, 3].

Modes: "primary" (flat albedo at the first hit) and "path" (full
stochastic light transport, renderer.cpp:1076-1328).  Random streams are
the counter hash of core/rng.py under keys derived with ``fold_in``, so
both packages draw the same samples.
"""

from __future__ import annotations

import math

import torch

from voxtracer_torch.config import RenderConfig
from voxtracer_torch.core import mathx
from voxtracer_torch.core.rng import fold_in, hash_normal, hash_uniform
from voxtracer_torch.core.types import (EMISSIVE, GLASS, MAT_NONE, METAL_HIGH,
                                        METAL_LOW, SMOKE_LOW_DENSITY,
                                        SMOKE_PLAYER, Scene)
from voxtracer_torch.kernels.dda import EXIT_GLASS, EXIT_SMOKE
from voxtracer_torch.kernels.lookup import lookup_rows
from voxtracer_torch.kernels.primitives import (spheres_nearest,
                                                spheres_occluded,
                                                triangles_nearest,
                                                triangles_occluded)
from voxtracer_torch.kernels.traverse import exit_march, traverse
from voxtracer_torch.render.camera import primary_rays
from voxtracer_torch.render.sky import sample_sky

BIG = 1e34
F32 = torch.float32
TWO_PI = 6.283185307179586


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


def csphere_sample(u1, u2, u3):
    """RandomSphereSample (tmpl8math.h:2502-2511)."""
    theta = u1 * TWO_PI
    phi = u2 * math.pi
    sp = torch.sin(phi)
    return (u3 * sp * torch.cos(theta), u3 * sp * torch.sin(theta),
            u3 * torch.cos(phi))


def coctant_dir(g):
    """RandomDirection positive-octant quirk (tmpl8math.cpp:76-93)."""
    return cunit((g[0].abs() + 1e-12, g[1].abs() + 1e-12, g[2].abs() + 1e-12))


def chemisphere_dir(n, g):
    """DiffuseReflection (tmpl8math.h:2517-2527): uniform hemisphere."""
    d = cunit((g[0] + 1e-12, g[1] + 1e-12, g[2] + 1e-12))
    flip = torch.where(cdot(d, n) < 0.0, -1.0, 1.0)
    return cscale(flip, d)


# --------------------------------------------------------------------------
# Scene intersection
# --------------------------------------------------------------------------

def _vol_args(scene: Scene):
    v = scene.volumes
    return (v.grids.reshape(-1), v.gridsize, v.inv, v.fwd, v.cube_min)


def find_nearest_world(scene: Scene, o, d, active):
    """Renderer::FindNearest (renderer.cpp:946-1018): all volumes in one
    traversal, then spheres and triangles merged.  o, d: [N, 3] or
    component tuples.  Returns dict with t, mat, vol, hit, nx, ny, nz,
    prim_adopt and prim_inside."""
    o3 = cstack(o) if isinstance(o, tuple) else o
    d3 = cstack(d) if isinstance(d, tuple) else d
    n, dev = o3.shape[0], o3.device
    vols = scene.volumes
    res = traverse(*_vol_args(scene), o3, d3,
                   torch.full((n,), BIG, dtype=F32, device=dev), active,
                   torch.ones(vols.n, dtype=torch.bool, device=dev),
                   vols.occ, vols.bricksize, mode="nearest")
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
    o3 = cstack(o) if isinstance(o, tuple) else o
    d3 = cstack(d) if isinstance(d, tuple) else d
    vols = scene.volumes
    res = traverse(*_vol_args(scene), o3, d3, t_limit, active,
                   torch.ones(vols.n, dtype=torch.bool, device=o3.device),
                   vols.occ, vols.bricksize, mode="occluded")
    occ = res["hit"]
    occ = occ | spheres_occluded(scene.spheres, o3, d3, t_limit)
    return occ | triangles_occluded(scene.triangles, o3, d3, t_limit)


def material_exit_world(scene: Scene, o, d, vol_idx, mode_code, mask):
    """FindMaterialExit / FindSmokeExit through each ray's own volume
    (renderer.cpp:1160-1179, 1265-1280).  Returns (in_volume, t, normal
    components)."""
    vols = scene.volumes
    res = exit_march(*_vol_args(scene), o, d, mask, mode_code, vol_idx,
                     vols.occ, vols.bricksize)
    return res["in_vol"], res["t"], (res["nx"], res["ny"], res["nz"])


# --------------------------------------------------------------------------
# Next-event estimation (renderer.cpp:102-207, 738-764)
# --------------------------------------------------------------------------

def illumination(scene: Scene, p, nrm, active, key, alb):
    """Renderer::Illumination: one random light, scaled by the light count,
    with all light types sharing one shadow traversal.  Area lights use a
    one-sample estimate of the reference's N-sample mean (same
    expectation).  p, nrm, alb: component tuples.  Returns a tuple."""
    L = scene.lights
    n_p, n_a, n_s = L.n_point, L.n_area, L.n_spot
    total = L.count
    nrays, dev = p[0].shape[0], p[0].device
    zero = tuple(torch.zeros(nrays, dtype=F32, device=dev) for _ in range(3))

    u = hash_uniform(key, 7, (nrays,), dev)
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
        gk = hash_normal(key, 11, (3, nrays), dev)
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

def _bounce_core(scene: Scene, cfg: RenderConfig, st, bkey):
    """One wavefront bounce: nearest traversal, material-lobe shading, NEE
    and continuation.  Inactive rays pass through unchanged."""
    n, dev = st["o"][0].shape[0], st["o"][0].device
    one3 = tuple(torch.ones(n, dtype=F32, device=dev) for _ in range(3))
    o, d, active = st["o"], st["d"], st["active"]
    rec = find_nearest_world(scene, o, d, active)
    t, mat, vol = rec["t"], rec["mat"], rec["vol"]
    nrm = (rec["nx"], rec["ny"], rec["nz"])
    in_glass = torch.where(rec["prim_adopt"], rec["prim_inside"], st["in_glass"])

    # miss -> sky, terminate (renderer.cpp:1092-1095); the sky texture read
    # is deferred to one per frame (a ray misses at most once)
    miss = active & (mat == MAT_NONE)
    sky_tp = cwhere(miss, st["tp"], st["sky_tp"])
    sky_d = cwhere(miss, d, st["sky_d"])
    rad = st["rad"]
    active = active & ~miss

    # one [256, 6] row lookup for all material properties
    m = scene.materials
    mtab = torch.cat([m.albedo, m.roughness[:, None], m.emissive[:, None],
                      m.ior[:, None]], dim=1)
    mrow = lookup_rows(mtab, mat)
    alb = (mrow[:, 0], mrow[:, 1], mrow[:, 2])
    rough, emis, ior = mrow[:, 3], mrow[:, 4], mrow[:, 5]

    is_metal = (mat >= METAL_HIGH) & (mat <= METAL_LOW)
    is_nonmetal = mat < METAL_HIGH
    is_glass_m = mat == GLASS
    is_smoke = (mat >= SMOKE_LOW_DENSITY) & (mat <= SMOKE_PLAYER)
    is_emissive = mat == EMISSIVE
    is_model = (mat > EMISSIVE) & (mat != MAT_NONE)

    # emissive: terminal (renderer.cpp:1315-1316)
    rad = cwhere(active & is_emissive,
                 cadd(rad, cmul(st["tp"], cscale(emis, alb))), rad)

    # dielectric / smoke medium march, skipped on bounces where no ray is
    # inside a medium
    march = active & in_glass & (is_glass_m | is_smoke) & (vol >= 0)
    if bool(march.any()):
        mode_code = torch.where(is_glass_m, EXIT_GLASS, EXIT_SMOKE).to(torch.int32)
        in_vol, t_exit, nrm_exit = material_exit_world(
            scene, cstack(o), cstack(d), vol, mode_code, march)
    else:
        in_vol = torch.zeros(n, dtype=torch.bool, device=dev)
        t_exit = torch.zeros(n, dtype=F32, device=dev)
        nrm_exit = tuple(torch.zeros(n, dtype=F32, device=dev) for _ in range(3))
    t = torch.where(march, t_exit, t)
    nrm = cwhere(march & in_vol, nrm_exit, nrm)
    # fell off the grid: move the origin to the boundary, t = 0
    # (renderer.cpp:1175-1179)
    fell = march & ~in_vol
    o = cwhere(fell, cadd(o, cscale(t, d)), o)
    t = torch.where(fell, 0.0, t)
    p_hit = cadd(o, cscale(t, d))

    # NEE for diffuse-ish lobes
    u_lobe = hash_uniform(bkey, 1, (n,), dev)
    cos_in = torch.clamp(cdot(cneg(d), nrm), max=1.0)
    go_diffuse = u_lobe > mathx.schlick_nonmetal(cos_in)
    nee_mask = active & ((is_nonmetal & go_diffuse) | is_model)
    inc = illumination(scene, p_hit, nrm, nee_mask, fold_in(bkey, 2), alb)
    # nonmetal: rad += T * inc ; model: rad += T * alb * inc
    rad = cwhere(nee_mask & is_nonmetal, cadd(rad, cmul(st["tp"], inc)), rad)
    rad = cwhere(nee_mask & is_model, cadd(rad, cmul(st["tp"], cmul(alb, inc))), rad)

    # continuation directions per lobe
    u_sph = hash_uniform(bkey, 3, (3, n), dev)
    g_hemi = hash_normal(bkey, 4, (3, n), dev)
    refl = creflect(d, nrm)
    sph = csphere_sample(u_sph[0], u_sph[1], u_sph[2])
    spec_dir = cadd(refl, cscale(rough, sph))
    diff_dir = cadd(nrm, sph)  # RandomLambertianReflectionVector
    model_dir = chemisphere_dir(nrm, (g_hemi[0], g_hemi[1], g_hemi[2]))

    # glass: Fresnel reflect-or-refract (renderer.cpp:1181-1208)
    ratio = torch.where(in_glass, ior, 1.0 / ior)
    cos_g = torch.clamp(cdot(cneg(d), nrm), max=1.0)
    sin_g = mathx.sqrt(torch.clamp(1.0 - cos_g * cos_g, min=0.0))
    cannot_refract = ratio * sin_g > 1.0
    u_f = hash_uniform(bkey, 5, (n,), dev)
    do_reflect = cannot_refract | (mathx.schlick(cos_g, ratio) > u_f)
    refr_dir = crefract(d, nrm, ratio)
    glass_dir = cwhere(do_reflect, refl, refr_dir)
    glass_norm = cwhere(do_reflect, nrm, cneg(nrm))
    glass_flip = active & is_glass_m & ~do_reflect

    # smoke: stochastic in-scatter (renderer.cpp:1282-1289), then the
    # unconditional ratio-1 "refraction" pass-through
    intensity = torch.where(in_glass & is_smoke, emis, 0.0)
    dist = torch.where(march, t, 0.0)
    u_s = hash_uniform(bkey, 6, (2, n), dev)
    g_oct = hash_normal(bkey, 8, (3, n), dev)
    thresh = u_s[0] * 100.0 - intensity
    scatter = active & is_smoke & (u_s[1] * dist > thresh)
    scat_t = t * 0.45 + u_s[0] * (t - t * 0.45)  # Rand(t * .45, t)
    o = cwhere(scatter, cadd(o, cscale(scat_t, d)), o)
    d = cwhere(scatter, coctant_dir((g_oct[0], g_oct[1], g_oct[2])), d)
    t = torch.where(scatter, 0.0, t)
    p_hit = cadd(o, cscale(t, d))
    # absorption replaces the colour (renderer.cpp:1290, 1596-1608)
    smoke_trans = tuple(torch.exp(-dist * intensity * (1.0 - alb[i])) for i in range(3))

    # select the continuation
    new_d = cwhere(is_metal, spec_dir, d)
    new_d = cwhere(is_nonmetal & go_diffuse, diff_dir, new_d)
    new_d = cwhere(is_nonmetal & ~go_diffuse, spec_dir, new_d)
    new_d = cwhere(is_glass_m, glass_dir, new_d)
    new_d = cwhere(is_model, model_dir, new_d)
    new_d = cunit(new_d)

    off_n = cwhere(is_glass_m, glass_norm, nrm)
    off_n = cwhere(is_smoke, cneg(nrm), off_n)
    new_o = coffset(p_hit, off_n)

    # throughput
    tp = st["tp"]
    tp = cwhere(active & (is_metal | (is_nonmetal & go_diffuse) | is_model),
                cmul(tp, alb), tp)
    glass_color = cwhere(in_glass, alb, one3)
    tp = cwhere(active & is_glass_m, cmul(st["tp"], glass_color), tp)
    tp = cwhere(active & is_smoke, cmul(st["tp"], smoke_trans), tp)

    new_in_glass = torch.where(glass_flip | (active & is_smoke), ~in_glass, in_glass)
    new_active = active & ~is_emissive
    return dict(
        o=cwhere(new_active, new_o, o), d=cwhere(new_active, new_d, d),
        tp=tp, rad=rad, in_glass=new_in_glass, active=new_active,
        sky_tp=sky_tp, sky_d=sky_d,
    )


def _apply_deferred_sky(scene: Scene, cfg: RenderConfig, st):
    """rad += sky_tp * sky(sky_d): the one sky read per frame."""
    sky = cpack(sample_sky(scene.sky, cstack(st["sky_d"]), cfg.activate_sky,
                           cfg.sky_fallback))
    return cadd(st["rad"], cmul(st["sky_tp"], sky))


def trace_path(scene: Scene, cfg: RenderConfig, o, d, key):
    """Full stochastic light transport; o, d: [N, 3] -> radiance [N, 3].
    Up to max_bounces + 1 segments (renderer.cpp:1076-1083), stopping
    early once every ray has terminated."""
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
    for depth in range(cfg.max_bounces + 1):
        if not bool(state["active"].any()):
            break
        state = _bounce_core(scene, cfg, state, fold_in(key, depth))
    return cstack(_apply_deferred_sky(scene, cfg, state))


# --------------------------------------------------------------------------
# Top-level rendering
# --------------------------------------------------------------------------

def _sample_pixels(scene: Scene, cfg: RenderConfig, key, px, py):
    """One sample for the given pixel coordinates -> radiance [N, 3]."""
    n, dev = px.shape[0], px.device
    if cfg.mode == "path":
        u = hash_uniform(key, 100, (n, 2), dev)
        px = px + u[:, 0] * cfg.aa_strength
        py = py + u[:, 1] * cfg.aa_strength
    o, d = primary_rays(scene.camera, cfg.width, cfg.height, px, py)
    o = o.contiguous()
    if cfg.mode == "primary":
        rec = find_nearest_world(scene, o, d, torch.ones(n, dtype=torch.bool, device=dev))
        sky = sample_sky(scene.sky, d, cfg.activate_sky, cfg.sky_fallback)
        return torch.where(rec["hit"][:, None], scene.materials.albedo[rec["mat"].long()], sky)
    if cfg.mode == "path":
        return trace_path(scene, cfg, o, d, key)
    raise ValueError(f"mode {cfg.mode!r} is not ported yet")


def render_sample(scene: Scene, cfg: RenderConfig, key):
    """One sample per pixel, scanline order -> radiance [H*W, 3]."""
    dev = scene.device
    py, px = torch.meshgrid(torch.arange(cfg.height, dtype=F32, device=dev),
                            torch.arange(cfg.width, dtype=F32, device=dev),
                            indexing="ij")
    return _sample_pixels(scene, cfg, key, px.reshape(-1), py.reshape(-1))


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
