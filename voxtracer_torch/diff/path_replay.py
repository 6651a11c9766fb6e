"""Path-replay gradients through frozen paths (counterpart of
voxtracer/diff/path_replay.py): gradients of what the camera sees through
shadows, reflections, glass and smoke.

The discrete path geometry is replayed and carries no gradient: the
primary hit, the bounce directions (mirror for metals, Lambertian for
diffuse), the secondary hits, the light samples, the glass and smoke exit
marches.  Every throughput factor along that frozen path is
differentiable in the ``DiffParams``:

* albedo rows at the hits (``volumetric._rows``: the row-lookup kernel,
  its scatter-add kernel backward);
* relaxed shadow visibility exp(-integral of sigma) along each
  hit-to-light segment and relaxed transmittance along each bounce leg
  (``_segment_tau``: midpoint samples over all volumes, first inside wins,
  through ``volumetric._cell_fetch``, whose adjoint is a 1-D scatter into
  the flat density);
* a soft primary hit weight 1 - exp(-integral of sigma) over the whole
  primary span (silhouette gradients);
* in smoke, the absorption exponent with the marched distance relaxed to
  a soft occupied length (``_segment_soft_length``).

    L = hit0 ? W0 [alb0 E0 + alb0 V01 (hit1 ? alb1 (E1 + V12 L2) : sky(d1))]
               + (1 - W0) bg
             : bg

The hard traversals are the integrator's: ``find_nearest_world`` (the
nearest-hit kernel on the card) and ``material_exit_world`` (the exit
march kernel).  Random draws are the JAX package's ``jax.random`` streams
(``core/rng.threefry_*``) under the same ``fold_in`` salts, drawn at the
call's full ray count.

Object-space rays come from ``volumetric._object_rays``, rounded as XLA's
CPU dot rounds the JAX package's ``einsum``, so that midpoint samples on a
cell boundary fall in the same cell in both packages.
"""

from __future__ import annotations

import math

import torch

from voxtracer_torch.core import mathx
from voxtracer_torch.core.rng import fold_in, threefry_normal, threefry_uniform
from voxtracer_torch.core.types import (GLASS, METAL_HIGH, METAL_LOW,
                                        SMOKE_LOW_DENSITY, SMOKE_PLAYER, Scene)
from voxtracer_torch.diff.volumetric import (DiffParams, _cell_fetch, _clip_cell,
                                             _object_rays, _rows, softplus)
from voxtracer_torch.kernels.dda import EXIT_GLASS, EXIT_SMOKE
from voxtracer_torch.render import integrator
from voxtracer_torch.render.camera import primary_rays
from voxtracer_torch.render.sky import sample_sky

F32 = torch.float32
I32 = torch.int32
_EPS = 1e-3


def _far_bound(scene: Scene, o, d):
    """Per-ray largest exit t over all instance boxes (0 where none is
    crossed).  An axis-parallel ray divides by zero, as in the JAX
    package; the min and max propagate NaN as jnp's do."""
    vo, vd = _object_rays(scene, o, d)
    cb = scene.volumes.cube_min[:, None]  # [V, 1, 3]
    rd = 1.0 / vd
    a = (cb - vo) * rd
    b = (cb + 1.0 - vo) * rd
    zero = torch.zeros((), dtype=F32, device=o.device)
    t0 = torch.maximum(torch.minimum(a, b).amax(-1), zero)  # [V, N]
    t1 = torch.maximum(a, b).amin(-1)
    return torch.where(t1 > t0, t1, zero).amax(0)  # [N]


def _midpoint_cells(scene: Scene, vo, vd, t_mid, brick: bool = False):
    """The flat cell index of world t_mid along each object-space ray
    vo + t vd [V, N, 3], over all volumes (the first volume whose grid
    holds the point wins), or with `brick` the flat index of its 8^3
    brick (volume j's bricks from j M^3) -> (flat [N] i32, inside_any [N])."""
    vols = scene.volumes
    g = vols.pad_size
    m3 = vols.occ.shape[2]
    msp = round(m3 ** (1.0 / 3.0))
    gs_f = vols.gridsize.to(F32)
    cb = vols.cube_min
    n = t_mid.shape[0]
    flat = torch.zeros(n, dtype=I32, device=t_mid.device)
    inside_any = torch.zeros(n, dtype=torch.bool, device=t_mid.device)
    for j in range(vols.n):
        l = (vo[j] + t_mid[:, None] * vd[j] - cb[j]) * gs_f[j]
        if brick:
            ib = _clip_cell(l * 0.125, (vols.gridsize[j] + 7) // 8 - 1)
            f = j * m3 + (ib[:, 0] * msp + ib[:, 1]) * msp + ib[:, 2]
        else:
            idx = _clip_cell(l, vols.gridsize[j] - 1)
            f = (idx[:, 0] * g + idx[:, 1]) * g + idx[:, 2] + j * (g * g * g)
        inside = ((l >= 0.0) & (l < gs_f[j])).all(-1)
        flat = torch.where(inside & ~inside_any, f, flat)
        inside_any = inside_any | inside
    return flat, inside_any


def _seg_march(dens_flat, cell_tab, scene: Scene, o, d, t_lo, t_hi, steps: int, active,
               integrand):
    """The integral of integrand(sigma) over [t_lo, t_hi] of world rays
    o + t d at `steps` midpoints."""
    vo, vd = _object_rays(scene, o, d)
    dt = torch.where(active, torch.clamp_min(t_hi - t_lo, 0.0) / steps, 0.0)
    acc = torch.zeros(o.shape[0], dtype=F32, device=o.device)
    for ki in range(steps):
        t_mid = t_lo + (ki + 0.5) * dt
        flat, inside_any = _midpoint_cells(scene, vo, vd, t_mid)
        cells = _cell_fetch(dens_flat, cell_tab, flat)
        acc = acc + torch.where(inside_any, integrand(cells[:, 0]), 0.0) * dt
    return acc


def _segment_tau(dens_flat, cell_tab, scene: Scene, o, d, t_lo, t_hi, steps: int, active):
    """Optical depth, the integral of sigma over [t_lo, t_hi] of world rays
    o + t d, at `steps` midpoints over all volumes; density-differentiable
    through ``_cell_fetch``'s 1-D scatter adjoint."""
    return _seg_march(dens_flat, cell_tab, scene, o, d, t_lo, t_hi, steps, active,
                      lambda sig: sig)


def _segment_soft_length(dens_flat, cell_tab, scene: Scene, o, d, t_lo, t_hi, steps: int,
                         active, density_scale: float):
    """Relaxed occupied length of [t_lo, t_hi]: the integral of
    a = 1 - exp(-4 softplus(logit)), which tends to the hard in-medium
    distance of the reference's Absorption (renderer.cpp:1596-1608) as
    the logits saturate.  Marched as ``_segment_tau``."""
    delta = 4.0 / density_scale  # a = 1 - exp(-sigma delta), scale-free
    return _seg_march(dens_flat, cell_tab, scene, o, d, t_lo, t_hi, steps, active,
                      lambda sig: 1.0 - torch.exp(-sig * delta))


def _unit(v):
    """v / |v| over the last axis (``jnp.linalg.norm``)."""
    return v / mathx.sqrt(mathx.dot3(v, v))[:, None]


def _direct_soft(dens_flat, cell_tab, scene: Scene, cfg, p, nrm, active, key, seg_steps: int):
    """Direct light at p with relaxed shadow visibility: the sum over the
    point, spot and directional lights and one sample of each area light,
    each light's hard occlusion test replaced by exp(-integral of sigma)
    along its shadow segment (renderer.cpp:738-764, soft occlusion).
    Returns [N, 3] irradiance before the albedo."""
    L = scene.lights
    n, dev = p.shape[0], p.device
    acc = torch.zeros((n, 3), dtype=F32, device=dev)
    o_sh = mathx.offset_ray(p, nrm)
    eps = torch.full((n,), _EPS, dtype=F32, device=dev)

    def add(acc, dirn, dist, radiance, gate):
        tau = _segment_tau(dens_flat, cell_tab, scene, o_sh, dirn, eps, dist, seg_steps,
                           active & gate)
        vs = torch.where(gate, torch.exp(-tau), 0.0)
        return acc + vs[:, None] * radiance

    for i in range(L.n_point):
        to_l = L.point_pos[i] - p
        dst = mathx.sqrt(mathx.dot3(to_l, to_l))
        dirn = to_l / dst[:, None]
        cos_t = mathx.dot3(dirn, nrm)
        rad = (cos_t / (dst * dst))[:, None] * L.point_color[i]
        acc = add(acc, dirn, dst, rad, cos_t > 0.0)
    for i in range(L.n_spot):
        to_l = L.spot_pos[i] - p
        dst = mathx.sqrt(mathx.dot3(to_l, to_l))
        dirn = to_l / dst[:, None]
        cos_c = mathx.dot3(dirn, L.spot_dir[i])
        alpha = 1.0 - (1.0 - cos_c) / (1.0 - L.spot_cos_angle[i])
        rad = (cos_c / (dst * dst) * alpha)[:, None] * L.spot_color[i]
        acc = add(acc, dirn, dst, rad, cos_c > L.spot_cos_angle[i])
    for i in range(L.n_area):
        rnd = _unit(threefry_normal(fold_in(key, 11 + i), (n, 3), dev))
        target = L.area_pos[i] + L.area_radius[i] * rnd
        to_l = target - p
        dst = mathx.sqrt(mathx.dot3(to_l, to_l))
        dirn = to_l / dst[:, None]
        cos_t = mathx.dot3(dirn, nrm)
        r = L.area_radius[i]
        scale = cos_t * L.area_mult[i] * (r * r) * (4.0 * math.pi) / (dst * dst)
        acc = add(acc, dirn, dst, scale[:, None] * L.area_color[i], cos_t > 0.0)
    # the directional light always exists (types.Lights.count); a black one
    # (the reference default) is gated off everywhere, so its march, whose
    # samples all carry dt = 0 and whose result the gate drops, is skipped
    dirn = (-L.dir_direction).expand(n, 3)
    cos_d = mathx.dot3(dirn, nrm)
    rad = cos_d[:, None] * L.dir_color
    if bool((L.dir_color != 0.0).any()):
        far = _far_bound(scene, o_sh, dirn) + _EPS
        acc = add(acc, dirn, far, rad, cos_d > 0.0)
    else:
        acc = acc + torch.zeros((n, 1), dtype=F32, device=dev) * rad
    return acc


def _stack_normal(rec):
    return torch.stack([rec["nx"], rec["ny"], rec["nz"]], dim=-1)


def _traced_leg(params: DiffParams, dens_flat, cell_tab, scene: Scene, cfg, o_seg, d_seg,
                mask, key, seg_steps: int):
    """One replayed path leg from (o_seg, d_seg): the frozen hard nearest
    hit, the differentiable relaxed transmittance of the segment, and the
    struck surface's albedo times its soft direct light (sky on a miss).

    Returns (leg radiance [N, 3] = V_seg L_surface, the leg's frozen hit
    record and factors)."""
    n, dev = o_seg.shape[0], o_seg.device
    rec = integrator.find_nearest_world(scene, o_seg.contiguous(), d_seg.contiguous(), mask)
    hit, t, m, nn = rec["hit"], rec["t"], rec["mat"], _stack_normal(rec)
    p = o_seg + t[:, None] * d_seg
    far = _far_bound(scene, o_seg, d_seg)
    seg_hi = torch.where(hit, torch.clamp_min(t - _EPS, 0.0), far)
    tau = _segment_tau(dens_flat, cell_tab, scene, o_seg, d_seg,
                       torch.full((n,), _EPS, dtype=F32, device=dev), seg_hi, seg_steps, mask)
    v = torch.exp(-tau)
    alb = _rows(params.albedo_table, torch.clamp(m, 0, 255))
    e = _direct_soft(dens_flat, cell_tab, scene, cfg, p, nn, mask & hit, key, seg_steps)
    sky = sample_sky(scene.sky, d_seg, cfg.activate_sky, cfg.sky_fallback)
    l = torch.where(hit[:, None], alb * e, sky)
    return v[:, None] * l, dict(hit=hit, t=t, m=m, n=nn, p=p, alb=alb, e=e, v=v, sky=sky)


def _bounce_dir(d, nrm, is_metal, gauss):
    """The frozen bounce direction: the mirror direction for metals,
    normal + a unit sphere sample for diffuse, normalised."""
    d1 = torch.where(is_metal[:, None], mathx.reflect(d, nrm), nrm + _unit(gauss))
    return _unit(d1)


def render_diff_replay(params: DiffParams, scene: Scene, cfg, key, n_steps: int = 48,
                       seg_steps: int = 24, density_scale: float = 64.0, row0=None,
                       rows: int = 0):
    """The path-replay render -> [H, W, 3] (module docstring), or
    [rows, W, 3] for the band of `rows` scanlines from row0."""
    dev = scene.device
    x = torch.arange(cfg.width, dtype=F32, device=dev)
    y = torch.arange(rows or cfg.height, dtype=F32, device=dev)
    if rows:
        y = y + float(row0)
    py, px = torch.meshgrid(y, x, indexing="ij")
    o, d = primary_rays(scene.camera, cfg.width, cfg.height, px.reshape(-1), py.reshape(-1))
    o = o.contiguous()
    n = o.shape[0]

    dens_flat = softplus(params.density_logits).reshape(-1) * density_scale
    cell_tab = torch.stack([dens_flat.detach(), scene.volumes.grids.reshape(-1).to(F32)], dim=1)
    alb_tab = params.albedo_table

    # the replayed primary hit (hard traversal, frozen geometry)
    rec0 = integrator.find_nearest_world(scene, o, d, torch.ones(n, dtype=torch.bool, device=dev))
    hit0, t0, m0, n0 = rec0["hit"], rec0["t"], rec0["mat"], _stack_normal(rec0)
    p0 = o + t0[:, None] * d

    # the soft primary hit weight over the full span (silhouette gradients)
    far0 = _far_bound(scene, o, d)
    tau0 = _segment_tau(dens_flat, cell_tab, scene, o, d, torch.zeros(n, dtype=F32, device=dev),
                        far0, n_steps, far0 > 0.0)
    w0 = 1.0 - torch.exp(-tau0)

    # direct light at the primary hit, relaxed shadows
    alb0 = _rows(alb_tab, torch.clamp(m0, 0, 255))
    e0 = _direct_soft(dens_flat, cell_tab, scene, cfg, p0, n0, hit0, fold_in(key, 1), seg_steps)
    direct0 = alb0 * e0

    # the replayed dielectric and smoke chains of glass and smoke primaries
    is_glass0 = hit0 & (m0 == GLASS)
    vol0 = rec0["vol"]
    glass_rad = _glass_chain(params, dens_flat, cell_tab, scene, cfg, o, d, p0, n0, m0, vol0,
                             is_glass0, key, seg_steps)
    is_smoke0 = hit0 & (m0 >= SMOKE_LOW_DENSITY) & (m0 <= SMOKE_PLAYER)
    smoke_rad = _smoke_chain(params, dens_flat, cell_tab, scene, cfg, o, d, p0, n0, m0, vol0,
                             is_smoke0, key, seg_steps, density_scale)

    # two replayed bounces: mirror for metals, Lambertian for diffuse
    is_metal = (m0 >= METAL_HIGH) & (m0 <= METAL_LOW)
    is_diffuse = hit0 & (m0 < METAL_HIGH)
    bounce = hit0 & (is_metal | is_diffuse) & (m0 != GLASS)
    d1 = _bounce_dir(d, n0, is_metal, threefry_normal(fold_in(key, 2), (n, 3), dev))
    o1 = mathx.offset_ray(p0, n0)
    _, leg1 = _traced_leg(params, dens_flat, cell_tab, scene, cfg, o1, d1, bounce,
                          fold_in(key, 3), seg_steps)

    # the second bounce from the first bounce's surface (diffuse/metal only)
    m1, n1, p1, hit1 = leg1["m"], leg1["n"], leg1["p"], leg1["hit"]
    is_metal1 = (m1 >= METAL_HIGH) & (m1 <= METAL_LOW)
    bounce2 = bounce & hit1 & (is_metal1 | (m1 < METAL_HIGH))
    d2 = _bounce_dir(d1, n1, is_metal1, threefry_normal(fold_in(key, 4), (n, 3), dev))
    o2 = mathx.offset_ray(p1, n1)
    rad2, _ = _traced_leg(params, dens_flat, cell_tab, scene, cfg, o2, d2, bounce2,
                          fold_in(key, 6), seg_steps)

    # throughput: the diffuse cosine importance cancels cos/pi -> alb; a
    # mirror multiplies alb.  L1 = V01 [hit1 ? alb1 (E1 + L2) : sky(d1)]
    l1 = torch.where(hit1[:, None],
                     leg1["alb"] * (leg1["e"] + torch.where(bounce2[:, None], rad2, 0.0)),
                     leg1["sky"])
    bounce_rad = torch.where(bounce[:, None], alb0 * leg1["v"][:, None] * l1, 0.0)

    bg = sample_sky(scene.sky, d, cfg.activate_sky, cfg.sky_fallback)
    # glass and smoke primaries shade through their chains (the reference's
    # media take no NEE at the surface, renderer.cpp:1146-1314)
    lsurf = torch.where(is_glass0[:, None], glass_rad, direct0 + bounce_rad)
    lsurf = torch.where(is_smoke0[:, None], smoke_rad, lsurf)
    img = torch.where(hit0[:, None], w0[:, None] * lsurf + (1.0 - w0)[:, None] * bg, bg)
    return img.reshape(rows or cfg.height, cfg.width, 3)


def _exit_march(scene: Scene, o, d, vol, mode_code, mask):
    """``material_exit_world`` with the rays' frozen results -> (in_vol, t,
    normal [N, 3])."""
    in_vol, t, nrm = integrator.material_exit_world(scene, o.contiguous(), d.contiguous(),
                                                    vol.contiguous(), mode_code, mask)
    return in_vol, t, torch.stack(nrm, dim=-1)


def _glass_chain(params: DiffParams, dens_flat, cell_tab, scene: Scene, cfg, o, d, p0, n0, m0,
                 vol0, mask, key, seg_steps: int):
    """The replayed refraction chain through a dielectric
    (renderer.cpp:1146-1209).  A deterministic Fresnel split at the entry,
    both legs traced:

    * R: the reflected leg, a full ``_traced_leg``;
    * 1 - R: enter, the frozen exit march to the glass exit, the exit
      refraction; a lane with total internal reflection at the exit
      reflects off the inner face and marches to a second exit (one round;
      a second one ends the leg), then the relaxed transmittance to the
      next surface and its albedo times relaxed direct light.

    Differentiable: the glass albedo row, both legs' segment densities,
    the struck surfaces' albedo rows and shadow densities."""
    n, dev = o.shape[0], o.device
    alb_tab = params.albedo_table
    mi = torch.clamp(m0, 0, 255).long()
    ior0 = scene.materials.ior[mi]
    cos0 = torch.minimum(mathx.dot3(-d, n0), torch.ones((), dtype=F32, device=dev))
    ratio_in = 1.0 / ior0
    r_fres = mathx.schlick(cos0, ratio_in)
    d_in = mathx.refract(d, n0, ratio_in)
    o_in = mathx.offset_ray(p0, -n0)

    # the frozen march to the glass exit in the ray's own volume
    mode_code = torch.full((n,), EXIT_GLASS, dtype=I32, device=dev)
    vol = torch.clamp_min(vol0, 0)
    in_vol, t_exit, nrm_exit = _exit_march(scene, o_in, d_in, vol, mode_code, mask)
    # off the grid (a boundary-faced slab): the entry normal refracts the
    # exit, as the reference does (renderer.cpp:1175-1186)
    n_exit = torch.where(in_vol[:, None], nrm_exit, n0)
    p_exit = o_in + t_exit[:, None] * d_in

    # the exit refraction, in-glass ratio = ior
    one = torch.ones((), dtype=F32, device=dev)
    cos_e = torch.minimum(mathx.dot3(-d_in, n_exit), one)
    sin_e = mathx.sqrt(torch.clamp_min(1.0 - cos_e * cos_e, 0.0))
    tir = ior0 * sin_e > 1.0
    d_ref = mathx.refract(d_in, n_exit, ior0)

    # total internal reflection at the exit: reflect off the inner face and
    # march to a second exit (the JAX package's lax.cond, as a host test:
    # without such a lane the second march is all zeros)
    d_tir = mathx.reflect(d_in, n_exit)
    o_tir = mathx.offset_ray(p_exit, n_exit)  # back into the medium
    any_tir = mask & tir
    if bool(any_tir.any()):
        in_vol2, t_exit2, nrm_exit2 = _exit_march(scene, o_tir, d_tir, vol, mode_code, any_tir)
    else:
        in_vol2 = torch.zeros(n, dtype=torch.bool, device=dev)
        t_exit2 = torch.zeros(n, dtype=F32, device=dev)
        nrm_exit2 = torch.zeros((n, 3), dtype=F32, device=dev)
    n_exit2 = torch.where(in_vol2[:, None], nrm_exit2, n_exit)
    p_exit2 = o_tir + t_exit2[:, None] * d_tir
    cos_e2 = torch.minimum(mathx.dot3(-d_tir, n_exit2), one)
    sin_e2 = mathx.sqrt(torch.clamp_min(1.0 - cos_e2 * cos_e2, 0.0))
    tir2 = ior0 * sin_e2 > 1.0
    d_out2 = mathx.refract(d_tir, n_exit2, ior0)

    # the refraction branch leaves from the second exit on TIR lanes
    d_out = torch.where(tir[:, None], d_out2, d_ref)
    p_out = torch.where(tir[:, None], p_exit2, p_exit)
    nrm_out = torch.where(tir[:, None], n_exit2, n_exit)
    o_out = mathx.offset_ray(p_out, -nrm_out)
    chain = mask & ~(tir & tir2)  # a second TIR ends the leg

    # the frozen post-glass hit and its differentiable throughput
    rad2, _ = _traced_leg(params, dens_flat, cell_tab, scene, cfg, o_out, d_out, chain,
                          fold_in(key, 5), seg_steps)
    alb_g = _rows(alb_tab, torch.clamp(m0, 0, 255))  # the per-exit colour multiply
    chain_rad = torch.where(chain[:, None], alb_g * rad2, 0.0)

    # the reflected leg, traced
    refl0 = mathx.reflect(d, n0)
    o_r = mathx.offset_ray(p0, n0)
    rad_r, _ = _traced_leg(params, dens_flat, cell_tab, scene, cfg, o_r, refl0, mask,
                           fold_in(key, 7), seg_steps)
    return r_fres[:, None] * rad_r + (1.0 - r_fres)[:, None] * chain_rad


def _smoke_chain(params: DiffParams, dens_flat, cell_tab, scene: Scene, cfg, o, d, p0, n0, m0,
                 vol0, mask, key, seg_steps: int, density_scale: float):
    """The replayed heterogeneous-media chain (renderer.cpp:1210-1314):
    enter the medium, the frozen exit march (FindSmokeExit), a frozen
    in-scatter decision, point and direction drawn from `key` (the hard
    tracer's distributions), and Absorption (renderer.cpp:1596-1608)
    replacing the throughput by exp(-dist intensity (1 - albedo)).

    Differentiable: the absorption exponent with the hard `dist` relaxed
    to ``_segment_soft_length``, the smoke albedo row, the post-medium
    segment's relaxed transmittance, and what it hits (albedo and relaxed
    direct light) or the sky."""
    n, dev = o.shape[0], o.device
    alb_tab = params.albedo_table
    alb_s = _rows(alb_tab, torch.clamp(m0, 0, 255))  # the smoke albedo row
    emis0 = scene.materials.emissive[torch.clamp(m0, 0, 255).long()]
    o_in = mathx.offset_ray(p0, -n0)

    # the frozen march to the smoke exit (the direction passes unchanged,
    # renderer.cpp:1282-1313)
    mode_code = torch.full((n,), EXIT_SMOKE, dtype=I32, device=dev)
    in_vol, t_exit, nrm_exit = _exit_march(scene, o_in, d, torch.clamp_min(vol0, 0), mode_code,
                                           mask)

    # the frozen in-scatter (renderer.cpp:1282-1289): threshold u0 100 -
    # intensity; scatter iff u1 dist > threshold; at Rand(0.45 t, t),
    # into a positive-octant direction
    u = threefry_uniform(fold_in(key, 21), (2, n), dev)
    gk = threefry_normal(fold_in(key, 22), (n, 3), dev)
    intensity = emis0
    scatter = mask & (u[1] * t_exit > u[0] * 100.0 - intensity)
    scat_t = t_exit * 0.45 + u[0] * (t_exit - t_exit * 0.45)
    d_oct = _unit(gk.abs() + 1e-12)
    p_out = o_in + torch.where(scatter, scat_t, t_exit)[:, None] * d
    d_out = torch.where(scatter[:, None], d_oct, d)

    # the differentiable absorption over the in-medium segment: the hard
    # dist (t_exit, applied whether or not the ray scatters) relaxed to the
    # soft occupied length
    soft_dist = _segment_soft_length(dens_flat, cell_tab, scene, o_in, d,
                                     torch.zeros(n, dtype=F32, device=dev), t_exit, seg_steps,
                                     mask, density_scale)
    absorb = torch.exp(-soft_dist[:, None] * intensity[:, None] * (1.0 - alb_s))

    # the frozen post-medium hit and the differentiable throughput to it
    off_n = torch.where(scatter[:, None], d_out,
                        -torch.where(in_vol[:, None], nrm_exit, n0))
    o2 = mathx.offset_ray(p_out, off_n)
    rec2 = integrator.find_nearest_world(scene, o2.contiguous(), d_out.contiguous(), mask)
    hit2, t2, m2, n2 = rec2["hit"], rec2["t"], rec2["mat"], _stack_normal(rec2)
    p2 = o2 + t2[:, None] * d_out
    far2 = _far_bound(scene, o2, d_out)
    seg_hi = torch.where(hit2, torch.clamp_min(t2 - _EPS, 0.0), far2)
    tau2 = _segment_tau(dens_flat, cell_tab, scene, o2, d_out,
                        torch.full((n,), _EPS, dtype=F32, device=dev), seg_hi, seg_steps, mask)
    v2 = torch.exp(-tau2)

    alb2 = _rows(alb_tab, torch.clamp(m2, 0, 255))
    e2 = _direct_soft(dens_flat, cell_tab, scene, cfg, p2, n2, mask & hit2, fold_in(key, 23),
                      seg_steps)
    sky2 = sample_sky(scene.sky, d_out, cfg.activate_sky, cfg.sky_fallback)
    l2 = torch.where(hit2[:, None], alb2 * e2, sky2)
    return absorb * v2[:, None] * l2


def mse_loss_replay(params: DiffParams, scene: Scene, cfg, target, key, n_steps: int = 48,
                    seg_steps: int = 24, density_scale: float = 64.0, row0=None,
                    rows: int = 0):
    img = render_diff_replay(params, scene, cfg, key, n_steps, seg_steps, density_scale,
                             row0=row0, rows=rows)
    return ((img - target) ** 2).mean()
