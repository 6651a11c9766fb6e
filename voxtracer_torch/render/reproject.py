"""Static-camera temporal reprojection (counterpart of
voxtracer/render/reproject.py; renderer.cpp:1997-2101).

Two passes:
* ``trace_reproject``, the decomposed integrator: per pixel the albedo of
  the first hit and the illumination behind it (colour = albedo x
  illumination), and the first-hit G-buffer (point, normal, t, material).
  As in the reference's reproject estimator, non-metals always take the
  diffuse branch and the albedo multiplies the whole sub-path
  (TraceNonMetal, renderer.cpp:1342-1357).
* ``resolve``: reproject each first hit into the previous camera
  (PointToUV, camera.h:34-49), check it with an occlusion ray from that
  camera (renderer.cpp:767-774), sample the history bilinearly
  (renderer.cpp:777-830), clamp it in YCoCg to mean +- 0.75 sigma of the
  3x3 neighbourhood (renderer.cpp:856-910) and blend with per-material
  weights (renderer.cpp:2050-2084).

The random draws of pass 1 are ``jax.random`` threefry streams
(core/rng.threefry_*), as in the JAX package; its NEE goes through
``integrator.illumination`` and its hash streams.  Every traversal and
material-row lookup goes through ``integrator``'s bindings (K1, K2, K3
and K4 on a CUDA scene), so swapping those swaps them here too.
"""

from __future__ import annotations

import torch

from voxtracer_torch.config import RenderConfig
from voxtracer_torch.core import mathx
from voxtracer_torch.core.rng import fold_in, threefry_normal, threefry_uniform
from voxtracer_torch.core.sampling import (lambertian_dir, positive_octant_dir,
                                           sphere_sample, uniform_hemisphere_dir)
from voxtracer_torch.core.types import (EMISSIVE, GLASS, MAT_NONE, METAL_HIGH,
                                        METAL_LOW, SMOKE_LOW_DENSITY,
                                        SMOKE_PLAYER, Camera, Scene)
from voxtracer_torch.kernels.dda import EXIT_GLASS, EXIT_SMOKE
from voxtracer_torch.render import integrator
from voxtracer_torch.render.camera import primary_rays
from voxtracer_torch.render.sky import sample_sky
from voxtracer_torch.render.tonemap import tonemap
from voxtracer_torch.utils.profiling import span

F32 = torch.float32


# ---------------------------------------------------------------------------
# Frustum-plane reprojection (camera.h:28-66)
# ---------------------------------------------------------------------------

def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def frustum_normals(cam: Camera, aspect: float):
    """SetFrustumNormals (camera.h:53-66): left, right, top and bottom
    plane normals, left-handed."""
    left_dir = 2.0 * cam.ahead - aspect * cam.right
    right_dir = 2.0 * cam.ahead + aspect * cam.right
    top_dir = 2.0 * cam.ahead + cam.up
    bottom_dir = 2.0 * cam.ahead - cam.up
    return (_cross(cam.up, left_dir), _cross(right_dir, cam.up),
            _cross(cam.right, top_dir), _cross(bottom_dir, cam.right))


def point_to_uv(cam: Camera, aspect: float, points):
    """PointToUV (camera.h:34-49): [N, 3] points -> [N, 2] uv as ratios of
    the distances to opposite frustum planes."""
    ln, rn, tn, bn = frustum_normals(cam, aspect)
    delta = points - cam.pos
    ld, rd = mathx.dot3(delta, ln), mathx.dot3(delta, rn)
    td, bd = mathx.dot3(delta, tn), mathx.dot3(delta, bn)
    return torch.stack([ld / (ld + rd), td / (td + bd)], dim=-1)


# ---------------------------------------------------------------------------
# Pass 1: the decomposed wavefront integrator
# ---------------------------------------------------------------------------

def trace_reproject(scene: Scene, cfg: RenderConfig, o, d, key):
    """o, d: [N, 3] primary rays -> (albedo0 [N, 3], illumination [N, 3],
    point [N, 3], normal [N, 3], t [N], material [N] i32).  Up to
    max_bounces + 1 segments, stopping once every ray has terminated."""
    n, dev = o.shape[0], o.device
    d_prim = d
    ones3 = torch.ones((n, 3), dtype=F32, device=dev)
    tp = ones3
    radiance = torch.zeros((n, 3), dtype=F32, device=dev)
    in_glass = torch.zeros(n, dtype=torch.bool, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    albedo0, p0, n0 = ones3, torch.zeros_like(radiance), torch.zeros_like(radiance)
    t0 = torch.zeros(n, dtype=F32, device=dev)
    m0 = torch.full((n,), MAT_NONE, dtype=torch.int32, device=dev)
    sky_tp, sky_d = torch.zeros_like(radiance), d
    m = scene.materials
    mtab = torch.cat([m.albedo, m.roughness[:, None], m.emissive[:, None],
                      m.ior[:, None]], dim=1)

    for depth in range(cfg.max_bounces + 1):
        if not bool(active.any()):
            break
        with span("vt.bounce"):
            bkey = fold_in(key, depth)
            first = depth == 0
            rec = integrator.find_nearest_world(scene, o, d, active)
            t, mat, vol = rec["t"], rec["mat"], rec["vol"]
            nrm = torch.stack([rec["nx"], rec["ny"], rec["nz"]], dim=-1)
            in_glass = torch.where(rec["prim_adopt"], rec["prim_inside"], in_glass)

            # one [256, 6] row lookup for every material property
            mrow = integrator.lookup_rows(mtab, mat)
            alb = mrow[:, 0:3]
            rough, emis, ior = mrow[:, 3], mrow[:, 4], mrow[:, 5]

            is_metal = (mat >= METAL_HIGH) & (mat <= METAL_LOW)
            is_nonmetal = mat < METAL_HIGH
            is_glass_m = mat == GLASS
            is_smoke = (mat >= SMOKE_LOW_DENSITY) & (mat <= SMOKE_PLAYER)
            is_emissive = mat == EMISSIVE
            is_model = (mat > EMISSIVE) & (mat != MAT_NONE)
            miss = active & (mat == MAT_NONE)

            # medium march, skipped on bounces where no ray is inside a medium
            march = active & in_glass & (is_glass_m | is_smoke) & (vol >= 0)
            if bool(march.any()):
                mode_code = torch.where(is_glass_m, EXIT_GLASS, EXIT_SMOKE).to(torch.int32)
                in_vol, t_exit, nrm_exit = integrator.material_exit_world(
                    scene, o, d, vol, mode_code, march)
                t = torch.where(march, t_exit, t)
                nrm = torch.where((march & in_vol)[:, None], torch.stack(nrm_exit, dim=-1), nrm)
                fell = march & ~in_vol
                o = torch.where(fell[:, None], o + t[:, None] * d, o)
                t = torch.where(fell, 0.0, t)
            p_hit = o + t[:, None] * d

            # smoke scatter and absorption (TraceSmoke, renderer.cpp:1472-1481)
            intensity = torch.where(in_glass & is_smoke, emis, 0.0)
            dist = torch.where(march, t, 0.0)
            u_s = threefry_uniform(fold_in(bkey, 6), (n, 2), dev)
            g_oct = threefry_normal(fold_in(bkey, 8), (n, 3), dev)
            scatter = active & is_smoke & (u_s[:, 1] * dist > u_s[:, 0] * 100.0 - intensity)
            scat_t = t * 0.45 + u_s[:, 0] * (t - t * 0.45)
            o = torch.where(scatter[:, None], o + d * scat_t[:, None], o)
            d = torch.where(scatter[:, None], positive_octant_dir(g_oct), d)
            t = torch.where(scatter, 0.0, t)
            p_hit = o + t[:, None] * d
            smoke_trans = mathx.absorption(alb, intensity, dist)

            # the lobe's albedo factor; misses read the sky once per frame,
            # after the loop
            lobe = torch.where(is_glass_m[:, None],
                               torch.where(in_glass[:, None], alb, 1.0), alb)
            lobe = torch.where(is_smoke[:, None], smoke_trans, lobe)
            lobe = torch.where(is_emissive[:, None], alb * emis[:, None], lobe)

            # first hit: the G-buffer, and the albedo taken out of the path
            if first:
                albedo0 = torch.where(active[:, None], lobe, albedo0)
                p0 = torch.where(active[:, None], p_hit, p0)
                n0 = torch.where(active[:, None], nrm, n0)
                t0 = torch.where(active, t, t0)
                m0 = torch.where(active, mat, m0)

            # terminal lobes: illumination 1 at the first level, T x lobe deeper;
            # deep misses add T x sky after the loop
            term = active & (is_emissive | miss)
            radiance = radiance + torch.where(
                term[:, None], ones3 if first else torch.where(miss[:, None], 0.0, tp * lobe),
                0.0)
            if not first:
                sky_tp = torch.where(miss[:, None], tp, sky_tp)
            sky_d = torch.where(miss[:, None], d, sky_d)
            active = active & ~term

            # NEE for the diffuse lobes (no specular split in reproject mode)
            nee_mask = active & (is_nonmetal | is_model)
            inc = integrator.cstack(integrator.illumination(
                scene, cfg, integrator.cpack(p_hit), integrator.cpack(nrm), nee_mask,
                fold_in(bkey, 2), integrator.cpack(alb)))
            eff_alb = ones3 if first else lobe
            radiance = radiance + torch.where(nee_mask[:, None], tp * eff_alb * inc, 0.0)

            # continuation directions
            u_sph = threefry_uniform(fold_in(bkey, 3), (n, 3), dev)
            g_hemi = threefry_normal(fold_in(bkey, 4), (n, 3), dev)
            refl = mathx.reflect(d, nrm)
            spec_dir = refl + rough[:, None] * sphere_sample(u_sph)
            diff_dir = lambertian_dir(nrm, u_sph)
            model_dir = uniform_hemisphere_dir(nrm, g_hemi)

            ratio = torch.where(in_glass, ior, 1.0 / ior)
            cos_g = torch.clamp(mathx.dot3(-d, nrm), max=1.0)
            sin_g = mathx.sqrt(torch.clamp(1.0 - cos_g * cos_g, min=0.0))
            cannot_refract = ratio * sin_g > 1.0
            u_f = threefry_uniform(fold_in(bkey, 5), (n,), dev)
            do_reflect = cannot_refract | (mathx.schlick(cos_g, ratio) > u_f)
            glass_dir = torch.where(do_reflect[:, None], refl, mathx.refract(d, nrm, ratio))
            glass_norm = torch.where(do_reflect[:, None], nrm, -nrm)
            glass_flip = active & is_glass_m & ~do_reflect

            new_d = torch.where(is_metal[:, None], spec_dir, d)
            new_d = torch.where(is_nonmetal[:, None], diff_dir, new_d)
            new_d = torch.where(is_glass_m[:, None], glass_dir, new_d)
            new_d = integrator._unit(torch.where(is_model[:, None], model_dir, new_d))
            off_n = torch.where(is_glass_m[:, None], glass_norm, nrm)
            off_n = torch.where(is_smoke[:, None], -nrm, off_n)
            new_o = mathx.offset_ray(p_hit, off_n)

            tp = torch.where(active[:, None], tp * eff_alb, tp)
            in_glass = torch.where(glass_flip | (active & is_smoke), ~in_glass, in_glass)
            o = torch.where(active[:, None], new_o, o)
            d = torch.where(active[:, None], new_d, d)

    # the one sky read: deep-miss radiance, and the albedo of first misses
    radiance = radiance + sky_tp * sample_sky(scene.sky, sky_d, cfg.activate_sky,
                                              cfg.sky_fallback)
    albedo0 = torch.where((m0 == MAT_NONE)[:, None],
                          sample_sky(scene.sky, d_prim, cfg.activate_sky, cfg.sky_fallback),
                          albedo0)
    return albedo0, radiance, p0, n0, t0, m0


# ---------------------------------------------------------------------------
# Pass 2: the history resolve
# ---------------------------------------------------------------------------

def _material_blend_weight(mat):
    """renderer.cpp:2050-2084: the history's weight per material class."""
    w = torch.full(mat.shape, 0.9, dtype=F32, device=mat.device)
    w = torch.where(mat < METAL_HIGH, 0.8, w)
    w = torch.where((mat >= METAL_HIGH) & (mat <= GLASS), 0.5, w)
    w = torch.where((mat >= SMOKE_LOW_DENSITY) & (mat <= SMOKE_PLAYER), 0.9, w)
    return torch.where(mat == EMISSIVE, 0.0, w)


def _sample_history(history, uv, width, height):
    """SampleHistory (renderer.cpp:777-830): bilinear with each tap weighted
    by whether it lies on the image.  history [H, W, 3], uv [N, 2]."""
    px = (uv[:, 0] - 0.5 / width) * width
    py = (uv[:, 1] - 0.5 / height) * height
    x0, y0 = px.to(torch.int32), py.to(torch.int32)
    fx, fy = px - x0, py - y0
    flat = history.reshape(-1, 3)

    def tap(xi, yi, wgt):
        valid = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
        idx = torch.clamp(yi, 0, height - 1) * width + torch.clamp(xi, 0, width - 1)
        w = torch.where(valid, wgt, 0.0)
        return flat[idx.long()] * w[:, None], w

    c1, w1 = tap(x0, y0, (1 - fx) * (1 - fy))
    c2, w2 = tap(x0 + 1, y0, fx * (1 - fy))
    c3, w3 = tap(x0, y0 + 1, (1 - fx) * fy)
    c4, w4 = tap(x0 + 1, y0 + 1, fx * fy)
    tot = w1 + w2 + w3 + w4
    return (c1 + c2 + c3 + c4) / torch.clamp(tot, min=1e-8)[:, None]


def _clamp_history(history, new_img):
    """ClampHistory (renderer.cpp:856-910): the history clamped in YCoCg to
    mean +- 0.75 sigma of the current image's 3x3 neighbourhood (the part
    of it on the image).  history, new_img: [H, W, 3]."""
    ycc_new = mathx.rgb_to_ycocg(new_img)
    ycc_hist = mathx.rgb_to_ycocg(history)
    h, w = new_img.shape[:2]
    dev = new_img.device
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    acc, acc2 = ycc_new, ycc_new * ycc_new
    count = torch.ones((h, w, 1), dtype=F32, device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            shifted = torch.roll(ycc_new, (-dy, -dx), dims=(0, 1))
            valid = torch.ones((h, w), dtype=torch.bool, device=dev)
            if dy == -1:
                valid = valid & (rows > 0)
            if dy == 1:
                valid = valid & (rows < h - 1)
            if dx == -1:
                valid = valid & (cols > 0)
            if dx == 1:
                valid = valid & (cols < w - 1)
            vm = valid[..., None]
            acc = acc + torch.where(vm, shifted, 0.0)
            acc2 = acc2 + torch.where(vm, shifted * shifted, 0.0)
            count = count + vm
    mean = acc / count
    var = acc2 / count - mean * mean
    sigma = mathx.sqrt(torch.clamp(var, min=0.0))
    clamped = torch.clamp(ycc_hist, mean - 0.75 * sigma, mean + 0.75 * sigma)
    return torch.clamp(mathx.ycocg_to_rgb(clamped), min=0.0)


def resolve(scene: Scene, cfg: RenderConfig, prev_camera: Camera, albedo, illum,
            p0, m0, hit_mask, history):
    """Pass 2 -> (tonemapped image [H, W, 3], new illumination history
    [H, W, 3]).  albedo, illum, p0: [H*W, 3]; m0, hit_mask: [H*W]."""
    h, w = cfg.height, cfg.width
    dev = p0.device
    uv = point_to_uv(prev_camera, w / h, p0) + torch.tensor([0.5 / w, 0.5 / h],
                                                             dtype=F32, device=dev)
    uv_ok = (uv[:, 0] >= 0) & (uv[:, 0] < 1) & (uv[:, 1] >= 0) & (uv[:, 1] < 1)

    # IsOccludedPrevFrame (renderer.cpp:767-774)
    to_p = p0 - prev_camera.pos
    dist = mathx.sqrt(mathx.dot3(to_p, to_p))
    dirn = to_p / torch.clamp(dist, min=1e-8)[:, None]
    back = mathx.offset_ray(p0, -dirn) - prev_camera.pos
    t_occ = mathx.sqrt(mathx.dot3(back, back))
    occluded = integrator.is_occluded_world(scene, prev_camera.pos.expand(p0.shape), dirn,
                                            t_occ, uv_ok & hit_mask)

    valid = uv_ok & ~occluded & hit_mask
    new_img = illum.reshape(h, w, 3)
    clamped = _clamp_history(_sample_history(history, uv, w, h).reshape(h, w, 3), new_img)
    wgt = _material_blend_weight(m0).reshape(h, w, 1)
    final = torch.where(valid.reshape(h, w, 1),
                        new_img * (1 - wgt) + clamped * wgt, new_img)
    return tonemap(albedo.reshape(h, w, 3) * final), final


def _untile(a, h, w):
    """Rows in 8x128-pixel-tile order -> scanline order."""
    c = a.shape[1:]
    return a.reshape(h // 8, w // 128, 8, 128, *c).transpose(1, 2).reshape(h * w, *c)


def render_reproject_frame(scene: Scene, cfg: RenderConfig, prev_camera: Camera,
                           history, key):
    """One static-camera frame, pass 1 then pass 2 -> (tonemapped image
    [H, W, 3], new history [H, W, 3], G-buffer dict p0, n0, t0, m0).  The
    rays are generated in 8x128-pixel tiles when cfg.ray_order allows it,
    and the G-buffer is un-tiled before the resolve."""
    h, w = cfg.height, cfg.width
    dev = scene.device
    tiled = cfg.ray_order == "tile" and w % 128 == 0 and h % 8 == 0
    if tiled:
        i = torch.arange(h * w, dtype=torch.int64, device=dev)
        tile, rem = i // (8 * 128), i % (8 * 128)
        ty, tx = tile // (w // 128), tile % (w // 128)
        px = (tx * 128 + rem % 128).to(F32)
        py = (ty * 8 + rem // 128).to(F32)
    else:
        py, px = torch.meshgrid(torch.arange(h, dtype=F32, device=dev),
                                torch.arange(w, dtype=F32, device=dev), indexing="ij")
        px, py = px.reshape(-1), py.reshape(-1)
    o, d = primary_rays(scene.camera, w, h, px, py)
    with span("vt.reproject.trace"):
        gbuf = trace_reproject(scene, cfg, o, d, key)
    if tiled:
        gbuf = tuple(_untile(a, h, w) for a in gbuf)
    albedo, illum, p0, n0, t0, m0 = gbuf
    with span("vt.resolve"):
        img, new_hist = resolve(scene, cfg, prev_camera, albedo, illum, p0, m0,
                                m0 != MAT_NONE, history)
    return img, new_hist, dict(p0=p0, n0=n0, t0=t0, m0=m0)
