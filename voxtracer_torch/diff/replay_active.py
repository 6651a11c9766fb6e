"""Active path-replay gradients (counterpart of
voxtracer/diff/replay_active.py): the estimator of ``render_diff_replay``
(two replayed diffuse/metal bounces) split into a precompute that freezes
the geometry and a per-step march over only the segments that need it.

* **Phase 1, ``replay_precompute``** (once per camera and scene
  geometry: the hard traversals read the scene's grids, never the
  params): runs the hard traversals (the nearest-hit kernel on the card),
  freezes every hit record, bounce direction and light segment, compacts
  each relaxed march to the lanes that need it, clamps each segment to its
  occupied-brick span (``volumetric._occupied_spans``) and bins the
  segments by span length, the bench backward's (2, 10)-step recipe.  The
  host parts are numpy, written as the JAX package writes them, so the
  compaction, the bins and the delivery maps come out equal to its.

* **Phase 2, ``render_replay_active``** (every step): one batched march
  per (march, bin) over the compacted segments: the core span samples
  through ``volumetric._cell_fetch`` (a 1-D scatter adjoint), the
  statically empty lead and tail at the per-brick mean sigma through
  ``volumetric._bsig_rows`` (the row-lookup kernel and its scatter-add
  backward), then an elementwise assembly of the radiance from the
  delivered optical depths, the albedo rows and the frozen factors.

Phase 2 takes the precompute as ``split_pre`` splits it, as the JAX
package's does: ``spec`` (the counts and each march's static fields) and
``arrs`` (the same tensors ``pre`` holds, no copy).
``scene.convert.replay_pre_from_numpy`` carries a JAX precompute across.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from voxtracer_torch.core import mathx
from voxtracer_torch.core.rng import fold_in, threefry_normal
from voxtracer_torch.core.types import (GLASS, METAL_HIGH, METAL_LOW,
                                        SMOKE_LOW_DENSITY, SMOKE_PLAYER, Scene)
from voxtracer_torch.diff.path_replay import _far_bound, _midpoint_cells
from voxtracer_torch.diff.volumetric import (DiffParams, _band_rays_np, _brick_mean_sigma,
                                             _bsig_rows, _cell_fetch, _object_rays,
                                             _occupied_spans, _perm_first, _rows, _tile_key,
                                             softplus, value_and_grad)
from voxtracer_torch.render import integrator
from voxtracer_torch.render.sky import sample_sky

F32 = torch.float32
BIG = 1e34
_EPS = 1e-3
_EDGES = (4.0,)  # the span-length bin edge in cells: the bench's two bins
_LEAD_STEPS = 2  # brick-granular samples of each segment's lead and of its tail


# --------------------------------------------------------------------------
# Phase 1: frozen geometry and compacted, span-binned segment lists
# --------------------------------------------------------------------------

def _np(x):
    return x.detach().cpu().numpy()


def _offset_ray_np(p, nrm):
    """``mathx.offset_ray`` of numpy float32 arrays."""
    return mathx.offset_ray(torch.from_numpy(np.ascontiguousarray(p)),
                            torch.from_numpy(np.ascontiguousarray(nrm))).numpy()


def _light_segments(scene: Scene, p, nrm, mask_np):
    """The frozen shadow segments of each light at surface points p, nrm
    [n_c, 3] (numpy): a list of (o, d, t_hi, radiance [n_c, 3], gate).
    Area lights take one frozen sample each; a black directional light is
    dropped on the host."""
    L = scene.lights
    out = []

    def fin(rad, gate):
        # masked lanes can hold huge surface points: their radiance must be
        # a hard 0 (0 * inf would leak NaN through the mask)
        return np.where(gate[:, None], np.nan_to_num(rad), 0.0)

    # clamp miss-lane points before any distance overflows
    p = np.clip(p, -1e12, 1e12)
    o_sh = _offset_ray_np(p, nrm)
    for i in range(L.n_point):
        lpos = _np(L.point_pos[i])
        to_l = lpos - p
        dst = np.sqrt((to_l * to_l).sum(-1))
        dirn = to_l / np.maximum(dst[:, None], 1e-20)
        cos_t = (dirn * nrm).sum(-1)
        rad = (cos_t / np.maximum(dst * dst, 1e-20))[:, None] * _np(L.point_color[i])
        gate = mask_np & (cos_t > 0.0)
        out.append((o_sh, dirn, dst, fin(rad, gate), gate))
    for i in range(L.n_spot):
        lpos = _np(L.spot_pos[i])
        to_l = lpos - p
        dst = np.sqrt((to_l * to_l).sum(-1))
        dirn = to_l / np.maximum(dst[:, None], 1e-20)
        cos_c = (dirn * _np(L.spot_dir[i])).sum(-1)
        lcos = float(L.spot_cos_angle[i])
        alpha = 1.0 - (1.0 - cos_c) / (1.0 - lcos)
        rad = (cos_c / np.maximum(dst * dst, 1e-20) * alpha)[:, None] * _np(L.spot_color[i])
        gate = mask_np & (cos_c > lcos)
        out.append((o_sh, dirn, dst, fin(rad, gate), gate))
    # area lights: one frozen sample each
    for i in range(L.n_area):
        rng = np.random.default_rng(101 + i)
        gk = rng.normal(size=p.shape).astype(np.float32)
        rnd = gk / np.maximum(np.linalg.norm(gk, axis=-1, keepdims=True), 1e-20)
        target = _np(L.area_pos[i]) + float(L.area_radius[i]) * rnd
        to_l = target - p
        dst = np.sqrt((to_l * to_l).sum(-1))
        dirn = to_l / np.maximum(dst[:, None], 1e-20)
        cos_t = (dirn * nrm).sum(-1)
        scale = (cos_t * float(L.area_mult[i]) * float(L.area_radius[i]) ** 2
                 * (4.0 * np.pi) / np.maximum(dst * dst, 1e-20))
        rad = scale[:, None] * _np(L.area_color[i])
        gate = mask_np & (cos_t > 0.0)
        out.append((o_sh, dirn, dst, fin(rad, gate), gate))
    if np.any(_np(L.dir_color) != 0.0):
        dirn = np.broadcast_to(-_np(L.dir_direction), p.shape).astype(np.float32)
        cos_d = (dirn * nrm).sum(-1)
        rad = cos_d[:, None] * _np(L.dir_color)[None, :]
        gate = mask_np & (cos_d > 0.0)
        out.append((o_sh, dirn, np.full(p.shape[0], BIG, np.float32), fin(rad, gate), gate))
    return out


def _build_march(scene: Scene, o, d, t_lo, t_hi, mask_np, kind, steps=(2, 10)):
    """Compact one relaxed march to its lanes, clamp each segment to its
    occupied span, bin by span length.  Inputs numpy at width n_c; returns
    a march dict (segment tensors on the scene's device, the bin table
    (steps, lo, hi) and the delivery map lane -> segment, m for none)."""
    dev = scene.device
    n_c = o.shape[0]
    sel = np.nonzero(mask_np)[0].astype(np.int32)
    m = sel.shape[0]
    march = {"n_lanes": n_c, "m": m, "kind": kind}
    if m == 0:
        return march
    os_, ds_ = o[sel], d[sel]
    lo_, hi_ = t_lo[sel], np.maximum(t_hi[sel], t_lo[sel])

    # the occupied span of each segment (on the device, then to the host)
    vo, vd = _object_rays(scene, torch.from_numpy(os_).to(dev), torch.from_numpy(ds_).to(dev))
    s0, s1 = _occupied_spans(scene, vo[..., 0], vo[..., 1], vo[..., 2],
                             vd[..., 0], vd[..., 1], vd[..., 2])
    s0 = _np(torch.where(s0 < 1e33, s0, BIG).amin(0))
    s1 = _np(torch.where(s1 > -1e33, s1, -BIG).amax(0))
    del vo, vd
    s0c = np.clip(s0, lo_, hi_)
    s1c = np.clip(s1, s0c, hi_)
    none = s0 > 1e33
    s0c = np.where(none, hi_, s0c)
    s1c = np.where(none, hi_, s1c)

    # span length in cells (the largest gridsize as the scale, as the bench)
    gs = float(_np(scene.volumes.gridsize).max())
    span_cells = (s1c - s0c) * gs
    bin_id = np.searchsorted(np.asarray(_EDGES, np.float32), span_cells)
    order = np.argsort(bin_id, kind="stable").astype(np.int32)
    counts = [int((bin_id == b).sum()) for b in range(len(_EDGES) + 1)]
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(int)

    # the delivery map: lane -> its segment's position (m for none)
    pos_of_sel = np.empty(m, np.int32)
    pos_of_sel[order] = np.arange(m, dtype=np.int32)
    inv_map = np.full(n_c, m, np.int32)
    inv_map[sel] = pos_of_sel

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a[order])).to(dev)

    march.update(o=t(os_), d=t(ds_), t_lo=t(lo_), t_hi=t(hi_), s0=t(s0c), s1=t(s1c),
                 inv_map=torch.from_numpy(inv_map).to(dev),
                 bins=[(int(steps[b]), int(offs[b]), int(offs[b + 1]))
                       for b in range(len(counts)) if counts[b] > 0],
                 lead_steps=_LEAD_STEPS)
    return march


class _Deliver(torch.autograd.Function):
    """The per-segment integrals [m + 1] (the last a constant 0) gathered to
    the lanes by the delivery map, m for a lane without a segment.  Every
    segment has exactly one lane, so the adjoint needs no accumulation: a
    plain scatter of the lanes' cotangents (its pad entry, written by any
    of the lanes without a segment, is dropped).  The natural adjoint, an
    accumulating scatter, sorts ~1.2 M indices a march and took 31 ms of
    each 1080p march's backward on an H100 (PERF.md)."""

    @staticmethod
    def forward(ctx, tau, inv_map):
        ctx.save_for_backward(inv_map)
        ctx.size = tau.shape[0]
        return tau[inv_map]

    @staticmethod
    def backward(ctx, ct):
        (inv_map,) = ctx.saved_tensors
        d_tau = ct.new_zeros(ctx.size)
        d_tau[inv_map] = ct
        d_tau[-1] = 0.0
        return d_tau, None


def _march_taus(scene: Scene, sp, ar, density_scale: float, dens_flat, cell_tab, bsig):
    """The phase-2 march of one march, its static fields `sp` and its
    tensors `ar` (``split_pre``): per bin the core span samples and the
    brick-granular lead and tail -> the integral per segment, delivered to
    its lanes [n_lanes] through inv_map (0 for none).  Kind 0 integrates
    sigma (optical depth), kind 1 the soft occupancy."""
    dev = scene.device
    if sp["m"] == 0:
        return torch.zeros(sp["n_lanes"], dtype=F32, device=dev)
    delta = 4.0 / density_scale

    def integrand(sig):
        return (1.0 - torch.exp(-sig * delta)) if sp["kind"] == 1 else sig

    vo, vd = _object_rays(scene, ar["o"], ar["d"])

    def seg_sum(t_lo, t_hi, steps, lo_i, hi_i, brick):
        t_lo_b, t_hi_b = t_lo[lo_i:hi_i], t_hi[lo_i:hi_i]
        dt = torch.clamp_min(t_hi_b - t_lo_b, 0.0) / steps
        acc = torch.zeros(hi_i - lo_i, dtype=F32, device=dev)
        for kk in range(steps):
            t_mid = t_lo_b + (kk + 0.5) * dt
            flat, inside_any = _midpoint_cells(scene, vo[:, lo_i:hi_i], vd[:, lo_i:hi_i], t_mid,
                                               brick)
            if brick:
                sig = _bsig_rows(bsig, flat)
            else:
                sig = _cell_fetch(dens_flat, cell_tab, flat)[:, 0]
            acc = acc + torch.where(inside_any, integrand(sig), 0.0) * dt
        return acc

    ls = sp["lead_steps"]
    parts = []
    for steps, lo_i, hi_i in sp["bins"]:
        part = torch.zeros(hi_i - lo_i, dtype=F32, device=dev)
        if steps > 0:
            part = part + seg_sum(ar["s0"], ar["s1"], steps, lo_i, hi_i, False)
        if ls > 0:
            part = part + seg_sum(ar["t_lo"], ar["s0"], ls, lo_i, hi_i, True)
            part = part + seg_sum(ar["s1"], ar["t_hi"], ls, lo_i, hi_i, True)
        parts.append(part)
    parts.append(torch.zeros(1, dtype=F32, device=dev))
    return _Deliver.apply(torch.cat(parts), ar["inv_map"].long())


def replay_precompute(scene: Scene, cfg, key, steps=(2, 10), tau0_steps=(4, 16)):
    """Phase 1: freeze the whole replay path (module docstring) -> the
    precompute dict, its tensors on the scene's device.  Monu-class scenes
    carry 6 marches (the primary span, the shadow segments at 3 surfaces
    per light, 2 bounce segments); glass and smoke primary lanes are
    counted (``media_lanes``) and shade their frozen background here, as
    in the JAX package (``render_diff_replay`` covers their chains)."""
    dev = scene.device
    px, py, o_np, d_np = _band_rays_np(scene, cfg, 0, 0)
    o_np = np.ascontiguousarray(o_np)
    n = o_np.shape[0]
    o, d = torch.from_numpy(o_np).to(dev), torch.from_numpy(d_np).to(dev)

    rec0 = integrator.find_nearest_world(scene, o, d, torch.ones(n, dtype=torch.bool, device=dev))
    hit0 = _np(rec0["hit"])
    # compact to the hit lanes in tile order (the others render the frozen bg)
    perm = _perm_first(hit0, _tile_key(cfg, px, py))[0]
    n_hit = int(hit0.sum())
    n_c = min(-(-max(n_hit, 1) // 1024) * 1024, n)
    sel = perm[:n_c]
    sel_t = torch.from_numpy(sel).to(dev).long()

    def c(a):
        return _np(a[sel_t])

    m0 = c(rec0["mat"]).astype(np.int32)
    t0 = c(rec0["t"])
    n0 = np.stack([c(rec0["nx"]), c(rec0["ny"]), c(rec0["nz"])], axis=-1)
    oc, dc = o_np[sel], d_np[sel]
    p0 = oc + t0[:, None] * dc
    hit_c = c(rec0["hit"]) & (np.arange(n_c) < n_hit)

    is_metal = (m0 >= METAL_HIGH) & (m0 <= METAL_LOW)
    is_diffuse = m0 < METAL_HIGH
    is_glass = m0 == GLASS
    is_smoke = (m0 >= SMOKE_LOW_DENSITY) & (m0 <= SMOKE_PLAYER)
    media = is_glass | is_smoke
    bounce = hit_c & (is_metal | is_diffuse)

    # frozen bounce directions: the draws of render_diff_replay, at the
    # full ray count, then compacted, so both estimators replay the same
    # paths on the diffuse and metal lanes
    gk = c(threefry_normal(fold_in(key, 2), (n, 3), dev))
    sph = gk / np.maximum(np.linalg.norm(gk, axis=-1, keepdims=True), 1e-20)
    refl = mathx.reflect(torch.from_numpy(dc), torch.from_numpy(n0)).numpy()
    d1 = np.where(is_metal[:, None], refl, n0 + sph)
    d1 = d1 / np.maximum(np.linalg.norm(d1, axis=-1, keepdims=True), 1e-20)
    o1 = _offset_ray_np(p0, n0)

    def far_np(o_, d_):
        return _np(_far_bound(scene, torch.from_numpy(o_).to(dev), torch.from_numpy(d_).to(dev)))

    def leg(o_, d_, mask_np):
        ot, dt_ = torch.from_numpy(np.ascontiguousarray(o_)).to(dev), torch.from_numpy(d_).to(dev)
        rec = integrator.find_nearest_world(scene, ot, dt_, torch.from_numpy(mask_np).to(dev))
        hit = _np(rec["hit"]) & mask_np
        t = _np(rec["t"])
        nn = np.stack([_np(rec["nx"]), _np(rec["ny"]), _np(rec["nz"])], axis=-1)
        p = o_ + t[:, None] * d_
        seg_hi = np.where(hit, np.maximum(t - _EPS, 0.0), far_np(o_, d_))
        sky = _np(sample_sky(scene.sky, dt_, cfg.activate_sky, cfg.sky_fallback))
        return dict(hit=hit, t=t, m=_np(rec["mat"]).astype(np.int32), n=nn, p=p,
                    seg_hi=seg_hi, sky=sky)

    leg1 = leg(o1, d1, bounce)
    m1 = leg1["m"]
    is_metal1 = (m1 >= METAL_HIGH) & (m1 <= METAL_LOW)
    bounce2 = bounce & leg1["hit"] & ((m1 < METAL_HIGH) | is_metal1)
    gk2 = c(threefry_normal(fold_in(key, 4), (n, 3), dev))
    sph2 = gk2 / np.maximum(np.linalg.norm(gk2, axis=-1, keepdims=True), 1e-20)
    refl1 = mathx.reflect(torch.from_numpy(d1), torch.from_numpy(leg1["n"])).numpy()
    d2 = np.where(is_metal1[:, None], refl1, leg1["n"] + sph2)
    d2 = d2 / np.maximum(np.linalg.norm(d2, axis=-1, keepdims=True), 1e-20)
    o2 = _offset_ray_np(leg1["p"], leg1["n"])
    leg2 = leg(o2, d2, bounce2)

    far0 = far_np(oc, dc)
    mb = partial(_build_march, scene, steps=steps)
    eps = np.full(n_c, _EPS, np.float32)
    marches = {
        "tau0": _build_march(scene, oc, dc, np.zeros(n_c, np.float32), far0, hit_c, 0,
                             steps=tau0_steps),
        "tau01": mb(o1, d1, eps, leg1["seg_hi"], bounce, 0),
        "tau12": mb(o2, d2, eps, leg2["seg_hi"], bounce2, 0),
    }
    lights = {
        "e0": _light_segments(scene, p0, n0, hit_c & ~media),
        "e1": _light_segments(scene, leg1["p"], leg1["n"], bounce & leg1["hit"]),
        "e2": _light_segments(scene, leg2["p"], leg2["n"], bounce2 & leg2["hit"]),
    }
    light_marches, light_rads = {}, {}
    for name, segs in lights.items():
        light_marches[name] = [mb(o_sh, dirn, eps, dst, gate, 0)
                               for (o_sh, dirn, dst, _, gate) in segs]
        light_rads[name] = [(torch.from_numpy(rad.astype(np.float32)).to(dev),
                             torch.from_numpy(gate).to(dev)) for (_, _, _, rad, gate) in segs]

    bg_full = sample_sky(scene.sky, d, cfg.activate_sky, cfg.sky_fallback)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return dict(
        n=n, n_c=n_c, n_hit=n_hit, sel=t(sel), perm=t(perm),
        # media lanes shade the frozen bg here (pre["media_lanes"] counts
        # them; render_diff_replay covers their chains)
        hit=t(hit_c & ~media), m0=t(m0), bounce=t(bounce), bounce2=t(bounce2),
        shade0=t(hit_c & ~media), m1=t(m1), hit1=t(leg1["hit"]), sky1=t(leg1["sky"]),
        m2=t(leg2["m"]), hit2=t(leg2["hit"]), sky2=t(leg2["sky"]),
        bg=bg_full[sel_t].contiguous(), marches=marches, light_marches=light_marches,
        light_rads=light_rads, media_lanes=int((hit_c & (is_glass | is_smoke)).sum()))


# --------------------------------------------------------------------------
# Phase 2: the differentiable assembly, every step
# --------------------------------------------------------------------------

def split_pre(pre):
    """pre -> (spec, arrs), the JAX package's split, key for key: spec the
    counts and each march's static fields, arrs the march tensors
    (``arrs["marches"]``, ``arrs["lm"]``), the light radiances
    (``arrs["lr"]``) and the 12 lane tensors (``arrs["lanes"]``), the
    same tensors ``pre`` holds."""
    ak = ("o", "d", "t_lo", "t_hi", "s0", "s1", "inv_map")

    def sm(m):
        return ({k: v for k, v in m.items() if k not in ak},
                {k: m[k] for k in ak if k in m})

    spec_m, arr_m = {}, {}
    for nm, m in pre["marches"].items():
        spec_m[nm], arr_m[nm] = sm(m)
    spec_lm, arr_lm = {}, {}
    for nm, lst in pre["light_marches"].items():
        pairs = [sm(m) for m in lst]
        spec_lm[nm] = [q[0] for q in pairs]
        arr_lm[nm] = [q[1] for q in pairs]
    lane_keys = ("hit", "m0", "bounce", "bounce2", "shade0", "m1", "hit1",
                 "sky1", "m2", "hit2", "sky2", "bg")
    arrs = dict(marches=arr_m, lm=arr_lm, lr=pre["light_rads"],
                lanes={k: pre[k] for k in lane_keys})
    spec = dict(n=pre["n"], n_c=pre["n_c"], n_hit=pre["n_hit"],
                media_lanes=pre["media_lanes"], marches=spec_m, lm=spec_lm)
    return spec, arrs


def render_replay_active(params: DiffParams, scene: Scene, cfg, spec, arrs,
                         density_scale: float = 64.0):
    """Radiance of the compacted hit lanes [n_c, 3] from the frozen
    geometry of ``replay_precompute``, split by ``split_pre``,
    differentiable in params only: the two-bounce diffuse/metal replay
    estimator (glass and smoke primary lanes shade their frozen
    background)."""
    dens_flat = softplus(params.density_logits).reshape(-1) * density_scale
    cell_tab = torch.stack([dens_flat.detach(), scene.volumes.grids.reshape(-1).to(F32)], dim=1)
    bsig = _brick_mean_sigma(params, scene, density_scale)
    alb_tab = params.albedo_table
    lanes = arrs["lanes"]

    def taus(sp, ar):
        return _march_taus(scene, sp, ar, density_scale, dens_flat, cell_tab, bsig)

    def direct(name):
        acc = torch.zeros((spec["n_c"], 3), dtype=F32, device=scene.device)
        for sp, ar, (rad, gate) in zip(spec["lm"][name], arrs["lm"][name], arrs["lr"][name]):
            vs = torch.where(gate, torch.exp(-taus(sp, ar)), 0.0)
            acc = acc + vs[:, None] * rad
        return acc

    def march(name):
        return taus(spec["marches"][name], arrs["marches"][name])

    w0 = 1.0 - torch.exp(-march("tau0"))
    alb0 = _rows(alb_tab, torch.clamp(lanes["m0"], 0, 255))
    e0 = direct("e0")
    # render_diff_replay shades direct0 = alb0 E0 at every non-media hit
    direct0 = torch.where(lanes["shade0"][:, None], alb0 * e0, 0.0)

    v01 = torch.exp(-march("tau01"))
    v12 = torch.exp(-march("tau12"))
    alb1 = _rows(alb_tab, torch.clamp(lanes["m1"], 0, 255))
    alb2 = _rows(alb_tab, torch.clamp(lanes["m2"], 0, 255))
    e1 = direct("e1")
    e2 = direct("e2")
    l2 = torch.where(lanes["hit2"][:, None], alb2 * e2, lanes["sky2"])
    rad2 = v12[:, None] * l2
    l1 = torch.where(lanes["hit1"][:, None],
                     alb1 * (e1 + torch.where(lanes["bounce2"][:, None], rad2, 0.0)),
                     lanes["sky1"])
    bounce_rad = torch.where(lanes["bounce"][:, None], alb0 * v01[:, None] * l1, 0.0)

    lsurf = direct0 + bounce_rad
    bg = lanes["bg"]
    return torch.where(lanes["hit"][:, None], w0[:, None] * lsurf + (1.0 - w0)[:, None] * bg, bg)


def mse_loss_replay_active(params: DiffParams, scene: Scene, cfg, spec, arrs, target_active,
                           denom: float, density_scale: float = 64.0):
    """Sum of squared errors over the compacted hit lanes / denom: with
    denom the full frame's element count, exactly the gradient of the
    full-image MSE (pixels without a hit render the frozen bg)."""
    img = render_replay_active(params, scene, cfg, spec, arrs, density_scale)
    err = ((img - target_active) ** 2).sum(dim=-1)
    err = torch.where(torch.arange(spec["n_c"], device=img.device) < spec["n_hit"], err, 0.0)
    return err.sum() / denom


def make_replay_grad_fn(scene: Scene, cfg, pre, target_active, denom: float,
                        density_scale: float = 64.0):
    """-> (grad_fn, loss_fn): params -> DiffParams of gradients, and
    params -> the loss (no graph)."""
    spec, arrs = split_pre(pre)

    def loss(params):
        return mse_loss_replay_active(params, scene, cfg, spec, arrs, target_active, denom,
                                      density_scale)

    vg = value_and_grad(loss)

    def loss_fn(params):
        with torch.no_grad():
            return loss(params)

    return (lambda params: vg(params)[1]), loss_fn
