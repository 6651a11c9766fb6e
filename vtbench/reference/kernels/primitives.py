"""Analytic spheres and triangles in plain torch (src/BVH/Shapes.h;
counterpart of voxtracer/kernels/primitives.py): each test is a
[N rays, M prims] broadcast with a min-reduce."""

from __future__ import annotations

import torch

from vtbench.reference.core.mathx import dot3, sqrt
from vtbench.reference.core.types import MAT_NONE, Spheres, Triangles

BIG = 1e34


def _full(n, value, dtype, device):
    return torch.full((n,), value, dtype=dtype, device=device)


def _sphere_t(sp: Spheres, o, d):
    to_ray = o[:, None, :] - sp.center[None, :, :]  # [N, M, 3]
    b = dot3(to_ray, d[:, None, :])
    c = dot3(to_ray, to_ray) - sp.radius[None, :] ** 2
    disc = b * b - c
    reject = ((c > 0.0) & (b > 0.0)) | (disc < 0.0)
    return reject, -b - sqrt(torch.clamp(disc, min=0.0))


def spheres_nearest(sp: Spheres, o, d):
    """Closest sphere hit on a fresh ray (renderer.cpp:996-1006).
    Returns (t, mat, normal [N, 3], inside)."""
    n, dev = o.shape[0], o.device
    if sp.center.shape[0] == 0:
        return (_full(n, BIG, torch.float32, dev),
                _full(n, MAT_NONE, torch.int32, dev),
                torch.zeros((n, 3), device=dev), torch.zeros(n, dtype=torch.bool, device=dev))
    reject, t = _sphere_t(sp, o, d)
    t = torch.where(reject | (t < 0.0), BIG, t)
    best = t.argmin(dim=1)
    t_best = t.gather(1, best[:, None])[:, 0]
    hit = t_best < BIG
    p = o + t_best[:, None] * d
    n_out = (p - sp.center[best]) / sp.radius[best][:, None]
    outside = dot3(d, n_out) < 0.0
    normal = torch.where(outside[:, None], n_out, -n_out)
    mat = torch.where(hit, sp.material[best], MAT_NONE)
    return t_best, mat, normal, hit & ~outside


def _tri_uvt(tr: Triangles, o, d):
    p1 = tr.position + tr.v0
    p2 = tr.position + tr.v1
    p3 = tr.position + tr.v2
    e1 = (p2 - p1)[None, :, :]
    e2 = (p3 - p1)[None, :, :]
    dv = d[:, None, :].expand(-1, e1.shape[1], -1)
    h = torch.cross(dv, e2.expand_as(dv), dim=-1)
    a = dot3(e1, h)
    parallel = a.abs() < 1e-4
    f = 1.0 / torch.where(parallel, 1.0, a)
    s = o[:, None, :] - p1[None, :, :]
    u = f * dot3(s, h)
    q = torch.cross(s, e1.expand_as(s), dim=-1)
    v = f * dot3(dv, q)
    t = f * dot3(e2, q)
    return p1, p2, p3, parallel, u, v, t


def triangles_nearest(tr: Triangles, o, d):
    """Closest Moller-Trumbore hit (Shapes.h:79-111): (t, mat, normal)."""
    n, dev = o.shape[0], o.device
    if tr.v0.shape[0] == 0:
        return (_full(n, BIG, torch.float32, dev),
                _full(n, MAT_NONE, torch.int32, dev), torch.zeros((n, 3), device=dev))
    p1, p2, p3, parallel, u, v, t = _tri_uvt(tr, o, d)
    bad = parallel | (u < 0) | (u > 1) | (v < 0) | (u + v > 1) | (t <= 1e-4)
    t = torch.where(bad, BIG, t)
    best = t.argmin(dim=1)
    t_best = t.gather(1, best[:, None])[:, 0]
    hit = t_best < BIG
    n_geo = torch.cross((p2 - p1)[best], (p3 - p1)[best], dim=-1)
    n_geo = n_geo / torch.clamp(sqrt(dot3(n_geo, n_geo))[:, None], min=1e-20)
    normal = torch.where(dot3(d, n_geo)[:, None] < 0.0, n_geo, -n_geo)
    mat = torch.where(hit, tr.material[best], MAT_NONE)
    return t_best, mat, normal


def spheres_occluded(sp: Spheres, o, d, t_limit):
    """Any hit with t in [0, t_limit] (Shapes.h:44-62)."""
    if sp.center.shape[0] == 0:
        return torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    reject, t = _sphere_t(sp, o, d)
    return (~reject & (t >= 0.0) & (t <= t_limit[:, None])).any(dim=1)


def triangles_occluded(tr: Triangles, o, d, t_limit):
    if tr.v0.shape[0] == 0:
        return torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    _, _, _, parallel, u, v, t = _tri_uvt(tr, o, d)
    ok = ~parallel & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
    ok = ok & (t >= 1e-4) & (t <= t_limit[:, None])
    return ok.any(dim=1)
