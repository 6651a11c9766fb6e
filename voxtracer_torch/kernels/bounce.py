"""The path bounce's shading in three stages, in two sets: the kernels of
csrc/bounce.cu (``KERNELS``) and their plain versions (``PLAIN``).

A bounce's buffers live in one ``Bounce``: the packed path state (the
integrator's ``_pack_path`` rows; a chunk view of a wider wavefront
works), shaded in place, the nearest hit, the material rows, the draws,
the lights, and what the stages hand each other and the traversals
between them.  The integrator's one bounce (``_bounce_core``) runs

    K1, K4 -> hit -> K3 (where a ray marches) -> nee -> K2 -> continue

with ``KERNELS`` on a CUDA state and ``PLAIN`` on any other.  ``hit``,
``nee`` and ``continue_`` launch one kernel each on CUDA tensors and
refuse any other device; ``hit_plain``, ``nee_plain`` and
``continue_plain`` do the same by torch ops on any device.  The plain
stages are the CPU's bounce, held to the JAX package's
(tests/test_torch_bounce.py), and the oracle the card holds the kernels
to bit for bit (tests/test_torch_gpu.py).  ``launches`` counts the
kernels."""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from voxtracer_torch.core import mathx
from voxtracer_torch.core.types import (EMISSIVE, GLASS, MAT_NONE, METAL_HIGH, METAL_LOW,
                                        SMOKE_LOW_DENSITY, SMOKE_PLAYER)
from voxtracer_torch.kernels import build
from voxtracer_torch.kernels.dda import EXIT_GLASS, EXIT_SMOKE

launches = {"bounce_hit": 0, "bounce_nee": 0, "bounce_continue": 0}

F32 = torch.float32
BIG = 1e34
TWO_PI = 6.283185307179586
# rows of the packed state (integrator._pack_path)
R_O, R_D, R_TP, R_RAD, R_GL, R_ACT, R_SKY_TP, R_SKY_D, R_LK = 0, 3, 6, 9, 12, 13, 15, 18, 21

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FIELDS = (
    ("pk", _P), ("stride", ctypes.c_longlong), ("n", _I), ("has_lk", _I),
    ("t", _P), ("mat", _P), ("vol", _P), ("nx", _P), ("ny", _P), ("nz", _P),
    ("prim_adopt", _P), ("prim_inside", _P), ("mrow", _P),
    ("march", _P), ("mode", _P),
    ("in_vol", _P), ("t_exit", _P), ("ex_nx", _P), ("ex_ny", _P), ("ex_nz", _P),
    ("u_lobe", _P), ("u_nee", _P), ("g_nee", _P), ("u_lk", _P), ("g_lk", _P),
    ("g_det", _P), ("g_det_lk", _P),
    ("u_sph", _P), ("g_hemi", _P), ("u_f", _P), ("u_s", _P), ("g_oct", _P),
    ("point_pos", _P), ("point_color", _P), ("area_pos", _P), ("area_color", _P),
    ("area_mult", _P), ("area_radius", _P), ("spot_pos", _P), ("spot_dir", _P),
    ("spot_color", _P), ("spot_cos", _P), ("dir_direction", _P), ("dir_color", _P),
    ("n_point", _I), ("n_area", _I), ("n_spot", _I), ("det", _I), ("samples", _I),
    ("inv_samples", _F), ("kill_threshold", _F),
    ("sh_o", _P), ("sh_d", _P), ("sh_t", _P), ("need", _P), ("nee_val", _P),
    ("lk_d", _P), ("lk_t", _P), ("lk_need", _P), ("lk_val", _P),
    ("go_diffuse", _P), ("nee_mask", _P),
    ("occ", _P), ("lk_occ", _P),
    ("out_in_glass", _P), ("out_active", _P), ("out_in_light", _P),
)


class CArgs(ctypes.Structure):
    """csrc/bounce.cu ``Args``, field for field."""
    _fields_ = _FIELDS


_LIGHTS = ("point_pos", "point_color", "area_pos", "area_color", "area_mult", "area_radius",
           "spot_pos", "spot_dir", "spot_color", "spot_cos_angle", "dir_direction", "dir_color")


class Draws(NamedTuple):
    """A bounce's draws (integrator._uni / _nrml), each [n] or [k, n]."""
    u_lobe: torch.Tensor  # salt 1
    u_sph: torch.Tensor   # salt 3, [3, n]
    g_hemi: torch.Tensor  # salt 4, [3, n] normals
    u_f: torch.Tensor     # salt 5
    u_s: torch.Tensor     # salt 6, [2, n]
    g_oct: torch.Tensor   # salt 8, [3, n] normals
    u_nee: object         # salt 7 under fold_in(key, 2); None with deterministic lights
    g_nee: object         # salt 11 there, [3, n] normals; None without area lights
    u_lk: object          # the light kill's, under fold_in(key, 9); None without it
    g_lk: object
    g_det: object         # deterministic lights: [areas * samples, 3, n], area light i's
    g_det_lk: object      # sample k (salt 200 + k under fold_in(key, 1000 + i)) at row
                          # i * samples + k; None without area lights


def segments(lights, cfg) -> int:
    """The shadow rays a ray casts for one NEE: one for the random light;
    with cfg.deterministic_lights one a light, num_area_samples an area
    light."""
    if not cfg.deterministic_lights:
        return 1
    return lights.n_point + lights.n_area * cfg.num_area_samples + lights.n_spot + 1


class Bounce:
    """One bounce's buffers.  pk: the packed state [21 or 22, n] (rows
    contiguous, any row stride), written in place; rec: find_nearest_world's
    dict; mrow: the [n, 6] material rows; lights: the scene's Lights; cfg:
    the RenderConfig (the light kill, its threshold, the deterministic
    lights and their area samples).  The shadow rays are segment-major: m
    segments (``segments``) of n rays."""

    def __init__(self, pk, rec, mrow, draws: Draws, lights, cfg):
        n, dev = pk.shape[1], pk.device
        self.pk, self.rec, self.mrow, self.draws, self.lights = pk, rec, mrow, draws, lights
        self.n, self.has_lk, self.kill_threshold = n, cfg.detect_light_kill, cfg.light_kill_threshold
        self.det, self.samples = cfg.deterministic_lights, cfg.num_area_samples
        m = self.m = segments(lights, cfg)
        sizes = [3 * m * n, 3 * m * n, m * n, 3 * m * n, n] + [3 * m * n, m * n, 3 * m * n] * self.has_lk
        f = torch.empty(sum(sizes), dtype=F32, device=dev).split(sizes)
        self.sh_o, self.sh_d, self.sh_t = f[0].view(m * n, 3), f[1].view(m * n, 3), f[2]
        self.nee_val, self.mode = f[3].view(m, 3, n), f[4].view(torch.int32)
        self.lk_d, self.lk_t, self.lk_val = ((f[5].view(m * n, 3), f[6], f[7].view(m, 3, n))
                                             if self.has_lk else (None, None, None))
        sizes = [n, m * n, n, n, n, n, n] + [m * n] * self.has_lk
        b = torch.empty(sum(sizes), dtype=torch.bool, device=dev).split(sizes)
        (self.march, self.need, self.go_diffuse, self.nee_mask, self.out_in_glass,
         self.out_active, self.out_in_light) = b[:7]
        self.lk_need = b[7] if self.has_lk else None
        self.exit = None  # K3's (in_vol, t, nx, ny, nz) where a ray marched
        self.occ = self.lk_occ = None  # K2's
        self.c = None


# --------------------------------------------------------------------------
# The kernels
# --------------------------------------------------------------------------

def _ptr(x):
    return None if x is None else x.data_ptr()


def _device(b: Bounce) -> int:
    """The index of b's CUDA device; raises for any other device."""
    if not b.pk.is_cuda:
        raise ValueError(f"no bounce kernels for device {b.pk.device}: the plain versions "
                         "(hit_plain, nee_plain, continue_plain) run there")
    return b.pk.get_device()


def _check(name, x, dtype, shape, index):
    """Raise unless x is a contiguous tensor of dtype and shape on cuda:index
    (cheap attribute reads: they run every bounce)."""
    if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous() \
            or x.get_device() != index:
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of shape {shape} "
                         f"on cuda:{index}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _check_bounce(b: Bounce) -> int:
    """Raise unless b's tensors are what the kernels take -> the device
    index."""
    index, pk, n = _device(b), b.pk, b.n
    if pk.dtype != F32 or pk.dim() != 2 or pk.stride(1) != 1 \
            or pk.shape[0] != (22 if b.has_lk else 21):
        raise ValueError("pk: expected float32 rows [21 (22 with in_light), n] with "
                         f"contiguous rows, got {pk.dtype} {tuple(pk.shape)} {pk.stride()}")
    if n >= 2 ** 31 // 3:
        raise ValueError(f"{n} rays: the kernels index [n, 3] buffers in 32 bits")
    for name in ("t", "nx", "ny", "nz"):
        _check(name, b.rec[name], F32, (n,), index)
    for name in ("mat", "vol"):
        _check(name, b.rec[name], torch.int32, (n,), index)
    for name in ("prim_adopt", "prim_inside"):
        _check(name, b.rec[name], torch.bool, (n,), index)
    _check("mrow", b.mrow, F32, (n, 6), index)
    for name, x in zip(Draws._fields, b.draws):
        if x is not None:
            _check(f"draw {name}", x, F32, tuple(x.shape[:-1]) + (n,), index)
    area = b.lights.n_area * b.samples if b.det else 0
    for name in ("g_det", "g_det_lk")[:1 + b.has_lk] if area else ():
        x = getattr(b.draws, name)
        if x is None or tuple(x.shape) != (area, 3, n):
            raise ValueError(f"draw {name}: expected [{area}, 3, {n}] area samples")
    return index


def _lights(L, index: int) -> tuple:
    """The lights' pointers in CArgs' order, then their counts."""
    ptrs = []
    for f in _LIGHTS:
        x = getattr(L, f)
        if x.dtype != F32 or not x.is_contiguous() or (x.numel() and x.get_device() != index):
            raise ValueError(f"lights.{f}: expected contiguous float32 on cuda:{index}")
        ptrs.append(x.data_ptr())
    return (*ptrs, L.n_point, L.n_area, L.n_spot)


def _cargs(b: Bounce, index: int) -> CArgs:
    """The kernels' argument struct, filled once a bounce (in field
    order)."""
    rec, dr = b.rec, b.draws
    return CArgs(
        b.pk.data_ptr(), b.pk.stride(0), b.n, int(b.has_lk),
        *(rec[k].data_ptr() for k in ("t", "mat", "vol", "nx", "ny", "nz", "prim_adopt",
                                      "prim_inside")),
        b.mrow.data_ptr(), b.march.data_ptr(), b.mode.data_ptr(),
        None, None, None, None, None,
        *(_ptr(x) for x in (dr.u_lobe, dr.u_nee, dr.g_nee, dr.u_lk, dr.g_lk, dr.g_det,
                            dr.g_det_lk, dr.u_sph, dr.g_hemi, dr.u_f, dr.u_s, dr.g_oct)),
        *_lights(b.lights, index), int(b.det), b.samples,
        1.0 / b.samples if b.samples else 0.0, b.kill_threshold,
        *(_ptr(x) for x in (b.sh_o, b.sh_d, b.sh_t, b.need, b.nee_val, b.lk_d, b.lk_t,
                            b.lk_need, b.lk_val, b.go_diffuse, b.nee_mask)),
        None, None, b.out_in_glass.data_ptr(), b.out_active.data_ptr(),
        b.out_in_light.data_ptr())


def _prepared(b: Bounce) -> int:
    """The device index of a bounce past ``hit``; a bounce that did not
    come through ``hit`` (a copy, say) is checked and gets its struct."""
    if b.c is None:
        index = _check_bounce(b)
        b.c = _cargs(b, index)
        return index
    return _device(b)


def _launch(stage: int, name: str, b: Bounce, index: int) -> None:
    build.check(build.lib().vt_bounce(stage, ctypes.addressof(b.c),
                                      torch._C._cuda_getCurrentRawStream(index)), name)
    launches[name] += 1


def hit(b: Bounce) -> None:
    """bounce_hit: after K1 and K4.  Writes the adopted inside-glass flag,
    a miss's deferred sky and end, the emissive add, and ``b.march`` /
    ``b.mode`` for K3."""
    index = _check_bounce(b)
    b.c = _cargs(b, index)
    _launch(0, "bounce_hit", b, index)


def nee(b: Bounce) -> None:
    """bounce_nee: after K3 (``b.exit``, None where no ray marched).  Writes
    the exit's t and normal into the hit record, a fell ray's origin into
    the state, the lobe choice and the shadow rays K2 takes."""
    index = _prepared(b)
    if b.exit is not None:
        for (name, dtype), x in zip((("in_vol", torch.bool), ("t_exit", F32), ("ex_nx", F32),
                                     ("ex_ny", F32), ("ex_nz", F32)), b.exit):
            _check(name, x, dtype, (b.n,), index)
            setattr(b.c, name, x.data_ptr())
    _launch(1, "bounce_nee", b, index)


def continue_(b: Bounce) -> None:
    """bounce_continue: after K2 (``b.occ``, and ``b.lk_occ`` with the
    light kill).  Writes the new state in place and its flags as bool
    rows."""
    index = _prepared(b)
    _check("occ", b.occ, torch.bool, (b.m * b.n,), index)
    if b.has_lk:
        _check("lk_occ", b.lk_occ, torch.bool, (b.m * b.n,), index)
    b.c.occ, b.c.lk_occ = _ptr(b.occ), _ptr(b.lk_occ)
    _launch(2, "bounce_continue", b, index)


# --------------------------------------------------------------------------
# The plain versions: each stage by torch ops; together they compute the
# JAX package's bounce (voxtracer/render/integrator.py _bounce_core)
# --------------------------------------------------------------------------

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _unit(a):
    s = torch.rsqrt(torch.clamp(_dot(a, a), min=1e-20))
    return (s * a[0], s * a[1], s * a[2])


def _where(m, a, b):
    return tuple(torch.where(m, a[i], b[i]) for i in range(3))


def _classes(mat):
    return dict(metal=(mat >= METAL_HIGH) & (mat <= METAL_LOW), nonmetal=mat < METAL_HIGH,
                glass=mat == GLASS, smoke=(mat >= SMOKE_LOW_DENSITY) & (mat <= SMOKE_PLAYER),
                emissive=mat == EMISSIVE, model=(mat > EMISSIVE) & (mat != MAT_NONE))


def _rows(pk, r):
    return (pk[r], pk[r + 1], pk[r + 2])


def _put(pk, r, v):
    for i in range(3):
        pk[r + i] = v[i]


def hit_plain(b: Bounce) -> None:
    """``hit`` by torch ops."""
    pk, rec, mat = b.pk, b.rec, b.rec["mat"]
    k = _classes(mat)
    b.mode.copy_(torch.where(k["glass"], EXIT_GLASS, EXIT_SMOKE))
    act = pk[R_ACT] > 0.5
    gl = torch.where(rec["prim_adopt"], rec["prim_inside"], pk[R_GL] > 0.5)
    pk[R_GL] = gl.to(F32)
    miss = act & (mat == MAT_NONE)
    _put(pk, R_SKY_TP, _where(miss, _rows(pk, R_TP), _rows(pk, R_SKY_TP)))
    _put(pk, R_SKY_D, _where(miss, _rows(pk, R_D), _rows(pk, R_SKY_D)))
    act = act & ~miss
    pk[R_ACT] = act.to(F32)
    emis, tp = b.mrow[:, 4], _rows(pk, R_TP)
    _put(pk, R_RAD, tuple(torch.where(act & k["emissive"],
                                      pk[R_RAD + i] + tp[i] * (emis * b.mrow[:, i]),
                                      pk[R_RAD + i]) for i in range(3)))
    b.march.copy_(act & gl & (k["glass"] | k["smoke"]) & (rec["vol"] >= 0))


def _toward(lpos, p):
    to_l = (lpos[0] - p[0], lpos[1] - p[1], lpos[2] - p[2])
    dst = mathx.sqrt(_dot(to_l, to_l))
    r = 1.0 / dst
    return (r * to_l[0], r * to_l[1], r * to_l[2]), dst


def _random_light(b: Bounce, u, g, p, nrm, alb):
    """integrator.illumination's random branch, every light type: -> one
    segment (direction, shadow t, gate, len(lights) * (0 + intensity *
    albedo))."""
    L = b.lights
    n_p, n_a, n_s = L.n_point, L.n_area, L.n_spot
    total = L.count
    n, dev = u.shape[0], u.device
    zero = tuple(torch.zeros(n, dtype=F32, device=dev) for _ in range(3))
    idx = torch.clamp((u * total).to(torch.int32), max=total - 1)
    dirn, inten = zero, zero
    shadow_t = torch.full((n,), BIG, dtype=F32, device=dev)
    gate = torch.zeros(n, dtype=torch.bool, device=dev)

    def rows(tab, i):
        return tab[i][:, 0], tab[i][:, 1], tab[i][:, 2]

    if n_p:
        sel = idx < n_p
        i_p = torch.clamp(idx, 0, n_p - 1).long()
        d_p, dst = _toward(rows(L.point_pos, i_p), p)
        cos_t = _dot(d_p, nrm)
        s = cos_t / (dst * dst)
        lcol = rows(L.point_color, i_p)
        dirn = _where(sel, d_p, dirn)
        inten = _where(sel, (s * lcol[0], s * lcol[1], s * lcol[2]), inten)
        shadow_t = torch.where(sel, dst, shadow_t)
        gate = torch.where(sel, cos_t > 0.0, gate)
    if n_a:
        sel = (idx >= n_p) & (idx < n_p + n_a)
        i_a = torch.clamp(idx - n_p, 0, n_a - 1).long()
        lpos, lcol = rows(L.area_pos, i_a), rows(L.area_color, i_a)
        lmul, lrad = L.area_mult[i_a], L.area_radius[i_a]
        rnd = _unit((g[0].abs() + 1e-12, g[1].abs() + 1e-12, g[2].abs() + 1e-12))
        d_a, dst = _toward(tuple(lrad * rnd[i] + lpos[i] for i in range(3)), p)
        cos_t = _dot(d_a, nrm)
        s = cos_t * lmul * lrad * lrad * (4.0 * math.pi) / (dst * dst)
        dirn = _where(sel, d_a, dirn)
        inten = _where(sel, (s * lcol[0], s * lcol[1], s * lcol[2]), inten)
        shadow_t = torch.where(sel, dst, shadow_t)
        gate = torch.where(sel, cos_t > 0.0, gate)
    if n_s:
        sel = (idx >= n_p + n_a) & (idx < n_p + n_a + n_s)
        i_s = torch.clamp(idx - n_p - n_a, 0, n_s - 1).long()
        d_s, dst = _toward(rows(L.spot_pos, i_s), p)
        ldir, lcol, lcos = rows(L.spot_dir, i_s), rows(L.spot_color, i_s), L.spot_cos_angle[i_s]
        cos_t = _dot(d_s, ldir)
        alpha = 1.0 - (1.0 - cos_t) / (1.0 - lcos)
        s = cos_t / (dst * dst) * alpha
        dirn = _where(sel, d_s, dirn)
        inten = _where(sel, (s * lcol[0], s * lcol[1], s * lcol[2]), inten)
        shadow_t = torch.where(sel, dst, shadow_t)
        gate = torch.where(sel, cos_t > lcos, gate)
    sel = idx >= n_p + n_a + n_s
    d_d = tuple((-L.dir_direction[i]).expand(n) for i in range(3))
    cos_d = _dot(d_d, nrm)
    dirn = _where(sel, d_d, dirn)
    inten = _where(sel, tuple(cos_d * L.dir_color[i] for i in range(3)), inten)
    shadow_t = torch.where(sel, BIG, shadow_t)
    gate = torch.where(sel, (cos_d > 0.0) & (L.dir_color != 0.0).any(), gate)
    return [(dirn, shadow_t, gate, tuple(float(total) * (0.0 + inten[i] * alb[i])
                                         for i in range(3)))]


def _det_lights(b: Bounce, g_det, p, nrm, alb):
    """integrator._det_illumination's segments, in its order: -> a
    (direction, shadow t, gate, contribution) a light, num_area_samples an
    area light (the contribution without the albedo there)."""
    L, n = b.lights, p[0].shape[0]
    segs = []

    def row(tab, i):
        return tab[i, 0], tab[i, 1], tab[i, 2]

    for i in range(L.n_point):
        dirn, dst = _toward(row(L.point_pos, i), p)
        cos_t, lcol = _dot(dirn, nrm), row(L.point_color, i)
        s = cos_t / (dst * dst)
        segs.append((dirn, dst, cos_t > 0.0, tuple(s * lcol[c] * alb[c] for c in range(3))))
    for i in range(L.n_area):
        lpos, lcol = row(L.area_pos, i), row(L.area_color, i)
        lmul, lrad = L.area_mult[i], L.area_radius[i]
        for k in range(b.samples):
            g = g_det[i * b.samples + k]
            rnd = _unit((g[0].abs() + 1e-12, g[1].abs() + 1e-12, g[2].abs() + 1e-12))
            dirn, dst = _toward(tuple(lrad * rnd[c] + lpos[c] for c in range(3)), p)
            cos_t = _dot(dirn, nrm)
            s = cos_t * lmul * lrad * lrad * (4.0 * math.pi) / (dst * dst)
            segs.append((dirn, dst, cos_t > 0.0, tuple(s * lcol[c] for c in range(3))))
    for i in range(L.n_spot):
        dirn, dst = _toward(row(L.spot_pos, i), p)
        ldir, lcol, lcos = row(L.spot_dir, i), row(L.spot_color, i), L.spot_cos_angle[i]
        cos_t = _dot(dirn, ldir)
        alpha = 1.0 - (1.0 - cos_t) / (1.0 - lcos)
        s = cos_t / (dst * dst) * alpha
        segs.append((dirn, dst, cos_t > lcos, tuple(s * lcol[c] * alb[c] for c in range(3))))
    dirn = tuple((-L.dir_direction[i]).expand(n) for i in range(3))
    cos_d = _dot(dirn, nrm)
    segs.append((dirn, torch.full((n,), BIG, dtype=F32, device=cos_d.device),
                 (cos_d > 0.0) & (L.dir_color != 0.0).any(),
                 tuple(cos_d * L.dir_color[c] * alb[c] for c in range(3))))
    return segs


def _put_segments(b: Bounce, segs, mask, d, t, need, val):
    """Each segment's shadow ray and contribution into the segment-major
    buffers."""
    n = b.n
    for s, (dirn, dst, gate, v) in enumerate(segs):
        d[s * n:(s + 1) * n] = torch.stack(dirn, 1)
        t[s * n:(s + 1) * n] = dst
        need[s * n:(s + 1) * n] = mask & gate
        val[s] = torch.stack(v)


def _light_sum(b: Bounce, need, occ, val, alb):
    """integrator.illumination's result from the segments K2 answered."""
    lit = (need & ~occ).view(b.m, b.n)
    zero = torch.zeros_like(val[0, 0])
    if not b.det:
        return _where(lit[0], tuple(val[0]), (zero,) * 3)
    L, s, acc = b.lights, 0, (zero,) * 3

    def add(acc, s):
        return tuple(acc[c] + torch.where(lit[s], val[s, c], zero) for c in range(3))

    for _ in range(L.n_point):
        acc, s = add(acc, s), s + 1
    for _ in range(L.n_area):
        area = (zero,) * 3
        for _ in range(b.samples):
            area = _where(lit[s], tuple(area[c] + val[s, c] for c in range(3)), area)
            s += 1
        acc = tuple(acc[c] + (1.0 / b.samples) * area[c] * alb[c] for c in range(3))
    for _ in range(L.n_spot + 1):
        acc, s = add(acc, s), s + 1
    return acc


def nee_plain(b: Bounce) -> None:
    """``nee`` by torch ops."""
    pk, rec, dr = b.pk, b.rec, b.draws
    k = _classes(rec["mat"])
    act = pk[R_ACT] > 0.5
    t, nrm = rec["t"], (rec["nx"], rec["ny"], rec["nz"])
    o, d = _rows(pk, R_O), _rows(pk, R_D)
    march = b.march
    if b.exit is not None:
        in_vol, t_exit, *nrm_exit = b.exit
        t = torch.where(march, t_exit, t)
        nrm = _where(march & in_vol, tuple(nrm_exit), nrm)
        fell = march & ~in_vol
        o = _where(fell, (o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2]), o)
        t = torch.where(fell, 0.0, t)
        _put(pk, R_O, o)
        rec["t"].copy_(t)
        for i, c in enumerate(("nx", "ny", "nz")):
            rec[c].copy_(nrm[i])
    p = (o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2])
    alb = (b.mrow[:, 0], b.mrow[:, 1], b.mrow[:, 2])
    b.sh_o.copy_(torch.stack([mathx.offset_ray(p[i], nrm[i]) for i in range(3)], 1)
                 .repeat(b.m, 1))

    def segments_of(u, g, g_det):
        return _det_lights(b, g_det, p, nrm, alb) if b.det else _random_light(b, u, g, p, nrm,
                                                                                 alb)

    if b.has_lk:
        _put_segments(b, segments_of(dr.u_lk, dr.g_lk, dr.g_det_lk),
                      act & k["smoke"] & (rec["vol"] == 0), b.lk_d, b.lk_t, b.lk_need, b.lk_val)
    cos_in = torch.clamp(_dot((-d[0], -d[1], -d[2]), nrm), max=1.0)
    go_diffuse = dr.u_lobe > mathx.schlick_nonmetal(cos_in)
    nee_mask = act & ((k["nonmetal"] & go_diffuse) | k["model"])
    _put_segments(b, segments_of(dr.u_nee, dr.g_nee, dr.g_det), nee_mask, b.sh_d, b.sh_t,
                  b.need, b.nee_val)
    b.go_diffuse.copy_(act & go_diffuse)
    b.nee_mask.copy_(nee_mask)


def continue_plain(b: Bounce) -> None:
    """``continue_`` by torch ops."""
    pk, rec, dr, m = b.pk, b.rec, b.draws, b.mrow
    k = _classes(rec["mat"])
    act, in_glass = pk[R_ACT] > 0.5, pk[R_GL] > 0.5
    t, nrm = rec["t"], (rec["nx"], rec["ny"], rec["nz"])
    o, d, tp0, rad = _rows(pk, R_O), _rows(pk, R_D), _rows(pk, R_TP), _rows(pk, R_RAD)
    alb, rough, emis, ior = (m[:, 0], m[:, 1], m[:, 2]), m[:, 3], m[:, 4], m[:, 5]
    go_diffuse, nee_mask = b.go_diffuse, b.nee_mask

    inc = _light_sum(b, b.need, b.occ, b.nee_val, alb)
    rad = _where(nee_mask & k["nonmetal"], tuple(rad[i] + tp0[i] * inc[i] for i in range(3)),
                 rad)
    rad = _where(nee_mask & k["model"],
                 tuple(rad[i] + tp0[i] * (alb[i] * inc[i]) for i in range(3)), rad)
    if b.has_lk:
        lk = _light_sum(b, b.lk_need, b.lk_occ, b.lk_val, alb)
        in_light = (pk[R_LK] > 0.5) | (act & k["smoke"] & (rec["vol"] == 0)
                                       & (_dot(lk, lk) > b.kill_threshold))

    dn = _dot(d, nrm)
    refl = tuple(d[i] - (2.0 * dn) * nrm[i] for i in range(3))
    theta, phi = dr.u_sph[0] * TWO_PI, dr.u_sph[1] * math.pi
    sp = torch.sin(phi)
    sph = (dr.u_sph[2] * sp * torch.cos(theta), dr.u_sph[2] * sp * torch.sin(theta),
           dr.u_sph[2] * torch.cos(phi))
    spec = tuple(refl[i] + rough * sph[i] for i in range(3))
    diff = tuple(nrm[i] + sph[i] for i in range(3))
    mdl = _unit(tuple(dr.g_hemi[i] + 1e-12 for i in range(3)))
    flip = torch.where(_dot(mdl, nrm) < 0.0, -1.0, 1.0)
    mdl = tuple(flip * mdl[i] for i in range(3))

    ratio = torch.where(in_glass, ior, 1.0 / ior)
    cos_g = torch.clamp(_dot((-d[0], -d[1], -d[2]), nrm), max=1.0)
    sin_g = mathx.sqrt(torch.clamp(1.0 - cos_g * cos_g, min=0.0))
    do_reflect = (ratio * sin_g > 1.0) | (mathx.schlick(cos_g, ratio) > dr.u_f)
    rp = tuple(ratio * (d[i] + cos_g * nrm[i]) for i in range(3))
    rpar = -mathx.sqrt(torch.abs(1.0 - _dot(rp, rp)))
    glass_dir = _where(do_reflect, refl, tuple(rp[i] + rpar * nrm[i] for i in range(3)))
    glass_norm = _where(do_reflect, nrm, (-nrm[0], -nrm[1], -nrm[2]))
    glass_flip = act & k["glass"] & ~do_reflect

    intensity = torch.where(in_glass & k["smoke"], emis, 0.0)
    dist = torch.where(b.march, t, 0.0)
    thresh = dr.u_s[0] * 100.0 - intensity
    scatter = act & k["smoke"] & (dr.u_s[1] * dist > thresh)
    scat_t = t * 0.45 + dr.u_s[0] * (t - t * 0.45)
    o = _where(scatter, tuple(o[i] + scat_t * d[i] for i in range(3)), o)
    d = _where(scatter, _unit(tuple(dr.g_oct[i].abs() + 1e-12 for i in range(3))), d)
    t = torch.where(scatter, 0.0, t)
    p = tuple(o[i] + t * d[i] for i in range(3))
    trans = tuple(torch.exp(-dist * intensity * (1.0 - alb[i])) for i in range(3))

    new_d = _where(k["metal"], spec, d)
    new_d = _where(k["nonmetal"] & go_diffuse, diff, new_d)
    new_d = _where(k["nonmetal"] & ~go_diffuse, spec, new_d)
    new_d = _where(k["glass"], glass_dir, new_d)
    new_d = _unit(_where(k["model"], mdl, new_d))
    off_n = _where(k["glass"], glass_norm, nrm)
    off_n = _where(k["smoke"], (-nrm[0], -nrm[1], -nrm[2]), off_n)
    new_o = tuple(mathx.offset_ray(p[i], off_n[i]) for i in range(3))

    tp = _where(act & (k["metal"] | (k["nonmetal"] & go_diffuse) | k["model"]),
                tuple(tp0[i] * alb[i] for i in range(3)), tp0)
    one = torch.ones_like(t)
    tp = _where(act & k["glass"],
                tuple(tp0[i] * torch.where(in_glass, alb[i], one) for i in range(3)), tp)
    tp = _where(act & k["smoke"], tuple(tp0[i] * trans[i] for i in range(3)), tp)

    new_in_glass = torch.where(glass_flip | (act & k["smoke"]), ~in_glass, in_glass)
    new_active = act & ~k["emissive"]
    _put(pk, R_O, _where(new_active, new_o, o))
    _put(pk, R_D, _where(new_active, new_d, d))
    _put(pk, R_TP, tp)
    _put(pk, R_RAD, rad)
    pk[R_GL] = new_in_glass.to(F32)
    pk[R_ACT] = new_active.to(F32)
    b.out_in_glass.copy_(new_in_glass)
    b.out_active.copy_(new_active)
    if b.has_lk:
        pk[R_LK] = in_light.to(F32)
        b.out_in_light.copy_(in_light)


class Stages(NamedTuple):
    hit: object
    nee: object
    continue_: object


KERNELS = Stages(hit, nee, continue_)
PLAIN = Stages(hit_plain, nee_plain, continue_plain)
