"""Shared numerics in torch (counterpart of voxtracer/core/mathx.py).

The reference's fast approximations and self-intersection offset
(tmpl8math.cpp:405-487), written so each elementwise step rounds as the
JAX version's does: sums of three products are spelled out left to right,
and integer powers are the binary-exponentiation products of
``lax.integer_pow``.
"""

from __future__ import annotations

import math

import torch

INV_PI = 1.0 / math.pi
INV_2PI = 1.0 / (2.0 * math.pi)


def sqrt(x):
    """Correctly rounded float32 square root, as IEEE and XLA give it.
    torch's vectorised CPU kernel is one ulp off on about 0.6% of inputs,
    so on the CPU the root is taken in float64 and rounded once (exact for
    a square root); CUDA's sqrtf is already correctly rounded."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def dot3(a, b):
    """Sum over the last axis of size 3, in the order x, y, z."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(v):
    return v / sqrt(dot3(v, v))[..., None]


def reflect(d, n):
    """Mirror reflection of [N, 3] directions (renderer.cpp:913-916)."""
    return d - 2.0 * n * dot3(d, n)[..., None]


def refract(d, n, ior_ratio):
    """Snell refraction of [N, 3] directions, 'Ray Tracing in One Weekend'
    form (renderer.cpp:919-925); ior_ratio [N]."""
    cos_theta = torch.clamp(dot3(-d, n), max=1.0)[..., None]
    r_perp = ior_ratio[..., None] * (d + cos_theta * n)
    r_par = -sqrt(torch.abs(1.0 - dot3(r_perp, r_perp)))[..., None] * n
    return r_perp + r_par


def absorption(color, intensity, distance):
    """Beer-Lambert with the combined density term (renderer.cpp:1596-1608);
    the reference replaces the colour with the transmittance."""
    return torch.exp(-distance[..., None] * intensity[..., None] * (1.0 - color))


def pow5(x):
    """x ** 5 as lax.integer_pow computes it: x * (x * x) ** 2."""
    x2 = x * x
    return x * (x2 * x2)


def schlick(cosine, ior):
    """Fresnel Schlick for dielectrics (renderer.cpp:1588-1594)."""
    q = (1.0 - ior) / (1.0 + ior)
    r0 = q * q
    return r0 + (1.0 - r0) * pow5(1.0 - cosine)


def schlick_nonmetal(cosine):
    """Fixed r0 = 0.04 Schlick of the diffuse/specular split
    (renderer.cpp:1611-1616)."""
    r0 = 0.04
    return r0 + (1.0 - r0) * pow5(1.0 - cosine)


def atan2_fast(y, x):
    """Polynomial atan2 approximation (tmpl8math.cpp:405-426)."""
    abs_y = y.abs() + 1e-10
    neg_x = x < 0.0
    r = torch.where(neg_x, (x + abs_y) / (abs_y - x), (x - abs_y) / (x + abs_y))
    angle = torch.where(neg_x, torch.full_like(r, 3.0 * math.pi / 4.0),
                        torch.full_like(r, math.pi / 4.0))
    angle = angle + (0.1963 * r * r - 0.9817) * r
    return torch.where(y < 0.0, -angle, angle)


def acos_fast(x):
    """Polynomial acos approximation (tmpl8math.cpp:429-443)."""
    negate = (x < 0.0).to(x.dtype)
    xa = x.abs()
    ret = -0.0187293 * xa
    ret = ret + 0.0742610
    ret = ret * xa - 0.2121144
    ret = ret * xa + 1.5707288
    ret = ret * sqrt(torch.clamp(1.0 - xa, min=0.0))
    ret = ret - 2.0 * negate * ret
    return negate * 3.14159265358979 + ret


def offset_ray(p, n):
    """Self-intersection-safe ray origin by an integer ULP nudge
    ('Ray Tracing Gems' ch. 6; tmpl8math.cpp:445-487), bit for bit."""
    p = p.to(torch.float32)
    of_i = (256.0 * n).to(torch.int32)
    p_bits = p.contiguous().view(torch.int32)
    p_i = (p_bits + torch.where(p < 0.0, -of_i, of_i)).view(torch.float32)
    return torch.where(p.abs() < 1.0 / 32.0, p + (1.0 / 65536.0) * n, p_i)


def luminance(color):
    """Rec.709 luma (renderer.cpp:2237-2240)."""
    return color[..., 0] * 0.2126 + color[..., 1] * 0.7152 + color[..., 2] * 0.0722


def reinhard_jodie(color):
    """Luminance-lerped Reinhard tonemap (renderer.cpp:2222-2234)."""
    lum = luminance(color)[..., None]
    tc = color / (1.0 + color)
    tl = color / (1.0 + lum)
    return tl + tc * (tc - tl)


_CHROMA_BIAS = 0.5 * 256.0 / 255.0


def rgb_to_ycocg(rgb):
    """[..., 3] RGB -> YCoCg (renderer.cpp:833-839)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = (r * 1.0 + g * 2.0 + b * 1.0) * 0.25
    co = (r * 2.0 + g * 0.0 + b * -2.0) * 0.25 + _CHROMA_BIAS
    cg = (r * -1.0 + g * 2.0 + b * -1.0) * 0.25 + _CHROMA_BIAS
    return torch.stack([y, co, cg], dim=-1)


def ycocg_to_rgb(ycocg):
    """[..., 3] YCoCg -> RGB (renderer.cpp:841-851)."""
    y = ycocg[..., 0]
    co = ycocg[..., 1] - _CHROMA_BIAS
    cg = ycocg[..., 2] - _CHROMA_BIAS
    return torch.stack([y + co - cg, y + cg, y - co - cg], dim=-1)
