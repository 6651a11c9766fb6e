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
