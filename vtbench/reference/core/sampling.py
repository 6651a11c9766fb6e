"""Direction samplers over pre-drawn uniforms or normals (counterpart of
voxtracer/core/sampling.py).  Where the reference rejection-samples, the
sampler here has the same distribution without rejection, as the JAX
package's does; the formulas are the JAX package's, in [..., 3] form."""

from __future__ import annotations

import math

import torch

from vtbench.reference.core.mathx import dot3, normalize, sqrt

TWO_PI = 2.0 * math.pi


def sphere_sample(u):
    """RandomSphereSample (tmpl8math.h:2502-2511): spherical coordinates
    with a random radius, deliberately non-uniform.  u: [..., 3]."""
    theta = u[..., 0] * TWO_PI
    phi = u[..., 1] * math.pi
    r = u[..., 2]
    sp = torch.sin(phi)
    return torch.stack([r * sp * torch.cos(theta), r * sp * torch.sin(theta),
                        r * torch.cos(phi)], dim=-1)


def lambertian_dir(normal, u):
    """RandomLambertianReflectionVector = N + RandomSphereSample()
    (tmpl8math.h:2513-2516), not normalised."""
    return normal + sphere_sample(u)


def positive_octant_dir(gauss):
    """RandomDirection (tmpl8math.cpp:76-93): a positive-octant unit vector,
    as |gaussian| normalised.  gauss: [..., 3] standard normals."""
    return normalize(torch.abs(gauss) + 1e-12)


def uniform_hemisphere_dir(normal, gauss):
    """DiffuseReflection (tmpl8math.h:2517-2527): a uniform sphere
    direction flipped into the normal's hemisphere."""
    d = normalize(gauss + 1e-12)
    flip = torch.where(dot3(d, normal) < 0.0, -1.0, 1.0)
    return d * flip[..., None]


def point_in_circle(u):
    """RandomPointInCircle (tmpl8math.cpp:119-124).  u: [..., 2] -> [..., 2]."""
    r = sqrt(u[..., 0])
    theta = TWO_PI * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
