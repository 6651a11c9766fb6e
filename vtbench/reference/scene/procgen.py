"""Procedural volume generation (counterpart of voxtracer/scene/procgen.py).

Reference: Scene::GenerateSomeNoise / GenerateSomeSmoke /
CreateEmmisiveSphere (scene.cpp:226-356, 685-711) built on FastNoise2
Perlin.  Here: a classic seeded 3D gradient-noise (Perlin) in vectorized
NumPy — equivalent statistics, not bit-identical to FastNoise2 (documented
deviation) — with the reference's exact threshold tables, including the
dead `n < 0.17` branch (scene.cpp:262-265) which we preserve as a comment,
not as code, since it is unreachable.
"""

from __future__ import annotations

import numpy as np

from vtbench.reference.core.types import (
    EMISSIVE,
    GLASS,
    MAT_NONE,
    METAL_HIGH,
    METAL_LOW,
    METAL_MID,
    NON_METAL_RED,
    SMOKE_HIGH_DENSITY,
    SMOKE_LOW2_DENSITY,
    SMOKE_LOW_DENSITY,
    SMOKE_MID2_DENSITY,
    SMOKE_MID_DENSITY,
)


def _perm(rng: np.random.Generator) -> np.ndarray:
    p = rng.permutation(256).astype(np.int32)
    return np.concatenate([p, p])


_GRADS = np.array(
    [[1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
     [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
     [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
     [1, 1, 0], [0, -1, 1], [-1, 1, 0], [0, -1, -1]], np.float32)


def perlin3(shape, frequency: float, seed: int = 0) -> np.ndarray:
    """Classic Perlin gradient noise on a lattice; output roughly [-1, 1]."""
    rng = np.random.default_rng(seed)
    perm = _perm(rng)
    gx, gy, gz = shape
    coords = np.stack(np.meshgrid(
        np.arange(gx, dtype=np.float32),
        np.arange(gy, dtype=np.float32),
        np.arange(gz, dtype=np.float32), indexing="ij"), axis=-1)
    p = coords * frequency * 16.0  # scale so small freqs still vary per cell
    pi = np.floor(p).astype(np.int32)
    pf = p - pi

    def grad_dot(ox, oy, oz):
        h = perm[perm[perm[(pi[..., 0] + ox) & 255] + ((pi[..., 1] + oy) & 255)]
                 + ((pi[..., 2] + oz) & 255)] & 15
        g = _GRADS[h]
        d = pf - np.array([ox, oy, oz], np.float32)
        return (g * d).sum(-1)

    def fade(t):
        return t * t * t * (t * (t * 6 - 15) + 10)

    u, v, w = fade(pf[..., 0]), fade(pf[..., 1]), fade(pf[..., 2])

    def lerp(a, b, t):
        return a + t * (b - a)

    x00 = lerp(grad_dot(0, 0, 0), grad_dot(1, 0, 0), u)
    x10 = lerp(grad_dot(0, 1, 0), grad_dot(1, 1, 0), u)
    x01 = lerp(grad_dot(0, 0, 1), grad_dot(1, 0, 1), u)
    x11 = lerp(grad_dot(0, 1, 1), grad_dot(1, 1, 1), u)
    y0 = lerp(x00, x10, v)
    y1 = lerp(x01, x11, v)
    return lerp(y0, y1, w).astype(np.float32)


def generate_noise_grid(gridsize: int, frequency: float = 0.03,
                        seed: int = 0) -> np.ndarray:
    """GenerateSomeNoise (scene.cpp:226-282): threshold table verbatim
    (the n<0.17 white branch is dead — shadowed by n<0.2)."""
    rng = np.random.default_rng(seed)
    n = perlin3((gridsize,) * 3, frequency, seed)
    out = np.full(n.shape, MAT_NONE, np.uint8)
    rand_mat = rng.integers(0, GLASS, size=n.shape).astype(np.uint8)
    out = np.where(n <= 0.04, MAT_NONE, out)
    band = (n > 0.04) & (n < 0.08)
    out = np.where(band, rand_mat, out)
    out = np.where((n >= 0.08) & (n < 0.2), NON_METAL_RED, out)
    out = np.where((n >= 0.2) & (n < 0.3), EMISSIVE, out)
    out = np.where((n >= 0.3) & (n < 0.5), METAL_HIGH, out)
    out = np.where((n >= 0.5) & (n < 0.7), METAL_MID, out)
    out = np.where((n >= 0.7) & (n < 0.9), METAL_LOW, out)
    return out


def generate_smoke_grid(gridsize: int, frequency: float = 0.167,
                        seed: int = 0) -> np.ndarray:
    """GenerateSomeSmoke (scene.cpp:285-356): ellipsoid falloff with the
    reference's *per-voxel random* ellipsoid dimensions quirk, density
    bands verbatim."""
    rng = np.random.default_rng(seed)
    g = gridsize
    n = perlin3((g,) * 3, frequency, seed)
    coords = np.stack(np.meshgrid(*([np.arange(g, dtype=np.float32)] * 3),
                                  indexing="ij"), axis=-1)
    center = g / 2.0
    rand_x = g / 2.0 + rng.uniform(-g / 4.0, g / 2.0, size=n.shape).astype(np.float32)
    rand_z = g / 2.0 + rng.uniform(-g / 4.0, g / 2.0, size=n.shape).astype(np.float32)
    dims = np.stack([rand_x, np.full_like(rand_x, g / 3.0), rand_z], axis=-1)
    dist = (coords - center) / dims
    d2 = (dist * dist).sum(-1)

    out = np.full(n.shape, MAT_NONE, np.uint8)
    out = np.where(n < 1.0, SMOKE_LOW_DENSITY, out)
    out = np.where(n < 0.7, SMOKE_LOW2_DENSITY, out)
    out = np.where(n < 0.6, SMOKE_MID_DENSITY, out)
    out = np.where(n < 0.4, SMOKE_MID2_DENSITY, out)
    out = np.where(n < 0.3, SMOKE_HIGH_DENSITY, out)
    out = np.where((n - d2 < 0.04) | (d2 > 1.5), MAT_NONE, out)
    return out
