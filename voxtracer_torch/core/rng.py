"""Random streams with explicit keys (counterpart of voxtracer/core/rng.py
and of the ``jax.random.fold_in`` key tree the integrator derives).

A key is a pair of uint32 words held as Python ints, ``(k0, k1)``, the
same two words as a raw ``jax.random.PRNGKey``.  Key derivation
(``fold_in``, threefry2x32) and the per-stream seed are scalar host work;
only the per-element PCG hash runs on tensors.  Every stream here equals
the JAX package's bit for bit.

torch has no uint32 add or right shift on the CPU, so the hash computes in
int64 and masks with ``& 0xFFFFFFFF``.  Every product stays below 2**63:
each factor of a tensor product is below 2**32 and the constants below
2**30.
"""

from __future__ import annotations

import math

import torch

from voxtracer_torch.core.mathx import sqrt

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_PRIME1 = 0x85EBCA6B


def make_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` for a non-negative 32-bit seed."""
    return ((seed >> 32) & M32, seed & M32)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def _threefry2x32(k0: int, k1: int, x0: int, x1: int) -> tuple:
    """Threefry-2x32, 20 rounds, on one pair of words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def fold_in(key: tuple, data: int) -> tuple:
    """``jax.random.fold_in(key, data)`` for a raw threefry key."""
    return _threefry2x32(key[0], key[1], 0, int(data) & M32)


def _pcg(x):
    """PCG-RXS-M-XS output permutation of uint32 values held in an int64
    tensor or a Python int (O'Neill 2014)."""
    x = (x * 747796405 + 2891336453) & M32
    x = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & M32
    return (x >> 22) ^ x


def key_seed(key: tuple) -> int:
    """Collapse a key to one uint32 seed (core/rng.py key_seed)."""
    s = _pcg(key[0])
    return _pcg(s ^ key[1])


def hash_bits(key: tuple, salt: int, shape, device) -> torch.Tensor:
    """uint32 hash stream over (seed, salt, counter), as int64 values."""
    n = math.prod(shape)
    base = _pcg(key_seed(key) ^ ((salt * _GOLDEN) & M32))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    x = _pcg(idx ^ base)
    return _pcg(x ^ ((base * _PRIME1) & M32)).reshape(shape)


def hash_uniform(key: tuple, salt: int, shape, device) -> torch.Tensor:
    """f32 uniforms in [0, 1): the top 24 hash bits scaled."""
    bits = hash_bits(key, salt, shape, device)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def hash_normal(key: tuple, salt: int, shape, device) -> torch.Tensor:
    """f32 standard normals by Box-Muller over two uniform streams."""
    u1 = hash_uniform(key, salt, shape, device)
    u2 = hash_uniform(key, salt + 0x5D0, shape, device)
    r = sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))
    return r * torch.cos((2.0 * math.pi) * u2)
