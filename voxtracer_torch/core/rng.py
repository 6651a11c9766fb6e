"""Random streams with explicit keys (counterpart of voxtracer/core/rng.py
and of the ``jax.random.fold_in`` key tree the integrator derives).

A key is a pair of uint32 words held as Python ints, ``(k0, k1)``, the
same two words as a raw ``jax.random.PRNGKey``.  Key derivation
(``fold_in``, threefry2x32), the per-stream seed and the words a draw
hands the generator are scalar host work.  Each draw is one call of
``kernels/rng.draw``: on a CUDA device one launch of csrc/rng.cu, which
makes each element's counter, runs the generator and writes the float32
result; on the CPU the ``*_plain`` version, torch ops on int64 tensors.
Every stream here equals the JAX package's bit for bit, and the kernel
equals the plain version bit for bit.  Each draw is one span of the program
(``vt.rng.hash``, ``vt.rng.threefry``; utils/profiling.span).

torch has no uint32 add or right shift on the CPU, so the plain versions
compute in int64 and mask with ``& 0xFFFFFFFF``.  Every product stays
below 2**63: each factor of a tensor product is below 2**32 and the
constants below 2**30.
"""

from __future__ import annotations

import math

import torch

from voxtracer_torch.core.mathx import sqrt
from voxtracer_torch.kernels import rng as kernel
from voxtracer_torch.utils.profiling import span

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_PRIME1 = 0x85EBCA6B


def make_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` for a non-negative 32-bit seed."""
    return ((seed >> 32) & M32, seed & M32)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def _threefry2x32(k0: int, k1: int, x0, x1) -> tuple:
    """Threefry-2x32, 20 rounds, on one pair of words: Python ints, or
    int64 tensors of uint32 values (the key words stay Python ints)."""
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


def counters(shape, device, lanes=None, axis: int = -1) -> torch.Tensor:
    """The int64 counter of each element of `shape`, flat in row-major
    order.  Without `lanes`: 0 .. prod(shape) - 1.  With lanes = (first,
    total): `shape` holds some of the `total` lanes along `axis` of a
    global array, and each element gets the counter it has in the global
    array (a rank of a sharded render draws its lanes of the global
    streams without drawing the rest).  first: an int, the lanes [first,
    first + shape[axis]) of a window; or an int64 tensor of shape[axis]
    global lane indices, in any order (the queue slots of a sharded
    whitted batch: a [3, W] draw gives slot s of row c the counter
    c * W + s)."""
    n = math.prod(shape)
    if lanes is None:
        return torch.arange(n, dtype=torch.int64, device=device)
    first, total = lanes
    axis %= len(shape)
    gshape = list(shape)
    gshape[axis] = total
    idx = torch.zeros((), dtype=torch.int64, device=device)
    for a, size in enumerate(shape):
        if a == axis and torch.is_tensor(first):
            c = first.to(device=device, dtype=torch.int64)
        else:
            c = torch.arange(size, dtype=torch.int64, device=device) + (first if a == axis else 0)
        view = [1] * len(shape)
        view[a] = size
        idx = idx + c.reshape(view) * math.prod(gshape[a + 1:])
    return idx.reshape(-1)


def _hash_words(key: tuple, salt: int) -> tuple:
    """(base, mix) of the hash stream `salt` under `key`."""
    base = _pcg(key_seed(key) ^ ((salt * _GOLDEN) & M32))
    return base, (base * _PRIME1) & M32


def hash_bits(key: tuple, salt: int, shape, device, lanes=None) -> torch.Tensor:
    """uint32 hash stream over (seed, salt, counter), as int64 values;
    the lanes of a window (``counters``) run along the last axis."""
    base, mix = _hash_words(key, salt)
    x = _pcg(counters(shape, device, lanes, -1) ^ base)
    return _pcg(x ^ mix).reshape(shape)


def hash_uniform_plain(key: tuple, salt: int, shape, device, lanes=None) -> torch.Tensor:
    """``hash_uniform`` by torch ops on int64 tensors: the CPU path and the kernel's
    plain version."""
    bits = hash_bits(key, salt, shape, device, lanes)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def hash_uniform(key: tuple, salt: int, shape, device, lanes=None) -> torch.Tensor:
    """f32 uniforms in [0, 1): the top 24 hash bits scaled."""
    with span("vt.rng.hash"):
        return kernel.draw(kernel.HASH, kernel.UNIFORM, _hash_words(key, salt), shape, device,
                           lanes, plain=lambda: hash_uniform_plain(key, salt, shape, device, lanes))


def hash_normal_plain(key: tuple, salt: int, shape, device, lanes=None) -> torch.Tensor:
    """``hash_normal`` by torch ops on int64 tensors: the CPU path and the kernel's
    plain version."""
    u1 = hash_uniform_plain(key, salt, shape, device, lanes)
    u2 = hash_uniform_plain(key, salt + 0x5D0, shape, device, lanes)
    r = sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))
    return r * torch.cos((2.0 * math.pi) * u2)


def hash_normal(key: tuple, salt: int, shape, device, lanes=None) -> torch.Tensor:
    """f32 standard normals by Box-Muller over two uniform streams."""
    with span("vt.rng.hash"):
        return kernel.draw(kernel.HASH, kernel.NORMAL,
                           _hash_words(key, salt) + _hash_words(key, salt + 0x5D0), shape, device,
                           lanes, plain=lambda: hash_normal_plain(key, salt, shape, device, lanes))


# --------------------------------------------------------------------------
# jax.random streams (threefry2x32 with jax_threefry_partitionable): the
# reproject pass draws from these directly, not through the hash.
# --------------------------------------------------------------------------

def threefry_bits(key: tuple, shape, device, lanes=None, axis: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values: element i
    of the row-major shape is ``y0 ^ y1`` of threefry2x32(key, (hi, lo))
    over the 64-bit counter i = hi * 2**32 + lo; the lanes of a window
    (``counters``) run along `axis`."""
    idx = counters(shape, device, lanes, axis)
    n = math.prod(shape) if lanes is None else math.prod(shape) // shape[axis] * lanes[1]
    hi = idx >> 32 if n > M32 else 0
    y0, y1 = _threefry2x32(key[0], key[1], hi, idx & M32)
    return (y0 ^ y1).reshape(shape)


def _unit_floats(bits):
    """uint32 bits -> f32 in [0, 1): the top 23 bits as the mantissa of a
    float in [1, 2), minus one (jax.random._uniform)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def threefry_uniform_plain(key: tuple, shape, device, lanes=None, axis: int = 0) -> torch.Tensor:
    """``threefry_uniform`` by torch ops on int64 tensors: the CPU path
    and the kernel's plain version."""
    return _unit_floats(threefry_bits(key, shape, device, lanes, axis))


def threefry_uniform(key: tuple, shape, device, lanes=None, axis: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)``, bit for bit; `lanes`
    and `axis` as in ``threefry_bits``."""
    with span("vt.rng.threefry"):
        return kernel.draw(kernel.THREEFRY, kernel.UNIFORM, key, shape, device, lanes, axis,
                           plain=lambda: threefry_uniform_plain(key, shape, device, lanes, axis))


# M. Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011),
# single precision, as XLA expands erf_inv: the w < 5 and w >= 5 branches
_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
              1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
              0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
              2.83297682)


def erf_inv(x):
    """f32 inverse error function, the polynomial XLA uses for
    ``lax.erf_inv``.  torch.erfinv rounds differently in the last bits."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, _ERFINV_LO[i], _ERFINV_HI[i]).to(x.dtype)

    p = coef(0)
    for i in range(1, len(_ERFINV_LO)):
        p = coef(i) + p * w
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


_NORMAL_LO = -0.99999994039535522  # nextafter(-1, 0) in float32


def threefry_normal_plain(key: tuple, shape, device, lanes=None, axis: int = 0) -> torch.Tensor:
    """``threefry_normal`` by torch ops on int64 tensors: the CPU path
    and the kernel's plain version."""
    u = _unit_floats(threefry_bits(key, shape, device, lanes, axis)) * 2.0 + _NORMAL_LO
    u = torch.clamp(u, min=_NORMAL_LO)
    return math.sqrt(2.0) * erf_inv(u)


def threefry_normal(key: tuple, shape, device, lanes=None, axis: int = 0) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: sqrt(2) * erf_inv(u) of
    a uniform u in (-1, 1).  The uniform is bit-equal; erf_inv is XLA's
    polynomial, which XLA evaluates with fused multiply-adds, so the
    normals agree to a few ulps (tests/test_torch_reproject.py).  `lanes`
    and `axis` as in ``threefry_bits``."""
    with span("vt.rng.threefry"):
        return kernel.draw(kernel.THREEFRY, kernel.NORMAL, key, shape, device, lanes, axis,
                           plain=lambda: threefry_normal_plain(key, shape, device, lanes, axis))
