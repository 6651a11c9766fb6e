"""The random streams of ``core/rng.py`` on the card: one launch of
csrc/rng.cu a draw.  ``draw`` takes a CUDA device to the kernel and the
CPU to the draw's plain version (``core.rng.*_plain``, torch ops on int64
tensors), and refuses any other device.  ``counter_map`` turns a draw's
shape, lanes and lane axis into the affine map from an element's flat
index to its counter that the kernel evaluates (``core.rng.counters`` is
its plain version), so the CPU tests reach it.  The words of the key (the
hash's base and mix, threefry's folded key) come from the caller,
computed on the host."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from voxtracer_torch.kernels import build

HASH, THREEFRY = 0, 1   # the generator (csrc/rng.cu Gen)
UNIFORM, NORMAL = 0, 1  # the output (Out)

launches = {"rng_hash": 0, "rng_threefry": 0}
_NAMES = ("rng_hash", "rng_threefry")


class CounterMap(NamedTuple):
    """Element i of the draw, in row r = i // blk at q = i - r * blk, has
    the counter r * row_stride + off + q; with a lane list, r * row_stride
    + lanes[q // inner] * inner + q % inner (csrc/rng.cu CounterMap)."""
    blk: int         # elements of a row: shape[axis] * inner
    inner: int       # elements after the lane axis
    row_stride: int  # counters of a row in the global array: total * inner
    off: int         # first * inner (0 with a lane list)
    lanes: object    # None, or the int64 tensor of shape[axis] global lane indices


def counter_map(shape, lanes=None, axis: int = -1) -> CounterMap:
    """The counters ``core.rng.counters(shape, device, lanes, axis)``
    gives, as an affine map: without `lanes` every element's own index;
    with lanes = (first, total) a window [first, first + shape[axis]) of
    `total` lanes along `axis` (first an int), or a list of shape[axis]
    global lane indices (first an int64 tensor)."""
    if lanes is None:
        n = math.prod(shape)
        return CounterMap(n, 1, n, 0, None)
    first, total = lanes
    axis %= len(shape)
    inner = math.prod(shape[axis + 1:])
    if torch.is_tensor(first):
        return CounterMap(shape[axis] * inner, inner, total * inner, 0, first)
    return CounterMap(shape[axis] * inner, inner, total * inner, first * inner, None)


def draw(gen: int, kind: int, words: tuple, shape, device, lanes=None, axis: int = -1,
         plain=None) -> torch.Tensor:
    """A float32 draw of `shape` on `device`: generator `gen` (HASH,
    THREEFRY), output `kind` (UNIFORM, NORMAL), under the key's words (hash:
    base and mix of the stream, then of the normal's second stream;
    threefry: k0, k1), at the counters of ``counter_map(shape, lanes,
    axis)``.  On the CPU ``plain()``, the same draw by torch ops."""
    where = torch.device(device).type
    if where != "cuda":
        if where == "cpu":
            return plain()
        raise ValueError(f"no random streams for device {device}")
    n = math.prod(shape)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if n == 0:
        return out
    if n >= 2 ** 31:
        raise ValueError(f"a draw of {n} elements: the kernel takes fewer than 2**31")
    m = counter_map(shape, lanes, axis)
    lane_ids = m.lanes
    if lane_ids is not None:
        lane_ids = lane_ids.to(device=device, dtype=torch.int64).contiguous()
        if lane_ids.dim() != 1 or lane_ids.shape[0] != m.blk // m.inner:
            raise ValueError(f"lanes: expected {m.blk // m.inner} lane indices, got "
                             f"{tuple(lane_ids.shape)}")
    index = out.get_device()
    w = tuple(words) + (0,) * (4 - len(words))
    build.check(build.lib().vt_rng(
        gen, kind, out.data_ptr(), n, m.blk, m.inner, m.row_stride, m.off,
        None if lane_ids is None else lane_ids.data_ptr(), *w,
        torch._C._cuda_getCurrentRawStream(index)), "rng")
    launches[_NAMES[gen]] += 1
    return out
