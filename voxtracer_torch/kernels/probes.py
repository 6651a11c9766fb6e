"""Gather and ALU probes (counterpart of the three Pallas kernels of
scripts/probe_pallas.py), served on the card by csrc/probes.cu.

``lane_gather`` (P1), ``chain_gather`` (P3) and ``alu_loop`` (P4) take
their loop count ``iters`` as data, as the Pallas kernels took it from
scalar memory.  A CUDA tensor goes through the kernel; a CPU tensor
through the ``*_plain`` version, the script's loop body line for line in
int32 / f32 torch ops.  ``row_gather`` is the script's X1: the same kind
of iterated gather as PyTorch indexing over a [T, W] table, the yardstick
the gathers are read against; it is no kernel and has no wrapper.
``launches`` counts kernel launches per kernel.
"""

from __future__ import annotations

import torch

from voxtracer_torch.kernels import build

LANES = 128           # entries of one lane-table row
CHAIN_ENTRIES = 2048  # entries of the chain table: 16 blocks of 128

launches = {"lane_gather": 0, "chain_gather": 0, "alu_loop": 0}

_SCALE = torch.tensor(1.0000001, dtype=torch.float32)  # rounds to 1 + 2^-23
_HALF = torch.tensor(0.5, dtype=torch.float32)
_BIG = torch.tensor(1e9, dtype=torch.float32)


def lane_gather_plain(tab, idx, iters):
    """tab, idx [B, 128] i32 -> acc [B, 128] i32."""
    acc = torch.zeros_like(idx)
    for _ in range(iters):
        idx = (idx + acc) & (LANES - 1)
        acc = acc + torch.gather(tab, 1, idx.long())
    return acc


def chain_gather_plain(tab, idx, iters):
    """tab [16, 128] i32 (one table of 2048 entries), idx [B, 128] i32
    -> acc [B, 128] i32."""
    flat = tab.reshape(-1)
    acc = torch.zeros_like(idx)
    for _ in range(iters):
        idx = (idx + acc) & (CHAIN_ENTRIES - 1)
        acc = acc + flat[idx.long()]
    return acc


def alu_loop_plain(a, b, iters):
    """a [B, 128] i32, b [B, 128] f32 -> x + int(y) [B, 128] i32."""
    x, y = a, b
    scale, half, big = (c.to(b.device) for c in (_SCALE, _HALF, _BIG))
    for _ in range(iters):
        m = (x & 31) < 16
        y = torch.where(m, y * scale + half, y)
        x = torch.where(m, x + 1, x + 2)
        m2 = y < big
        x = torch.where(m2, x ^ (x >> 3), x)
        y = torch.where(m2, y, y * half)
    # toward zero, saturating at the int32 range as the kernel's
    # __float2int_rz does (f32 -> f64 is exact)
    return x + y.double().clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int32)


def row_gather(tab, idx, iters):
    """X1: tab [T, W] i32 (T a power of two, W >= 16), idx [n] i32;
    iters times ``rows = tab[(idx + acc) & (T - 1)]; acc += rows[:, 0] +
    rows[:, 15]`` -> acc [n] i32.  PyTorch indexing on any device."""
    acc = torch.zeros_like(idx)
    for _ in range(iters):
        rows = tab[((idx + acc) & (tab.shape[0] - 1)).long()]
        acc = acc + rows[:, 0] + rows[:, 15]
    return acc


def _require(name, x, dtype, shape, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _device(x, what):
    """The CUDA device of x; raise for any device but the CPU and CUDA."""
    if x.device.type != "cuda":
        raise ValueError(f"no {what} for device {x.device}")
    return x.device


def _iters(iters):
    if not 0 <= int(iters) < 2 ** 31:
        raise ValueError(f"iters {iters}: expected 0 <= iters < 2^31")
    return int(iters)


def _rows(idx):
    if idx.dim() != 2 or idx.shape[1] != LANES:
        raise ValueError(f"idx: expected [B, {LANES}], got {tuple(idx.shape)}")
    return idx.shape[0]


def lane_gather(tab, idx, iters):
    """P1: ``iters`` rounds of ``idx = (idx + acc) & 127; acc += tab[b, idx]``
    over tab, idx [B, 128] i32 -> acc [B, 128] i32."""
    if idx.device.type == "cpu":
        return lane_gather_plain(tab, idx, iters)
    dev = _device(idx, "lane gather")
    b = _rows(idx)
    _require("tab", tab, torch.int32, (b, LANES), dev)
    _require("idx", idx, torch.int32, (b, LANES), dev)
    out = torch.empty_like(idx)
    status = build.lib().vt_lane_gather(tab.data_ptr(), idx.data_ptr(), b, _iters(iters),
                                        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "lane_gather")
    launches["lane_gather"] += 1
    return out


def chain_gather(tab, idx, iters):
    """P3: ``iters`` rounds of ``idx = (idx + acc) & 2047; acc +=
    tab_flat[idx]`` over tab [16, 128] i32 and idx [B, 128] i32 -> acc."""
    if idx.device.type == "cpu":
        return chain_gather_plain(tab, idx, iters)
    dev = _device(idx, "chain gather")
    b = _rows(idx)
    _require("tab", tab, torch.int32, (CHAIN_ENTRIES // LANES, LANES), dev)
    _require("idx", idx, torch.int32, (b, LANES), dev)
    out = torch.empty_like(idx)
    status = build.lib().vt_chain_gather(tab.data_ptr(), idx.data_ptr(), b, _iters(iters),
                                         out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "chain_gather")
    launches["chain_gather"] += 1
    return out


def alu_loop(a, b, iters):
    """P4: ``iters`` rounds of the DDA-shaped int/f32 op mix over a [B, 128]
    i32 and b [B, 128] f32 -> x + int(y) [B, 128] i32."""
    if a.device.type == "cpu":
        return alu_loop_plain(a, b, iters)
    dev = _device(a, "ALU loop")
    rows = _rows(a)
    _require("a", a, torch.int32, (rows, LANES), dev)
    _require("b", b, torch.float32, (rows, LANES), dev)
    out = torch.empty_like(a)
    status = build.lib().vt_alu_loop(a.data_ptr(), b.data_ptr(), a.numel(), _iters(iters),
                                     out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "alu_loop")
    launches["alu_loop"] += 1
    return out
