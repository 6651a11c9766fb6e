"""Clipped row lookup ``tab[clip(idx, 0, K - 1)]`` over a small table and
its adjoint (counterpart of voxtracer/kernels/lookup.py and of the row
gathers' custom adjoints in voxtracer/diff/volumetric.py), served on the
card by the kernels of csrc/lookup.cu.  A CUDA tensor goes through the
kernel; a CPU tensor through the ``*_plain`` version.  ``LookupRows`` puts
both under autograd.  ``fwd_blocks`` and ``bwd_plan`` size the grids and
pick the backward's accumulator from the shapes and the SM count alone, so
the CPU tests reach them."""

from __future__ import annotations

import functools

import torch

from voxtracer_torch.kernels import build

THREADS = 256            # threads a block (csrc/lookup.cu kThreads)
SLAB_ROWS = 128          # rows a warp takes a step (kSlab: 4 a lane)
FWD_BLOCKS_PER_SM = 4    # forward: the persistent grid (its launch bounds)
BWD_BLOCKS_PER_SM = 4    # backward: the persistent grid
PRIV_MAX_BYTES = 48 * 1024  # the most shared memory a block's private copies take

launches = {"lookup_rows": 0, "lookup_rows_bwd": 0}


@functools.cache
def device_consts(index: int) -> tuple[int, int]:
    """(SM count, dynamic shared-memory opt-in in bytes) of CUDA device
    `index`, read once; the first call also lets every lookup kernel take
    that much shared memory there."""
    props = torch.cuda.get_device_properties(index)
    with torch.cuda.device(index):
        build.check(build.lib().vt_lookup_init(props.shared_memory_per_block_optin),
                    "lookup_init")
    return props.multi_processor_count, props.shared_memory_per_block_optin


def smem_limit(device: torch.device) -> int:
    """The most dynamic shared memory one block may take on `device`, in
    bytes (227 KB on an H100)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    return device_consts(index)[1]


def fwd_blocks(n: int, sms: int) -> int:
    """The forward's grid for n rows: one 128-row slab per warp, at most
    FWD_BLOCKS_PER_SM blocks an SM (each warp then walks several slabs)."""
    warps = -(-n // SLAB_ROWS)
    return max(1, min(-(-warps // (THREADS // 32)), sms * FWD_BLOCKS_PER_SM))


def bwd_plan(n: int, k: int, c: int, sms: int) -> tuple[str, int]:
    """The backward's accumulator and grid for n cotangent rows of width c
    into a [k, c] table -> ("shared" or "direct", blocks).  Each warp
    privatises a k x c copy only where a block's 8 copies fit
    PRIV_MAX_BYTES and each block's share of the rows is at least k (many
    rows per entry: the albedo rows); otherwise the group sums go to one
    accumulator of doubles in device memory (few rows per entry as a rule:
    the brick-sigma rows; doubles, because the shapes cannot promise it)."""
    blocks = max(1, min(-(-n // (SLAB_ROWS * THREADS // 32)), sms * BWD_BLOCKS_PER_SM))
    shared = 4 * k * c * THREADS // 32 <= PRIV_MAX_BYTES and n >= k * blocks
    return ("shared" if shared else "direct"), blocks


def lookup_rows_plain(tab, idx):
    """tab [K, C] f32, idx [N] int -> [N, C] f32."""
    return tab[torch.clamp(idx.long(), 0, tab.shape[0] - 1)]


def lookup_rows(tab, idx):
    """Row gather ``tab[clip(idx)]``: tab [K, C] f32, idx [N] i32 -> [N, C]."""
    if not idx.is_cuda:
        if idx.is_cpu:
            return lookup_rows_plain(tab, idx)
        raise ValueError(f"no lookup for device {idx.device}")
    index = idx.get_device()  # the checks read cheap attributes: they run every call
    if tab.dtype != torch.float32 or tab.dim() != 2 or not tab.is_contiguous() \
            or tab.get_device() != index:
        raise ValueError("tab: expected a contiguous 2-D float32 tensor on the index's device")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError("idx: expected a contiguous 1-D int32 tensor")
    k, c = tab.shape
    if k == 0 or c == 0 or k * c >= 2 ** 31:
        raise ValueError(f"tab: cannot look up rows of a {k}x{c} table")
    sms, limit = device_consts(index)
    if 4 * c * SLAB_ROWS * THREADS // 32 > limit:  # the output slabs of a block
        raise ValueError(f"rows of {c} floats need more than the device's {limit} bytes of "
                         f"shared memory a block")
    n = idx.shape[0]
    out = torch.empty((n, c), dtype=torch.float32, device=idx.device)
    build.check(build.lib().vt_lookup_rows(
        tab.data_ptr(), k, c, idx.data_ptr(), n, out.data_ptr(), fwd_blocks(n, sms),
        # the current stream as an int, without building a Stream object
        torch._C._cuda_getCurrentRawStream(index)), "lookup_rows")
    launches["lookup_rows"] += 1
    return out


def lookup_rows_bwd_plain(ct, idx, k):
    """ct [N, C] f32, idx [N] int -> d_tab [K, C] f32 with
    ``d_tab[clip(idx[i])] += ct[i]``, summed in float64 and rounded once.
    An f32 index_add_ adds an entry's rows one after another into the
    growing sum; with tens of thousands of near-equal rows on one entry
    (the march's floor albedo row) that drifts by about 1e-4 relative."""
    acc = torch.zeros((k, ct.shape[1]), dtype=torch.float64, device=ct.device)
    return acc.index_add_(0, torch.clamp(idx.long(), 0, k - 1), ct.double()).to(ct.dtype)


def lookup_rows_bwd(ct, idx, k, acc=None):
    """The table cotangent of ``lookup_rows``: ct [N, C] f32, idx [N] i32
    -> [K, C] f32, summed with atomics (no fixed order).  `acc` forces the
    accumulator ("shared": warp copies in f32; "direct": one global one in
    f64, rounded once; default: ``bwd_plan``'s)."""
    if not ct.is_cuda:
        if ct.is_cpu:
            return lookup_rows_bwd_plain(ct, idx, k)
        raise ValueError(f"no lookup backward for device {ct.device}")
    index = ct.get_device()
    if ct.dtype != torch.float32 or ct.dim() != 2 or not ct.is_contiguous():
        raise ValueError("ct: expected a contiguous 2-D float32 tensor")
    n, c = ct.shape
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous() \
            or idx.shape[0] != n or idx.get_device() != index:
        raise ValueError(f"idx: expected a contiguous 1-D int32 tensor of {n} rows on {ct.device}")
    if k <= 0 or c == 0 or k * c >= 2 ** 31:
        raise ValueError(f"cannot sum rows into a {k}x{c} table")
    sms, limit = device_consts(index)
    plan, blocks = bwd_plan(n, k, c, sms)
    acc = acc or plan
    if acc != "shared" and acc != "direct":
        raise ValueError(f"acc: {acc!r}, expected 'shared' or 'direct'")
    if acc == "shared" and 4 * k * c * THREADS // 32 > limit:
        raise ValueError(f"{THREADS // 32} copies of a {k}x{c} accumulator need more than the "
                         f"device's {limit} bytes of shared memory a block")
    out = torch.empty((k, c), dtype=torch.float32, device=ct.device)
    # direct: the kernel sums into k * c doubles (and counts its finished
    # blocks in one more) and rounds them to `out` at its end
    scratch = None if acc == "shared" else torch.empty(k * c + 1, dtype=torch.float64,
                                                       device=ct.device)
    build.check(build.lib().vt_lookup_rows_bwd(
        ct.data_ptr(), n, c, idx.data_ptr(), k, out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), blocks,
        torch._C._cuda_getCurrentRawStream(index)), "lookup_rows_bwd")
    launches["lookup_rows_bwd"] += 1
    return out


class LookupRows(torch.autograd.Function):
    """``lookup_rows`` under autograd: the table's gradient is
    ``lookup_rows_bwd``; the indices take none."""

    @staticmethod
    def forward(ctx, tab, idx):
        ctx.save_for_backward(idx)
        ctx.k = tab.shape[0]
        return lookup_rows(tab, idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return lookup_rows_bwd(ct.contiguous(), idx, ctx.k), None
