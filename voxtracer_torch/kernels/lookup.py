"""Clipped row lookup ``tab[clip(idx, 0, K - 1)]`` over a small table and
its adjoint (counterpart of voxtracer/kernels/lookup.py and of the row
gathers' custom adjoints in voxtracer/diff/volumetric.py), served on the
card by the shared-memory kernels of csrc/lookup.cu.  A CUDA tensor goes
through the kernel; a CPU tensor through the ``*_plain`` version.
``LookupRows`` puts both under autograd."""

from __future__ import annotations

import torch

from voxtracer_torch.kernels import build

MAX_BLOCKS = 132 * 16     # forward grid-stride cap: 16 blocks per SM of an H100
BWD_MAX_BLOCKS = 132 * 4  # backward cap: each block flushes its own K x C copy

launches = {"lookup_rows": 0, "lookup_rows_bwd": 0}


def smem_limit(device: torch.device) -> int:
    """The most dynamic shared memory one block may take on `device`, in
    bytes (227 KB on an H100): the largest table the kernels hold."""
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def _check_table(k, c, device):
    if k == 0 or k * c * 4 > smem_limit(device):
        raise ValueError(f"table of {k}x{c} f32 does not fit one block's shared memory "
                         f"({smem_limit(device)} bytes)")


def _check_idx(idx, n=None):
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError("idx: expected a 1-D int32 tensor")
    if n is not None and idx.shape[0] != n:
        raise ValueError(f"idx: {idx.shape[0]} rows, expected {n}")
    if not idx.is_contiguous():
        raise ValueError("idx must be contiguous")


def lookup_rows_plain(tab, idx):
    """tab [K, C] f32, idx [N] int -> [N, C] f32."""
    return tab[torch.clamp(idx.long(), 0, tab.shape[0] - 1)]


def lookup_rows(tab, idx):
    """Row gather ``tab[clip(idx)]``: tab [K, C] f32, idx [N] i32 -> [N, C]."""
    if idx.device.type == "cpu":
        return lookup_rows_plain(tab, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"no lookup for device {idx.device}")
    dev = idx.device
    if tab.device != dev or tab.dtype != torch.float32 or tab.dim() != 2:
        raise ValueError("tab: expected a 2-D float32 tensor on the index's device")
    _check_idx(idx)
    if not tab.is_contiguous():
        raise ValueError("tab must be contiguous")
    k, c = tab.shape
    _check_table(k, c, dev)
    n = idx.shape[0]
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    status = build.lib().vt_lookup_rows(
        tab.data_ptr(), k, c, idx.data_ptr(), n, out.data_ptr(), MAX_BLOCKS,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "lookup_rows")
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


def lookup_rows_bwd(ct, idx, k):
    """The table cotangent of ``lookup_rows``: ct [N, C] f32, idx [N] i32
    -> [K, C] f32, summed with atomics (no fixed order)."""
    if ct.device.type == "cpu":
        return lookup_rows_bwd_plain(ct, idx, k)
    if ct.device.type != "cuda":
        raise ValueError(f"no lookup backward for device {ct.device}")
    dev = ct.device
    if ct.dtype != torch.float32 or ct.dim() != 2 or not ct.is_contiguous():
        raise ValueError("ct: expected a contiguous 2-D float32 tensor")
    if idx.device != dev:
        raise ValueError(f"idx: on {idx.device}, expected {dev}")
    n, c = ct.shape
    _check_idx(idx, n)
    _check_table(k, c, dev)
    out = torch.zeros((k, c), dtype=torch.float32, device=dev)
    status = build.lib().vt_lookup_rows_bwd(
        ct.data_ptr(), n, c, idx.data_ptr(), k, out.data_ptr(), BWD_MAX_BLOCKS,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "lookup_rows_bwd")
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
