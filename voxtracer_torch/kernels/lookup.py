"""Clipped row lookup ``tab[clip(idx, 0, K - 1)]`` over a small table
(counterpart of voxtracer/kernels/lookup.py), served on the card by the
shared-memory kernel of csrc/lookup.cu.  A CUDA tensor goes through the
kernel; a CPU tensor through ``lookup_rows_plain``."""

from __future__ import annotations

import torch

from voxtracer_torch.kernels import build

SMEM_LIMIT = 48 * 1024  # static shared-memory budget of one block
MAX_BLOCKS = 132 * 16   # grid-stride cap: 16 blocks per SM of an H100

launches = {"lookup_rows": 0}


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
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError("idx: expected a 1-D int32 tensor")
    if not (tab.is_contiguous() and idx.is_contiguous()):
        raise ValueError("tab and idx must be contiguous")
    k, c = tab.shape
    if k == 0 or k * c * 4 > SMEM_LIMIT:
        raise ValueError(f"table of {k}x{c} f32 does not fit one block's shared memory")
    n = idx.shape[0]
    out = torch.empty((n, c), dtype=torch.float32, device=dev)
    status = build.lib().vt_lookup_rows(
        tab.data_ptr(), k, c, idx.data_ptr(), n, out.data_ptr(), MAX_BLOCKS,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "lookup_rows")
    launches["lookup_rows"] += 1
    return out
