"""Row lookup ``tab[clip(idx, 0, K - 1)]`` and its adjoint in plain
torch: the reference's K4 and K4-bwd."""

from __future__ import annotations

import torch


def lookup_rows(tab, idx):
    """tab [K, C] f32, idx [N] int -> [N, C] f32."""
    return tab[torch.clamp(idx.long(), 0, tab.shape[0] - 1)]


def lookup_rows_bwd(ct, idx, k):
    """ct [N, C] f32, idx [N] int -> d_tab [K, C] f32 with
    ``d_tab[clip(idx[i])] += ct[i]``: the rows sorted by entry and each
    entry's rows summed in float64 (a difference of running sums), rounded
    once; no atomics, so the order is fixed."""
    c = ct.shape[1]
    key = torch.clamp(idx.long(), 0, k - 1)
    order = torch.argsort(key, stable=True)
    ks = key[order]
    run = torch.cumsum(ct[order].double(), 0)
    counts = torch.bincount(ks, minlength=k)
    ends = torch.cumsum(counts, 0) - 1
    has = counts > 0
    at_end = torch.where(has[:, None], run[ends.clamp(min=0)], 0.0)
    before = torch.cat([torch.zeros((1, c), dtype=torch.float64, device=ct.device),
                        at_end], 0)
    # the running sum just before each entry's first row: the last
    # non-empty entry's end before it
    last = torch.cummax(torch.where(has, torch.arange(k, device=ct.device), -1), 0).values
    prev = torch.cat([torch.full((1,), -1, dtype=torch.long, device=ct.device), last[:-1]])
    sums = at_end - before[prev + 1]
    return torch.where(has[:, None], sums, 0.0).to(ct.dtype)


class LookupRows(torch.autograd.Function):
    """``lookup_rows`` under autograd; the table's gradient is
    ``lookup_rows_bwd``, the indices take none."""

    @staticmethod
    def forward(ctx, tab, idx):
        ctx.save_for_backward(idx)
        ctx.k = tab.shape[0]
        return lookup_rows(tab, idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return lookup_rows_bwd(ct.contiguous(), idx, ctx.k), None
