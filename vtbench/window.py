"""The window's arithmetic: a rate is all the work over the whole window,
a tail is over every iteration of it."""

from __future__ import annotations

import math


def rate(work_per_iter: float, iters: int, window_s: float) -> float:
    """Work a second over the window: every completed iteration's work
    divided by the window's seconds (from its start to the end of its last
    iteration)."""
    if window_s <= 0:
        raise ValueError("an empty window")
    return work_per_iter * iters / window_s


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value, linear between the two
    nearest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def shape(times) -> str:
    """Where a window's time went, for the log: the iterations'
    percentiles and the mean of each quarter of the window, in ms."""
    q = "/".join(f"{percentile(times, p) * 1e3:.1f}" for p in (5, 25, 50, 75, 95, 99))
    n = len(times)
    quarters = [times[k * n // 4:(k + 1) * n // 4] for k in range(4)]
    means = "/".join(f"{sum(x) / len(x) * 1e3:.1f}" for x in quarters if x)
    return f"ms p5/25/50/75/95/99 {q}; quarter means {means}"
