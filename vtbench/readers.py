"""What the metric readers of ``metrics/`` share.  Each reader takes the
run's ``harness.Record`` and returns a number, or None where the run has
nothing to read."""

from __future__ import annotations

import statistics

from vtbench import window


def rate_mrays(rec, units: str):
    if rec.units != units or not rec.iter_s:
        return None
    return window.rate(rec.work, len(rec.iter_s), rec.window_s) / 1e6


def p95_ms(rec, units: str, span: str | None = None):
    """The 95th percentile of every iteration of the window, or of a span's
    samples."""
    values = rec.iter_s if span is None else rec.spans.get(span)
    if rec.units != units or not values:
        return None
    return window.percentile(values, 95.0) * 1e3


def span_mean_ms(rec, name: str):
    v = rec.spans.get(name)
    return statistics.fmean(v) * 1e3 if v else None


def roofline_pct(rec, units: str):
    """Sum of the bounds over sum of the device times of every K1-K4 /
    K4-bwd launch of the traced iterations, in %."""
    if rec.units != units or rec.trace is None or not rec.bounds:
        return None
    secs = rec.trace.family_seconds()
    total = sum(secs.values())
    if total <= 0:
        return None
    return 100.0 * sum(rec.bounds.values()) / total


def busy_pct(rec, units: str):
    """The union of the device operations' intervals over the traced
    iterations' wall time, in % (a lower bound: the profiler's own host
    work lengthens the wall)."""
    if rec.units != units or rec.trace is None or not rec.trace.iterations:
        return None
    return 100.0 * rec.trace.busy_s / rec.trace.window_s


def kernels_per_iteration(rec, units: str):
    if rec.units != units or rec.trace is None or not rec.trace.iterations:
        return None
    return len(rec.trace.kernels()) / len(rec.trace.iterations)


