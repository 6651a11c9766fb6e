"""The program's spans in the traced run's recorded iterations: the host
events named ``vt.*`` (``voxtracer_torch.utils.profiling.span``, a
``record_function`` on the profiler's clock), with the device time, the
launches and the idle gaps each one holds.

* Pairing: in each iteration the host calls that enqueue device work
  (``LAUNCH``: kernel launches, copies and fills, from every host thread)
  sorted by start pair one to one with the device operations sorted by
  start (one stream: the k-th call made the k-th operation).  An
  iteration whose counts differ (the profiler lost some of its records)
  is left out, with a line on standard error, and nothing is guessed;
  where every iteration is left out there are no figures (None).
* A device operation belongs to every span whose interval holds its
  launch call's start (by time, not by thread: the autograd engine
  launches the backward from its own thread while the main thread waits
  inside ``vt.grad.backward``).
* An idle gap (a gap of the iteration's device union, ``trace.union_ns``)
  belongs to every span whose interval holds its midpoint, the rule of
  ``trace.Trace.breakdown``.

Figures are summed over the iterations that pair and divided by their
number: by dotted prefix of the span names (``vt.rng`` holds
``vt.rng.hash`` and ``vt.rng.threefry``), each operation and gap counted
once a prefix however many of its spans nest; and by innermost span."""

from __future__ import annotations

import re
import sys

from vtbench import trace

PREFIX = "vt."
LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaMemcpy|cudaMemset)")
NO_SPAN = "(no span)"
FIELDS = ("device_ms", "launches", "idle_ms")


def prefixes(name: str) -> list:
    """"vt.a.b" -> ["vt", "vt.a", "vt.a.b"]."""
    parts = name.split(".")
    return [".".join(parts[:k]) for k in range(1, len(parts) + 1)]


def _holding(spans, times) -> list:
    """For each of the ascending `times`, the spans (name, start, end)
    whose interval holds it, outermost first."""
    spans = sorted(spans, key=lambda sp: (sp[1], -sp[2]))
    out, live, k = [], [], 0
    for t in times:
        while k < len(spans) and spans[k][1] <= t:
            live.append(spans[k])
            k += 1
        live = [sp for sp in live if sp[2] >= t]
        out.append(tuple(live))
    return out


def _add(table: dict, key: str, field: str, value: float):
    row = table.setdefault(key, dict.fromkeys(FIELDS, 0.0))
    row[field] += value


def _charge(by_prefix, by_span, holders, field, value):
    for p in {p for sp in holders for p in prefixes(sp[0])}:
        _add(by_prefix, p, field, value)
    _add(by_span, holders[-1][0] if holders else NO_SPAN, field, value)


def table(iterations) -> dict | None:
    """{"by_prefix": {prefix: figures}, "by_span": {innermost span: figures},
    "iterations": n, "left_out": [index, ...]}, figures being ``FIELDS``
    an iteration over the n iterations whose launch calls and device
    operations pair; None where none does."""
    by_prefix: dict = {}
    by_span: dict = {}
    left_out = []
    for it in iterations:
        calls = sorted(s for name, s, _ in it.host if LAUNCH.match(name))
        ops = sorted((s, e) for _, s, e in it.device)
        if len(calls) != len(ops):
            print(f"vtbench spans: iteration {it.index} has {len(calls)} launch calls and "
                  f"{len(ops)} device operations; left out", file=sys.stderr)
            left_out.append(it.index)
            continue
        spans = [h for h in it.host if h[0].startswith(PREFIX)]
        for name, _, _ in spans:  # a span that holds nothing reads 0
            for p in prefixes(name):
                by_prefix.setdefault(p, dict.fromkeys(FIELDS, 0.0))
        for holders, (s, e) in zip(_holding(spans, calls), ops):
            _charge(by_prefix, by_span, holders, "device_ms", (e - s) / 1e6)
            _charge(by_prefix, by_span, holders, "launches", 1)
        gaps = trace.union_ns(ops)[1]
        mids = [(gs + ge) // 2 for gs, ge in gaps]
        for holders, (gs, ge) in zip(_holding(spans, mids), gaps):
            _charge(by_prefix, by_span, holders, "idle_ms", (ge - gs) / 1e6)
    n = len(iterations) - len(left_out)
    if n == 0:
        return None
    for t in (by_prefix, by_span):
        for row in t.values():
            for f in FIELDS:
                row[f] /= n
    return {"by_prefix": by_prefix, "by_span": by_span, "iterations": n,
            "left_out": left_out}


def figure(rec, units: str, prefix: str, field: str):
    """One figure of a span prefix from the traced run's record (0 for a
    span that holds nothing), or None where the run recorded no such span
    (a program without it) or no iteration paired."""
    if rec.units != units or rec.trace is None:
        return None
    t = table(rec.trace.iterations)
    if t is None or prefix not in t["by_prefix"]:
        return None
    return t["by_prefix"][prefix][field]

