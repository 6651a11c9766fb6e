"""The traced run's device trace: ``torch.profiler`` over SAMPLES
iterations spread over the window (a profiler opened at each sample point
for two iterations, one to warm it up and one recorded), kept in memory,
never written to disk, and reduced to

* the device operations of each recorded iteration (kernels, copies and
  fills: name, start, end), and the host operations around them;
* the union of the device operations' intervals (busy seconds);
* the kernels of the port's hand-written CUDA sources, by family (K1 the
  nearest-hit walk, K2 the occlusion walk, K3 the exit march, K4 the row
  lookup, K4bwd its adjoint);
* the top device operations by time and the idle gaps by the host
  operation that ran across them (the ``breakdown``)."""

from __future__ import annotations

import re
from dataclasses import dataclass, field

FAMILIES = (("K1", re.compile(r"traverse_kernel(<0\b|ILi0E)")),
            ("K2", re.compile(r"traverse_kernel(<1\b|ILi1E)")),
            ("K3", re.compile(r"exit_kernel")),
            ("K4bwd", re.compile(r"lookup_bwd_kernel")),
            ("K4", re.compile(r"lookup_kernel")))
COPY_OR_FILL = re.compile(r"^(Memcpy|Memset|memcpy|memset)")
# the profiler's own step markers, which it also lays on the device's timeline
ANNOTATION = re.compile(r"^ProfilerStep#")
SAMPLES = 3  # the iterations a traced run records, spread over its window


def family(name: str):
    """The hand-written kernel family of a device operation's name, or None."""
    for fam, pat in FAMILIES:
        if pat.search(name):
            return fam
    return None


@dataclass
class Iteration:
    """One recorded iteration: its host wall time and its events (ns)."""
    index: int
    wall_s: float
    device: list = field(default_factory=list)   # (name, start_ns, end_ns)
    host: list = field(default_factory=list)     # (name, start_ns, end_ns)


def union_ns(intervals) -> tuple:
    """(the length of the union of [start, end) intervals, the gaps
    between its pieces as (start, end))."""
    total, gaps, cur_s, cur_e = 0, [], None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def events_of(prof) -> tuple:
    """(device events, host events) of a profiler cycle as (name, start_ns,
    end_ns)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns()
        rec = (name, s, s + e.duration_ns())
        if e.device_type() != DeviceType.CUDA:
            if not ANNOTATION.match(name):
                host.append(rec)
        elif not (ANNOTATION.match(name) or getattr(e, "is_user_annotation", bool)()):
            dev.append(rec)
    return dev, host


@dataclass
class Trace:
    iterations: list = field(default_factory=list)
    pending: tuple = (None, 0.0)  # (index, wall s) of the iteration just run

    @property
    def window_s(self) -> float:
        return sum(it.wall_s for it in self.iterations)

    @property
    def busy_s(self) -> float:
        return sum(union_ns((s, e) for _, s, e in it.device)[0]
                   for it in self.iterations) / 1e9

    def kernels(self) -> list:
        return [d for it in self.iterations for d in it.device
                if not COPY_OR_FILL.match(d[0])]

    def family_seconds(self) -> dict:
        out: dict = {}
        for name, s, e in self.kernels():
            fam = family(name)
            if fam:
                out[fam] = out.get(fam, 0.0) + (e - s) / 1e9
        return out

    def family_counts(self) -> dict:
        out: dict = {}
        for name, _, _ in self.kernels():
            fam = family(name)
            if fam:
                out[fam] = out.get(fam, 0) + 1
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops: dict = {}
        for it in self.iterations:
            for name, s, e in it.device:
                ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
        gaps: dict = {}
        for it in self.iterations:
            _, holes = union_ns((s, e) for _, s, e in it.device)
            hosts = sorted(it.host, key=lambda h: h[1])
            for gs, ge in holes:
                mid = (gs + ge) // 2
                # the innermost host operation running across the gap
                inner = None
                for name, s, e in hosts:
                    if s > mid:
                        break
                    if e >= mid and (inner is None or s >= inner[1]):
                        inner = (name, s, e)
                label = inner[0] if inner else "(host: Python between torch operations)"
                gaps[label] = gaps.get(label, 0.0) + (ge - gs) / 1e9

        def first(d):
            return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": first(ops), "idle_gaps": first(gaps)}
