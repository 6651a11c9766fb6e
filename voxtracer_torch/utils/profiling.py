"""Timing and observability (counterpart of voxtracer/utils/profiling.py).

The reference's only observability is a Timer struct (precomp.h:162-182)
and a per-frame running-average ``ms / fps / MRays/s`` printf
(renderer.cpp:2208-2213).  Here: the same running-average frame reporter
(the live viewer's), named spans of the program's phases on the
profiler's clock, and a ``torch.profiler`` trace of the host and the
card."""

from __future__ import annotations

import contextlib
import os
import sys

import torch
import torch.autograd.profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named span of the program (names start with ``vt.``): while a
    profiler records, ``torch.profiler.record_function(name)``, a host
    event on the profiler's clock that holds every operation the phase
    launches; otherwise one shared null context, after one check of the
    profiler's Python flag (no op dispatched, nothing recorded)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


class FrameReport:
    """Running-average frame stats with the reference's alpha decay
    (renderer.cpp:2208-2213: avg = (1-alpha)*avg + alpha*ms; alpha *= 0.5
    down to 0.05)."""

    def __init__(self, width: int, height: int, stream=sys.stderr):
        self.avg_ms = 10.0
        self.alpha = 1.0
        self.rays_per_frame = width * height
        self.stream = stream
        self.times = []  # raw per-frame seconds (entry 0 includes the warm-up)

    def frame(self, seconds: float) -> dict:
        self.times.append(seconds)
        ms = seconds * 1000.0
        self.avg_ms = (1 - self.alpha) * self.avg_ms + self.alpha * ms
        if self.alpha > 0.05:
            self.alpha *= 0.5
        fps = 1000.0 / self.avg_ms
        mrays = self.rays_per_frame / self.avg_ms / 1000.0
        stats = {"ms": round(self.avg_ms, 2), "fps": round(fps, 1),
                 "mrays_s": round(mrays, 2)}
        print(f"{self.avg_ms:5.2f}ms ({fps:.1f}fps) - {mrays:.1f}Mrays/s",
              file=self.stream)
        return stats


@contextlib.contextmanager
def device_trace(log_dir: str = "build/voxtracer_trace", device: str = "cuda"):
    """A ``torch.profiler`` trace of the host and the card (of the host
    alone when the caller passes device="cpu"); yields the profiler
    (``key_averages()`` sums by kernel) and writes ``log_dir/trace.json``,
    a Chrome trace (chrome://tracing, Perfetto), where the program's
    ``span`` names show on the host's rows."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
