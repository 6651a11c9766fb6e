"""One run of one cell: set-up, the window, the traced sample, the drive
check, the comparison with the reference, the result line.  Device-free
where it can be, so the CPU tests drive all of it on a tiny frame."""

from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass, field

import torch

from vtbench import compare, loops, sides, spec, trace, window, work

@dataclass
class Record:
    """What a run measured, for the metric readers."""
    units: str                 # "frames" or "steps"
    work: int                  # primary rays an iteration
    iter_s: list               # every iteration of the window, seconds
    window_s: float            # from the window's start to its last iteration's end
    setup_s: float             # from process start to the window's start
    spans: dict = field(default_factory=dict)  # span name -> seconds, untraced iterations
    trace: trace.Trace | None = None
    bounds: dict | None = None  # kernel family -> summed bound (s) of the traced iterations


def launch_counts(modules) -> dict:
    """The program's launch counters (``launches`` of each module)."""
    out = {}
    for name in modules:
        mod = sys.modules.get(f"{sides.PROGRAM}.{name}")
        if mod is not None:
            out.update(getattr(mod, "launches", {}))
    return out


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, power_limit: str | None = None, render=None,
             drive_check: bool = True) -> dict:
    """One run -> the result dict.  `render` overrides RenderConfig fields
    (the CPU tests' tiny frames)."""
    device = torch.device(device)
    prog = sides.Side(sides.PROGRAM)
    inputs = sides.make_inputs(cell.config)
    loop = loops.make(cell.traffic, seed, sides.has_media(inputs))
    overrides = {**loops.render_overrides(cell.traffic), **(render or {})}
    scene, cfg = sides.make_scene(prog, cell.config, inputs, device, **overrides)
    loop_inputs = loop.make_inputs(cfg, device)
    loop.setup(prog, scene, cfg, loop_inputs)
    sync(device)
    rec_trace = trace.Trace() if traced else None
    before = launch_counts(loop.launch_modules)
    setup_s = time.time() - t_start
    spans: dict = {}
    times, i, profiled = [], loop.first, set()
    # traced: a profiler opened at each of trace.SAMPLES points of the
    # window for two iterations, the first warming it up, the second
    # recorded
    points = [seconds * (k + 1) / (trace.SAMPLES + 1)
              for k in range(trace.SAMPLES)] if traced else []
    prof, left = None, 0
    span_hook = loop.spans(spans, device) if traced and hasattr(loop, "spans") else None
    t0 = time.perf_counter()
    try:
        while True:
            # every sample is taken, so a window the profiler slowed runs on
            if traced and prof is None and points and time.perf_counter() - t0 >= points[0]:
                points.pop(0)
                opened = time.perf_counter()
                prof, left = _profiler(rec_trace, device), 2
                prof.start()
            if prof is not None and left == 1:
                loop.keep_for_replay(i)  # the recorded iteration
            a = time.perf_counter()
            out = loop.step(i)
            sync(device)
            b = time.perf_counter()
            times.append(b - a)
            loop.observe(i, out)
            if prof is not None:
                profiled.add(i)
                rec_trace.pending = (i, b - a)
                prof.step()
                left -= 1
                if left == 0:
                    prof.stop()
                    prof = None
                    print(f"vtbench: traced iteration {i}; the sample took "
                          f"{time.perf_counter() - opened:.2f} s", file=sys.stderr)
            i += 1
            if b - t0 >= seconds and prof is None and (not points or b - t0 > 2 * seconds + 60):
                break
    finally:
        if prof is not None:
            prof.stop()
        if span_hook is not None:
            span_hook()
    window_s = b - t0
    q = sorted(times)
    print(f"vtbench window: {len(q)} {loop.units()} in {window_s:.3f} s; ms min "
          f"{q[0] * 1e3:.2f} median {q[len(q) // 2] * 1e3:.2f} max {q[-1] * 1e3:.2f}; "
          f"set-up {setup_s:.2f} s", file=sys.stderr)
    print("vtbench window shape: " + window.shape(times), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    moved = {k: v - before.get(k, 0) for k, v in launch_counts(loop.launch_modules).items()}
    loop.close()

    bounds = None
    if traced:
        b_sum, b_cnt = {}, {}
        with work.recording(b_sum, b_cnt):
            for j in (it.index for it in rec_trace.iterations):
                loop.replay(j)
                sync(device)
        if b_cnt == rec_trace.family_counts():
            bounds = b_sum
        else:
            print(f"vtbench: the replayed launches {b_cnt} differ from the traced "
                  f"{rec_trace.family_counts()}; no roofline", file=sys.stderr)
    # the spans of the iterations that ran without the profiler
    span_s = {k: [s for j, s in v if j not in profiled] for k, v in spans.items()}
    if traced:
        span_s["iteration"] = [t for j, t in enumerate(times, loop.first) if j not in profiled]

    record = Record(units=loop.units(), work=loop.work(cfg), iter_s=times, window_s=window_s,
                    setup_s=setup_s, spans=span_s, trace=rec_trace, bounds=bounds)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # free the program's state, then the reference
    checks = loop.checks
    loop.release()
    del scene, prog, out
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = reference_numbers(cell, loop, checks, inputs, loop_inputs, overrides, device)
    verdicts = compare.judge(numbers, cell.limits)
    drive = [(k, moved.get(k, 0)) for k in loop.expected_launches()] if drive_check else []
    correct = all(ok for *_, ok in verdicts) and all(n > 0 for _, n in drive)
    if drive_check and device.type == "cuda" and power_limit is None:
        correct = False
        print("vtbench: nvidia-smi gave no power limit", file=sys.stderr)
    limits = {}
    for name, value, lim, ok in verdicts:
        limits[name] = {"value": value if math.isfinite(value) else str(value), "limit": lim}
    for k, n in drive:
        limits[f"launches.{k}"] = {"value": n, "limit": "> 0"}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.entry["chips"], "memory_peak_bytes": int(peak), "power_limit": power_limit}
    if traced:
        dev.update(busy_s=rec_trace.busy_s, window_s=rec_trace.window_s)
    result = {"correct": bool(correct), "attempted": len(times),
              "failed": sum(1 for *_, ok in verdicts if not ok), "metrics": metrics,
              "device": dev}
    if traced:
        result["breakdown"] = rec_trace.breakdown()
    result["limits"] = limits
    for name, v in limits.items():
        print(f"vtbench limit {name}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(f"vtbench correct: {bool(correct)}", file=sys.stderr, flush=True)
    return result


def reference_numbers(cell, loop, checks, inputs, loop_inputs, overrides, device,
                      readings=None) -> dict:
    """Each check's outputs made again by the reference, and compared:
    the worst reading of each number over the checks.  `readings(loop,
    program outputs, reference outputs)` adds numbers that are read, not
    judged (the readings tool's)."""
    ref = sides.Side(sides.REFERENCE)
    rscene, rcfg = sides.make_scene(ref, cell.config, inputs, device, **overrides)
    numbers: dict = {}
    for check in checks:
        got = loop.reference(ref, rscene, rcfg, loop_inputs, check)
        found = loop.numbers(check.outputs, got)
        if readings is not None:
            found.update(readings(loop, check.outputs, got))
        for k, v in found.items():
            numbers[k] = v if k not in numbers or not (v <= numbers[k]) else numbers[k]
    return numbers


def _profiler(rec_trace, device):
    """A profiler for two iterations: one to warm it up, one recorded."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])

    def ready(prof):
        index, wall = rec_trace.pending
        dev, host = trace.events_of(prof)
        rec_trace.iterations.append(trace.Iteration(index=index, wall_s=wall, device=dev,
                                                    host=host))

    return profile(activities=acts, on_trace_ready=ready,
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
