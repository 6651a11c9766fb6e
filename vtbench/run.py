#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once and print its result line.

    python3 vtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's scene from its configuration on the program
(``voxtracer_torch``) and warms every shape the cell uses; the window then
runs the traffic's loop one iteration at a time, each timed on the host
clock to a ``torch.cuda.synchronize()``, until ``--seconds`` have passed.
With ``--trace 1`` the profiler records a few iterations spread over the
window and the per-layer metrics are read from them.  After the window
the program's state is freed and the kept outputs are compared with the
plain reference (``vtbench/reference``); every number compared is printed
beside its limit, on standard error and under ``limits`` in the result.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` when
traced).  A run without an H100 exits with code 3 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

_T_IMPORT = time.time()
ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# what no process of the benchmark may load (top-level module names)
FORBIDDEN = ("jax", "jaxlib", "flax", "voxtracer")
# the build and kernel caches, at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "build/vtbench/triton",
          "TORCH_EXTENSIONS_DIR": "build/vtbench/torch_extensions"}


def process_start() -> float:
    """The wall-clock time this process started (from /proc), else the
    time this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _T_IMPORT


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].split(",")[-1].strip() if out.returncode == 0 and lines else None


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)

    from vtbench import spec

    try:
        cell = spec.cell(args.workload)
    except spec.SpecError as e:
        log(f"vtbench: {e}")
        return 2
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"vtbench: the cell needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    kind = torch.cuda.get_device_name(0)
    if "H100" not in kind:
        log(f"vtbench: the benchmark runs on an NVIDIA H100, not on {kind!r}")
        return 3
    try:
        import voxtracer_torch  # noqa: F401
    except ImportError as e:
        log(f"vtbench: the program voxtracer_torch is not in this checkout: {e}")
        return 2
    from vtbench import harness

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              device=torch.device("cuda", 0), t_start=t_start,
                              power_limit=power_limit())
    bad = forbidden_modules()
    if bad:
        log(f"vtbench: the process loaded {bad}; no result")
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
