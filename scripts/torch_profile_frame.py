#!/usr/bin/env python3
"""Where the time of the port's forward frame goes, on one GPU.

    python scripts/torch_profile_frame.py [--width 1920 --height 1080 --bounces 4]

Renders the asset-free monu-like scene through render_tiled under
torch.profiler after two warm-up frames, then prints the device time by
kernel (top 25), the share of device time spent in the hand-written
kernels, and the device busy share of the frame's wall time.  The chrome
trace goes to --trace (default out/torch_frame_trace.json).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from voxtracer_torch.core.rng import fold_in, make_key  # noqa: E402
from voxtracer_torch.render.integrator import render_tiled  # noqa: E402
from voxtracer_torch.scene.presets import monu_like_path  # noqa: E402

OURS = ("traverse_kernel", "exit_kernel", "lookup_kernel")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--trace", default="out/torch_frame_trace.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    scene, cfg = monu_like_path(args.width, args.height, bounces=args.bounces)
    scene = scene.to("cuda")
    key = make_key(0)
    for i in range(2):
        render_tiled(scene, cfg, fold_in(key, i), 1, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_tiled(scene, cfg, fold_in(key, 2), 1, 1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernel events only: the aten ops that launched them carry the same
    # device time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in events)
    ours = sum(e.self_device_time_total for e in events
               if any(name in e.key for name in OURS))
    print(f"frame wall {wall_us / 1e3:.2f} ms (profiled); device time "
          f"{total / 1e3:.2f} ms = {total / wall_us:.1%} busy; hand-written "
          f"kernels {ours / 1e3:.3f} ms = {ours / max(total, 1):.1%} of device time")
    print(f"{'device us':>10} {'calls':>6}  kernel")
    for e in events[:25]:
        print(f"{e.self_device_time_total:10.0f} {e.count:6d}  {e.key[:100]}")
    os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
    prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
