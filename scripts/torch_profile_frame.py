#!/usr/bin/env python3
"""Where the time of the port's forward frame or gradient step goes, on one GPU.

    python scripts/torch_profile_frame.py
        [--step frame|grad|fused|whitted|reproject|city|replay|game]
        [--width 1920 --height 1080 --bounces 4] [--reorder auto|always|none]

Runs one step under torch.profiler after two warm-up steps.  On the
asset-free monu-like scene: "frame" renders the path-traced frame
(render_tiled), "grad" takes the relaxed-march gradient over the bench's
(2,10)-step span bins at edge 4 in 2 bands (diff.train.binned_grads),
"fused" does both (diff.train.fused_step), "reproject" renders a
static-camera frame against the history of the frames before it
(render/reproject.render_reproject_frame).  "whitted" renders
glass_sphere_box through the branch queue at the given width (default
512x512, depth 5); "city" the path-traced frame of the 111-volume
city_xl-layout stand-in (bounce reorder "auto", or as --reorder says);
"replay" the active path-replay gradient (diff.replay_active, the
precompute made once before the warm-up); "game" the game's frame
(render_game_frame with the light kill, 6 bounces, default 256x212) of
the first zone, built from stand-in .vox files
(chip_smoke.write_standin_assets, seed 0).  Prints the device time by
kernel (top 25), the device kernels launched, the share of device time
spent in the hand-written kernels, and the device busy share of the
step's wall time.  The chrome trace goes to --trace
(default out/torch_<step>_trace.json).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import write_standin_assets  # noqa: E402
from voxtracer_torch.config import RenderConfig  # noqa: E402
from voxtracer_torch.core.rng import fold_in, make_key  # noqa: E402
from voxtracer_torch.diff import replay_active, train  # noqa: E402
from voxtracer_torch.diff.volumetric import params_from_scene  # noqa: E402
from voxtracer_torch.game.level import Game  # noqa: E402
from voxtracer_torch.render.integrator import render_game_frame, render_tiled  # noqa: E402
from voxtracer_torch.render.reproject import render_reproject_frame  # noqa: E402
from voxtracer_torch.scene.presets import (city_xl_like_path, glass_sphere_box,  # noqa: E402
                                           monu_like_path)

OURS = ("traverse_kernel", "exit_kernel", "lookup_kernel", "lookup_bwd_kernel")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int)
    ap.add_argument("--height", type=int)
    ap.add_argument("--bounces", type=int)
    ap.add_argument("--step", choices=("frame", "grad", "fused", "whitted", "reproject", "city",
                                       "replay", "game"),
                    default="frame")
    ap.add_argument("--reorder", choices=("auto", "always", "none"),
                    help="RenderConfig.bounce_reorder (default: the preset's)")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    if args.step == "whitted":
        scene, cfg = glass_sphere_box(args.width or 512, args.height or args.width or 512)
        if args.bounces is not None:
            cfg = dataclasses.replace(cfg, max_bounces=args.bounces)
    elif args.step == "game":
        cfg = RenderConfig(width=args.width or 256, height=args.height or 212, mode="path",
                           max_bounces=6 if args.bounces is None else args.bounces,
                           detect_light_kill=True)
        with tempfile.TemporaryDirectory() as assets:
            write_standin_assets(assets, 0)
            scene = Game(seed=0, asset_dir=assets).build_scene(cfg.width, cfg.height, "cpu")
    else:
        preset = city_xl_like_path if args.step == "city" else monu_like_path
        scene, cfg = preset(args.width or 1920, args.height or 1080,
                            bounces=4 if args.bounces is None else args.bounces)
    if args.step == "reproject":
        cfg = dataclasses.replace(cfg, mode="reproject")
    if args.reorder:
        cfg = dataclasses.replace(cfg, bounce_reorder=args.reorder)
    scene = scene.to("cuda")
    key = make_key(0)
    history = torch.zeros((cfg.height, cfg.width, 3), device="cuda")
    if args.step in ("grad", "fused"):
        params = params_from_scene(scene)
        plan = train.prepare_bins(scene, cfg, torch.zeros((cfg.height, cfg.width, 3),
                                                          device="cuda"))
    if args.step == "replay":
        params = params_from_scene(scene)
        pre = replay_active.replay_precompute(scene, cfg, key)
        replay_grad, _ = replay_active.make_replay_grad_fn(
            scene, cfg, pre, torch.zeros((pre["n_c"], 3), device="cuda"),
            float(cfg.width * cfg.height * 3))

    def run(i):
        nonlocal history
        if args.step in ("frame", "whitted", "city"):
            render_tiled(scene, cfg, fold_in(key, i), 1, 1)
        elif args.step == "game":
            render_game_frame(scene, cfg, fold_in(key, i))
        elif args.step == "reproject":
            _, history, _ = render_reproject_frame(scene, cfg, scene.camera, history,
                                                   fold_in(key, i))
        elif args.step == "grad":
            train.binned_grads(params, scene, plan)
        elif args.step == "replay":
            replay_grad(params)
        else:
            train.fused_step(params, scene, cfg, fold_in(key, i), plan)

    for i in range(2):
        run(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(2)
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
    print(f"{args.step} wall {wall_us / 1e3:.2f} ms (profiled); device time "
          f"{total / 1e3:.2f} ms = {total / wall_us:.1%} busy, "
          f"{sum(e.count for e in events)} kernels launched; hand-written "
          f"kernels {ours / 1e3:.3f} ms = {ours / max(total, 1):.1%} of device time")
    print(f"{'device us':>10} {'calls':>6}  kernel")
    for e in events[:25]:
        print(f"{e.self_device_time_total:10.0f} {e.count:6d}  {e.key[:100]}")
    trace = args.trace or f"out/torch_{args.step}_trace.json"
    os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
    prof.export_chrome_trace(trace)


if __name__ == "__main__":
    main()
