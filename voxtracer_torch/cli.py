"""Command line of the PyTorch port: render a preset to PNG.

    python -m voxtracer_torch.cli render --preset monu_like --mode path \\
        --width 1920 --height 1080 --bounces 4 --output out.png
    python -m voxtracer_torch.cli render --preset glassbox --width 512   # whitted
    python -m voxtracer_torch.cli render --preset monu_like --mode reproject --frames 4
    python -m voxtracer_torch.cli render --preset city_xl_like     # 111 volumes, 1080p
    python -m voxtracer_torch.cli render --preset monu_like --dof --defocus 4   # thin lens

The scene lives on ``--device`` (default ``cuda``); CUDA tensors run the
hand-written kernels, so the default needs a GPU.  Path, primary and
whitted frames are rendered as the JAX CLI renders them (``render`` of
``fold_in(key, frame)``, scanline order) and kept as a progressive running
mean; reproject frames carry the illumination history from frame to frame
and the last resolved frame is written.  ``--dof`` focuses on the first
hit of the centre pixel's ray (t clamped to [-1, 1e4], as the JAX CLI)
and draws a thin-lens sample per path ray.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from voxtracer_torch.core.rng import fold_in, make_key
from voxtracer_torch.io.image import write_png
from voxtracer_torch.render.accumulate import ProgressiveState
from voxtracer_torch.render.camera import auto_focus_distance, primary_rays
from voxtracer_torch.render.integrator import find_nearest_world, render
from voxtracer_torch.render.reproject import render_reproject_frame
from voxtracer_torch.render.tonemap import to_rgb8
from voxtracer_torch.scene.presets import PRESETS


def _timed(device, frame, fn):
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"frame {frame}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    return out


def render_progressive(scene, cfg, key, frames: int, spp: int = 1):
    """The JAX CLI's frame loop (voxtracer/cli.py:92-98): frame i renders
    ``render(scene, cfg, fold_in(key, i), spp)`` into a ProgressiveState
    running mean -> the accumulated radiance [H, W, 3]."""
    prog = ProgressiveState(cfg.height, cfg.width, scene.device)
    for frame in range(frames):
        _timed(scene.device, frame, lambda: prog.add(render(scene, cfg, fold_in(key, frame), spp)))
    return prog.acc


def autofocus(scene, cfg, defocus: float):
    """The JAX CLI's autofocus (reference Tick, renderer.cpp:1987-1991):
    trace the centre pixel, focus at its hit t clamped to [-1, 1e4], and
    set the lens radius -> (scene with the focused camera, focal distance)."""
    dev = scene.device
    centre = torch.tensor([[cfg.width / 2.0, cfg.height / 2.0]], device=dev)
    o, d = primary_rays(scene.camera, cfg.width, cfg.height, centre[:, 0], centre[:, 1])
    rec = find_nearest_world(scene, o, d, torch.ones(1, dtype=torch.bool, device=dev))
    # the JAX CLI's clip to [-1, 1e4]: the reference's min(t, 1e4) after a
    # lower clip at -1 (a miss's t)
    focal = auto_focus_distance(scene.camera, cfg.width, cfg.height,
                                float(np.maximum(rec["t"].cpu().numpy()[0], -1.0)))
    cam = dataclasses.replace(scene.camera, focal_distance=torch.tensor(focal, device=dev),
                              defocus_jitter=torch.tensor(defocus, device=dev))
    return dataclasses.replace(scene, camera=cam), focal


def cmd_render(args) -> None:
    size = {}
    if args.width:
        size = dict(width=args.width, height=args.height or args.width)
    scene, cfg = PRESETS[args.preset](**size)
    if args.mode:
        cfg = dataclasses.replace(cfg, mode=args.mode)
    if args.bounces is not None:
        cfg = dataclasses.replace(cfg, max_bounces=args.bounces)
    if args.dof:
        cfg = dataclasses.replace(cfg, use_dof=True)
    device = torch.device(args.device)
    scene = scene.to(device)
    if args.dof:
        scene, focal = autofocus(scene, cfg, args.defocus)
        print(f"autofocus: focal distance {focal:.3f}")
    key = make_key(args.seed)
    if cfg.mode == "reproject":
        # static camera: each frame resolves against the previous frame's
        # illumination history; the resolved image is already tonemapped
        history = torch.zeros((cfg.height, cfg.width, 3), device=device)
        for frame in range(args.frames):
            img, history, _ = _timed(device, frame, lambda: render_reproject_frame(
                scene, cfg, scene.camera, history, fold_in(key, frame)))
        rgb = (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
        what = f"{args.frames} reprojected frames"
    else:
        rgb = to_rgb8(render_progressive(scene, cfg, key, args.frames, args.spp))
        what = f"{args.frames} frames x {args.spp} spp"
    write_png(args.output, rgb.cpu().numpy())
    print(f"wrote {args.output} ({cfg.width}x{cfg.height}, {what}, mode={cfg.mode}, "
          f"device={device})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="voxtracer_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render", help="render a preset to PNG")
    r.add_argument("--preset", choices=sorted(PRESETS), default="monu_like")
    r.add_argument("--mode", choices=("primary", "path", "whitted", "reproject"),
                   help="default: the preset's (glassbox renders whitted)")
    r.add_argument("--width", type=int)
    r.add_argument("--height", type=int)
    r.add_argument("--bounces", type=int)
    r.add_argument("--spp", type=int, default=1)
    r.add_argument("--frames", type=int, default=1)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--dof", action="store_true",
                   help="thin-lens depth of field, autofocused on the centre pixel")
    r.add_argument("--defocus", type=float, default=2.0, help="defocusJitter (camera.h:191)")
    r.add_argument("--device", default="cuda")
    r.add_argument("--output", default="out.png")
    args = ap.parse_args(argv)
    if args.cmd == "render":
        cmd_render(args)


if __name__ == "__main__":
    main()
