"""Command line of the PyTorch port: render a preset to PNG.

    python -m voxtracer_torch.cli render --preset monu_like --mode path \\
        --width 1920 --height 1080 --bounces 4 --output out.png

The scene lives on ``--device`` (default ``cuda``); CUDA tensors run the
hand-written kernels, so the default needs a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from voxtracer_torch.core.rng import fold_in, make_key
from voxtracer_torch.io.image import write_png
from voxtracer_torch.render.integrator import render_tiled
from voxtracer_torch.render.tonemap import to_rgb8
from voxtracer_torch.scene.presets import PRESETS


def cmd_render(args) -> None:
    size = {}
    if args.width:
        size = dict(width=args.width, height=args.height or args.width)
    scene, cfg = PRESETS[args.preset](**size)
    if args.mode:
        cfg = dataclasses.replace(cfg, mode=args.mode)
    if args.bounces is not None:
        cfg = dataclasses.replace(cfg, max_bounces=args.bounces)
    device = torch.device(args.device)
    scene = scene.to(device)
    key = make_key(args.seed)
    acc = torch.zeros((cfg.height, cfg.width, 3), device=device)
    for frame in range(args.frames):
        t0 = time.perf_counter()
        acc += render_tiled(scene, cfg, fold_in(key, frame), args.spp, args.tiles)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"frame {frame}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    img = to_rgb8(acc / args.frames).cpu().numpy()
    write_png(args.output, img)
    print(f"wrote {args.output} ({cfg.width}x{cfg.height}, {args.frames} frames "
          f"x {args.spp} spp, mode={cfg.mode}, device={device})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="voxtracer_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render", help="render a preset to PNG")
    r.add_argument("--preset", choices=sorted(PRESETS), default="monu_like")
    r.add_argument("--mode", choices=("primary", "path"))
    r.add_argument("--width", type=int)
    r.add_argument("--height", type=int)
    r.add_argument("--bounces", type=int)
    r.add_argument("--spp", type=int, default=1)
    r.add_argument("--frames", type=int, default=1)
    r.add_argument("--tiles", type=int, default=1, help="row bands per frame")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--device", default="cuda")
    r.add_argument("--output", default="out.png")
    args = ap.parse_args(argv)
    if args.cmd == "render":
        cmd_render(args)


if __name__ == "__main__":
    main()
