"""Command line of the PyTorch port: render a preset to PNG, play the game
headless, print the device.

    python -m voxtracer_torch.cli render --preset monu_like --mode path \\
        --width 1920 --height 1080 --bounces 4 --output out.png
    python -m voxtracer_torch.cli render --preset glassbox --width 512   # whitted
    python -m voxtracer_torch.cli render --preset monu_like --mode reproject --frames 4
    python -m voxtracer_torch.cli render --preset city_xl_like     # 111 volumes, 1080p
    python -m voxtracer_torch.cli render --preset monu_like --dof --defocus 4   # thin lens
    python -m voxtracer_torch.cli render --preset room     # .vox assets from $VOX_ASSETS
    python -m voxtracer_torch.cli play --steps 8 --light-kill --output game.png
    python -m voxtracer_torch.cli live --preset monu      # terminal viewer, fly camera
    python -m voxtracer_torch.cli live --preset glassbox --script ..w. --no-display
    python -m voxtracer_torch.cli info

The scene lives on ``--device`` (default ``cuda``); CUDA tensors run the
hand-written kernels, so the default needs a GPU.  The presets teapot,
room, roomglass, monu, city and cityxl and the game read MagicaVoxel
files from ``$VOX_ASSETS`` (scene/presets.ASSET_DIR).  Path, primary and
whitted frames are rendered as the JAX CLI renders them (``render`` of
``fold_in(key, frame)``, scanline order) and kept as a progressive running
mean; reproject frames carry the illumination history from frame to frame
and the last resolved frame is written.  ``--dof`` focuses on the first
hit of the centre pixel's ray (t clamped to [-1, 1e4], as the JAX CLI)
and draws a thin-lens sample per path ray.  ``live`` is the JAX CLI's
viewer (viewer.run_live): the preset at its own size, rendered at
--width x --height, progressively, with the fly camera and live edits;
--script drives it headless, one key a frame ('.' an idle frame).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from voxtracer_torch.config import RenderConfig
from voxtracer_torch.core.rng import fold_in, make_key
from voxtracer_torch.io.image import write_png
from voxtracer_torch.render.accumulate import ProgressiveState
from voxtracer_torch.render.camera import auto_focus_distance, primary_rays
from voxtracer_torch.render.integrator import (find_nearest_world, render,
                                               render_game_frame)
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


def render_setup(args):
    """``cli render``'s scene and config, set up as the JAX CLI sets them
    up (voxtracer/cli.py:39-51): the preset built at its own size (its
    camera keeps the preset's aspect), then --width (and --height, default
    the width) replacing only the config's size; --mode, a non-zero
    --bounces and --dof replacing the preset's.  -> (scene on the CPU,
    cfg)."""
    scene, cfg = PRESETS[args.preset]()
    if args.width:
        cfg = dataclasses.replace(cfg, width=args.width, height=args.height or args.width)
    if args.mode:
        cfg = dataclasses.replace(cfg, mode=args.mode)
    if args.bounces:
        cfg = dataclasses.replace(cfg, max_bounces=args.bounces)
    if args.dof:
        cfg = dataclasses.replace(cfg, use_dof=True)
    return scene, cfg


def cmd_render(args) -> None:
    scene, cfg = render_setup(args)
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


def play_steps(game, cfg, moves, device, times=None):
    """The JAX CLI's game loop (voxtracer/cli.py:133-161): per move, with
    cfg.detect_light_kill, the frame is rendered first (renderer.cpp:
    2112-2118): ``render_game_frame`` of ``fold_in(key(1), step)``, whose
    light-kill flag goes into the tick, or, while the camera is static
    after a revert, a reprojected frame that carries the history; then
    ``game.tick(0.1, move, probe)``.  Stops once the game is won.
    times, a list, gains (probe ms, frame ms or None) per step (host
    clock, the device synchronised).  -> the number of steps taken."""
    built = {}
    probe_ms = []

    def scene():
        """The game's scene, rebuilt when the game is dirty."""
        if "scene" not in built or game.dirty:
            built["scene"] = game.build_scene(cfg.width, cfg.height, device)
        return built["scene"]

    def probe(o, d, dist):
        """FindNearestPlayer (renderer.cpp:1020-1071): one ray with
        materials 9-14 (smoke) counted as empty and the player's volume
        left out -> (volume, t, hit point, normal)."""
        t0 = time.perf_counter()
        o_t, d_t = (torch.from_numpy(np.asarray(v, np.float32))[None].to(device) for v in (o, d))
        rec = find_nearest_world(scene(), o_t, d_t, torch.ones(1, dtype=torch.bool, device=device),
                                 skip_lo=9, skip_hi=14, skip_first=True)
        t, vol = float(rec["t"][0]), int(rec["vol"][0])
        normal = torch.stack([rec["nx"], rec["ny"], rec["nz"]], -1)[0].cpu().numpy()
        probe_ms.append((time.perf_counter() - t0) * 1e3)
        return vol, t, np.asarray(o) + min(t, dist) * np.asarray(d), normal

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    history = torch.zeros((cfg.height, cfg.width, 3), device=device)
    key = make_key(1)
    for i, mv in enumerate(moves):
        in_light, frame_ms = None, None
        if cfg.detect_light_kill:
            sc = scene()
            sync()
            t0 = time.perf_counter()
            if game.state.static_camera:
                _, history, _ = render_reproject_frame(sc, cfg, sc.camera, history,
                                                       fold_in(key, i))
            else:
                in_light = bool(render_game_frame(sc, cfg, fold_in(key, i), 1)[1])
            sync()
            frame_ms = (time.perf_counter() - t0) * 1e3
        probe_ms.clear()
        game.tick(0.1, mv, probe, in_light=in_light)
        if times is not None:
            times.append((probe_ms[0] if probe_ms else None, frame_ms))
        if game.state.won:
            print("WIN")
            return i + 1
    return len(moves)


def cmd_play(args) -> None:
    """The game, headless: scripted moves (--moves, one of w/a/s/d a step;
    default w), the probe and the game logic per step, a frame per step
    with --light-kill, then the final frame to PNG."""
    from voxtracer_torch.game.level import Game

    device = torch.device(args.device)
    game = Game(seed=args.seed)
    cfg = RenderConfig(width=args.width or 128, height=args.height or 106, mode="path",
                       max_bounces=6, detect_light_kill=args.light_kill)
    moves = (list(args.moves) if args.moves else ["w"] * args.steps)[:args.steps]
    times = []
    play_steps(game, cfg, moves, device, times=times)
    for i, (probe_ms, frame_ms) in enumerate(times):
        print(f"step {i}: probe " + ("-" if probe_ms is None else f"{probe_ms:.1f} ms")
              + ("" if frame_ms is None else f", frame {frame_ms:.1f} ms"))
    scene = game.build_scene(cfg.width, cfg.height, device)
    img = render(scene, cfg, make_key(0), args.spp)
    write_png(args.output, to_rgb8(img).cpu().numpy())
    print(f"game state: chunk={game.state.current_chunk} "
          f"volumes={len(game.volumes)} -> {args.output}")


def cmd_live(args) -> None:
    """The interactive viewer (reference window + input loop,
    template.cpp:296-329), set up as the JAX CLI sets it up: the preset
    built at its own size, then rendered at --width x --height."""
    from voxtracer_torch.viewer import run_live

    scene, cfg = PRESETS[args.preset]()
    cfg = dataclasses.replace(cfg, width=args.width, height=args.height)
    if args.mode:
        cfg = dataclasses.replace(cfg, mode=args.mode)
    if args.bounces:
        cfg = dataclasses.replace(cfg, max_bounces=args.bounces)
    script = None
    if args.script:
        # one character per frame; '.' = idle frame (accumulate only)
        script = [set() if c == "." else {c} for c in args.script]
    frames, _ = run_live(scene.to(torch.device(args.device)), cfg, max_frames=args.frames,
                         script=script, display=not args.no_display, spp=args.spp,
                         seed=args.seed)
    print(f"live: {frames} frames rendered", file=sys.stderr)


def cmd_info(args) -> None:
    print("torch:", torch.__version__, "CUDA:", torch.version.cuda)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print("devices:", ["cpu"] + [f"cuda:{i} {torch.cuda.get_device_name(i)}" for i in range(n)])


def parser() -> argparse.ArgumentParser:
    """The command line's parser (``main``'s)."""
    ap = argparse.ArgumentParser(prog="voxtracer_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render", help="render a preset to PNG")
    r.add_argument("--preset", choices=sorted(PRESETS), default="monu_like")
    r.add_argument("--mode", choices=("primary", "path", "whitted", "reproject"),
                   help="default: the preset's (glassbox renders whitted)")
    r.add_argument("--width", type=int)
    r.add_argument("--height", type=int)
    r.add_argument("--bounces", type=int, default=0, help="0: the preset's")
    r.add_argument("--spp", type=int, default=1)
    r.add_argument("--frames", type=int, default=1)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--dof", action="store_true",
                   help="thin-lens depth of field, autofocused on the centre pixel")
    r.add_argument("--defocus", type=float, default=2.0, help="defocusJitter (camera.h:191)")
    r.add_argument("--device", default="cuda")
    r.add_argument("--output", default="out.png")
    r.set_defaults(fn=cmd_render)
    g = sub.add_parser("play", help="run the game headless")
    g.add_argument("--steps", type=int, default=8)
    g.add_argument("--moves", default="", help="one of w/a/s/d a step (default: w)")
    g.add_argument("--width", type=int, default=0)
    g.add_argument("--height", type=int, default=0)
    g.add_argument("--spp", type=int, default=1)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--light-kill", action="store_true",
                   help="render each step and detect the light-kill revert")
    g.add_argument("--device", default="cuda")
    g.add_argument("--output", default="game.png")
    g.set_defaults(fn=cmd_play)
    v = sub.add_parser("live", help="interactive terminal viewer (fly camera)")
    v.add_argument("--preset", choices=sorted(PRESETS), default="monu")
    v.add_argument("--width", type=int, default=256)
    v.add_argument("--height", type=int, default=212)
    v.add_argument("--mode", choices=("primary", "whitted", "path"))
    v.add_argument("--bounces", type=int, default=0)
    v.add_argument("--frames", type=int, default=0, help="stop after N frames (0 = until quit)")
    v.add_argument("--script", default="",
                   help="headless key script, one char per frame ('.'=idle)")
    v.add_argument("--no-display", action="store_true")
    v.add_argument("--spp", type=int, default=1)
    v.add_argument("--seed", type=int, default=0)
    v.add_argument("--device", default="cuda")
    v.set_defaults(fn=cmd_live)
    i = sub.add_parser("info", help="the torch build and its devices")
    i.set_defaults(fn=cmd_info)
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
