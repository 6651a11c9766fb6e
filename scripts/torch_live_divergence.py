#!/usr/bin/env python3
"""Where the live viewer's frames through the kernels part from the plain
versions', on one GPU.

    python scripts/torch_live_divergence.py [--preset roomglass]
        [--width 256 --height 212] [--script .w.m.]

Runs ``viewer.LiveSession`` over the script (one character a frame: "."
idle, any other a key) twice on the preset built from stand-in .vox files
(``chip_smoke.write_standin_assets``, seed 0): through the kernels, and
under ``chip_smoke.plain_versions``.  Every K1, K2 and K3 call of both
runs is recorded.  Prints the pixels of the final accumulator that are
more than 1e-3 apart, the first frame whose accumulator parts, and for
each call of that frame, in order:

* the two runs' inputs: how many lanes differ, and by how much at most;
* the kernel against the plain version on the kernel run's inputs: lanes
  whose hit, volume or cell differ, and the largest t difference;
* the two runs' outputs as each run got them: lanes whose hit, volume or
  cell differ.

Then the lanes of the first call whose outputs part between the runs,
with their inputs and each run's t, hit and cell.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (captured_traversals, nvidia_smi, plain_versions,  # noqa: E402
                        write_standin_assets)
from voxtracer_torch.kernels import traverse  # noqa: E402
from voxtracer_torch.scene import presets  # noqa: E402
from voxtracer_torch.viewer import LiveSession  # noqa: E402

# the ray-side arguments of traverse() (o, d, t_limit, ray_active) and of
# exit_march() (o, d, ray_active, mode_code, vol_match)
RAYS = {"exit": (5, 6, 7, 8, 9), "nearest": (5, 6, 7, 8), "occluded": (5, 6, 7, 8)}


def run(scene, cfg, script, plain):
    """The accumulator after each frame and each frame's calls with the
    outputs the run got."""
    live = LiveSession(scene, cfg)
    accs, frames = [], []
    for ch in script:
        calls = []
        with plain_versions() if plain else contextlib.nullcontext(), captured_traversals(calls):
            live.frame(set() if ch == "." else {ch}, 33.0)
        torch.cuda.synchronize()
        accs.append(live.acc.clone())
        frames.append([(mode, args, call(mode, args, plain)) for mode, args in calls])
    return accs, frames


def call(mode, args, plain):
    if mode == "exit":
        fn = traverse.exit_march_plain if plain else traverse.exit_march
        return fn(*args)
    fn = traverse.traverse_plain if plain else traverse.traverse
    return fn(*args, mode=mode)


def discrete(out):
    return [f for f in ("hit", "in_vol", "vol", "cell") if f in out]


def lanes_apart(a, b):
    """Lanes where the discrete fields of two results differ."""
    bad = torch.zeros_like(next(iter(a.values())), dtype=torch.bool)
    for f in discrete(a):
        bad |= a[f].long() != b[f].long()
    return bad.nonzero()[:, 0]


def input_diff(mode, ka, pa):
    """(lanes whose inputs differ, those that differ by more than 1e-3, the
    largest difference)."""
    n = ka[5].shape[0]
    bad = torch.zeros(n, dtype=torch.bool, device=ka[5].device)
    big = torch.zeros_like(bad)
    worst = 0.0
    for i in RAYS[mode]:
        x, y = ka[i], pa[i]
        if x is None or y is None:
            continue
        dxy = (x.float() - y.float()).abs().reshape(n, -1).amax(1)
        bad |= dxy > 0
        big |= dxy > 1e-3
        worst = max(worst, float(dxy.max()) if n else 0.0)
    return int(bad.sum()), int(big.sum()), worst


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="roomglass")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=212)
    ap.add_argument("--script", default=".w.m.")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    tmp = tempfile.TemporaryDirectory()
    write_standin_assets(tmp.name, 0)
    presets.ASSET_DIR = tmp.name
    scene, cfg = presets.PRESETS[args.preset]()
    cfg = dataclasses.replace(cfg, width=args.width, height=args.height)
    scene = scene.to(torch.device("cuda", 0))
    print(f"{args.preset} {args.width}x{args.height} ({cfg.mode}, {cfg.max_bounces} bounces), "
          f"script {args.script!r} ({nvidia_smi()})")

    kacc, kframes = run(scene, cfg, args.script, plain=False)
    pacc, pframes = run(scene, cfg, args.script, plain=True)
    diff = (kacc[-1] - pacc[-1]).abs().amax(-1)
    ys, xs = (diff > 1e-3).nonzero(as_tuple=True)
    print(f"final accumulator: {ys.numel()} pixels off by more than 1e-3")
    # the first call of a frame traces the pixels in scanline order
    for y, x in zip(ys.tolist(), xs.tolist()):
        print(f"  pixel (x {x}, y {y}; lane {y * args.width + x} of a first call): kernels "
              f"{kacc[-1][y, x].tolist()}, plain {pacc[-1][y, x].tolist()}")
    first = next((f for f in range(len(kacc))
                  if float((kacc[f] - pacc[f]).abs().max()) > 1e-3), None)
    if first is None:
        print("no frame parts")
        return
    print(f"frame {first} ({args.script[first]!r}) parts first: "
          f"{int(((kacc[first] - pacc[first]).abs().amax(-1) > 1e-3).sum())} pixels; "
          f"{len(kframes[first])} calls through the kernels, {len(pframes[first])} plain")
    shown = False
    for i, ((mode, ka, kout), (pmode, pa, pout)) in enumerate(zip(kframes[first],
                                                                  pframes[first])):
        if mode != pmode or ka[5].shape != pa[5].shape:
            print(f"  call {i}: {mode} {tuple(ka[5].shape)} against {pmode} "
                  f"{tuple(pa[5].shape)}: the runs' calls no longer line up")
            break
        n_in, n_big, worst_in = input_diff(mode, ka, pa)
        same_in = call(mode, ka, plain=True)
        kx = lanes_apart(kout, same_in)
        dt = (float((kout["t"] - same_in["t"]).abs().max()) if "t" in kout and ka[5].shape[0]
              else 0.0)
        apart = lanes_apart(kout, pout)
        print(f"  call {i} {mode}: {ka[5].shape[0]} rays; inputs differ on {n_in} lanes "
              f"({n_big} by more than 1e-3, max {worst_in:.3g}); kernel vs plain on the same "
              f"inputs: {kx.numel()} lanes apart, t max diff {dt:.3g}; the runs' outputs: "
              f"{apart.numel()} lanes apart")
        if apart.numel() and not shown:
            shown = True
            for lane in apart[:8].tolist():
                row = {f: (kout[f][lane].item(), pout[f][lane].item())
                       for f in discrete(kout) + (["t"] if "t" in kout else [])}
                o_k, o_p = ka[5][lane].tolist(), pa[5][lane].tolist()
                d_k, d_p = ka[6][lane].tolist(), pa[6][lane].tolist()
                print(f"    lane {lane}: o {o_k} / {o_p}; d {d_k} / {d_p}; (kernel run, "
                      f"plain run) {row}; plain on the kernel run's inputs "
                      f"{ {f: same_in[f][lane].item() for f in row} }")
    tmp.cleanup()


if __name__ == "__main__":
    main()
