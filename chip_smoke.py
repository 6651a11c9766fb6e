#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (voxtracer_torch) on one GPU.

    python3 chip_smoke.py [--baseline DIR]

Builds the CUDA kernels from voxtracer_torch/csrc, holds each kernel
against its plain PyTorch version at the shapes of the main path, and
drives the port's two halves of the main path through its entry points:

* the forward: the 1080p 4-bounce path-traced frame of the asset-free
  monu-like scene and the glass + smoke media scene (render_tiled);
* the gradient step: the relaxed-march gradient over the bench's
  (2,10)-step span bins at edge 4 in 2 bands (diff.train.binned_grads),
  timed inside the fused step (forward frame + gradient, as bench.py
  times it), and 3 Adam steps of the trainer (diff.train.make_train_step);
* the Whitted renderer: glass_sphere_box at 512x512, depth 5, through the
  branch queue (render_tiled in whitted mode);
* the static-camera reprojection: the 1080p 4-bounce monu-like frame, one
  frame to fill the history and 3 timed frames that blend with it, and
  the media scene (render/reproject.render_reproject_frame);
* the kernel probes (voxtracer_torch.probe.main): the lane gather, the
  2048-entry gather and the DDA-shaped ALU loop, each held against its
  plain version at B = 32, 256 and 1024 first, the lane gather and the
  ALU loop in cycles an iteration at each B beside nvidia-smi's SM clock,
  and their ptxas registers;
* a scene past 64 volumes: the 1080p 4-bounce frame of the city_xl-layout
  stand-in (111 volumes of 64^3, 5 pages) with the bounce reorder on
  "auto", in one K1/K2 launch over all volumes as the port runs it on the
  card, timed against a launch a page (the CPU path's page-by-page walk,
  swapped in) and against the frame without the reorder; K1 and K2 on
  every call of that frame, each held against the plain version and
  against the paged walk (bit for bit), with the rays each page's cull
  keeps, and timed once more with the floor's page first;
* the frozen-path replay gradients (``replay_phases``): the active replay
  of the 1080p monu-like frame (diff.replay_active: the precompute, the
  gradient timed with its peak memory, the FD check of
  scripts/bench_replay_active.py at its 2% bar, 3 Adam steps), K1 on
  every call of its precompute and K4 and K4-bwd on every distinct call
  shape of its step; the whole replay at 256x144 through the kernels
  against the plain versions, and its estimator against the capability
  replay's (tests/test_replay_active.py's bar); the capability replay
  (diff.path_replay, the glass and smoke chains through the exit march)
  on the media scene and glassbox at 256x256;
* the thin-lens frame: the 1080p path frame autofocused on the centre
  pixel with use_dof (cli render --dof's set-up), timed beside the
  pinhole frame;
* ``.vox`` loading, the asset presets and the game (``asset_phases``), on
  stand-in .vox files (``write_standin_assets``, seed 0, in a temporary
  directory): every file through the numpy and the native parser, held
  equal; the five asset presets at their own sizes (teapot_primary 256^2
  at 128^3, room_whitted 512^2 at depth 5 and with glass at depth 3,
  monu_path, city_path and city_xl_path at 1080p) through ``render``,
  counted, timed and held to the plain versions (the 1080p ones at a
  smaller size), with K1-K3 on every call of the roomGlass frame; the
  game at 256x212 with 6 bounces and the light kill: cli play's loop
  for 8 steps of real probes, then the scripted progression through
  chunks 1-3 with a frame per chunk held to the plain versions, and the
  lit and dark light-kill scenes;
* the live viewer, the sharded paths and the scaling bench
  (``live_dist_phases``, stand-ins again): [25] ``viewer.run_live``
  headless at 256x212 on cli live's default preset (monu, path) and on
  roomglass (whitted, K3 through the glass floor), scripts/viewer_fps.py's
  script plus one material edit, frame times against the reference's
  >5 fps bar, the terminal assembly, launches a frame, the accumulator of
  a short script (a move, an edit) through the kernels against the plain
  versions (0 pixels off by more than 1e-3) with each K1-K3 call of it
  held to its plain version on the same inputs, and ``cli live --script
  ..w. --no-display`` as a process; [26] ``dist.mesh.render_sharded`` of
  the 1080p monu-like path frame and of glassbox whitted 512x512 on 1
  rank (this process) and on 4 ranks spawned on the one card
  (``dist.multihost.spawn``: gloo, every rank on the card), held equal
  bit for bit, and each held to the same frame with every rank's share
  through the plain versions; ``dist.train.train_demo``'s step on a
  (2, 2) mesh against 1 rank (loss within 1e-5 relative, gradients within
  relative L2 1e-4), and the 1-rank step through the kernels against the
  plain versions to the same gate, with peak memory and launches per
  rank; [27] ``bench.scaling.measure`` at 1080p on 1, 2 and 4 ranks;
  [28] (``wavefront_phase``) the sharded frames that share one global
  wavefront, on 1 rank and on 4 spawned on the card: the city_xl_like
  1080p path frame with its bounce reorder (the packed state gathered at
  each reorder) and stand-in roomglass 512^2 whitted, depth 3, with
  random light choice (light samples drawn at the global queue slot, one
  indicator sum an iteration), 4 ranks held equal to 1 bit for bit and
  each held to the same frame through the plain versions (0 pixels off by
  more than 1e-3), with frame times, peak memory, launches, reorders and
  the bytes and ms of each exchange, queue iterations; the city frame
  without the reorder and roomglass with every light summed on 1 rank,
  for scale;
* the JAX package's render options (``options_phase``, [29]), each
  beside the run without it: the wavefront compaction on the 1080p
  monu-like frame (compact_chunks 1, 4 and 8, with the live rays a
  bounce), the reordered loop's live-prefix chunks on the city_xl_like
  1080p frame (reorder_compact_chunks 1 and 4), the whitted batch sort on
  stand-in roomglass 512^2 at depth 3 (queue iterations, K1/K2/K3 per
  launch on every call), the threefry sampler against the hash on the
  1080p frame (the mean within 4 standard errors of the hash frames'),
  and the 1080p fused step with importance = 8 on its long-span bins
  against uniform nodes (K4 at the probes' shape beside index_select):
  each held to the plain versions, timed, counted, with the device's busy
  share under torch.profiler;
* the JAX package's last switches (``switches_phase``, [30]): K1's two
  variants, ``traverse(count_iters=True)`` (each ray's trips) and
  ``ablate=("norm",)`` (no normal epilogue), on the monu-like and the
  city_xl_like 1080p primary rays, each held to its plain version (the
  trips identical; hit, t, vol and cell K1's own), timed per launch in
  turns with K1, with the trips a ray and the warps' divergence factor
  (``trip_stats``); the 1080p fused step under each of the relaxed
  march's six ``_ABLATE_*`` flags and under none (step ms, the
  gradient's device ms and busy share, launches); the dense per-pair
  gradient on the largest 1080p band that fits, with and without
  ``_REMAT`` (peak memory, ms, the gradients within relative L2 1e-6).

The launch counters show that each path went through its kernels, and
whole images (path, whitted, reproject) and a whole gradient through the
kernels are compared with ones through the plain versions.  Beside each
kernel's time stand its bound, the larger of its bytes over 3.35 TB/s and
its 32-bit operations over 67 T/s (the H100's HBM and fp32 peaks; for
the walks of K1-K3 the operations are the plain walk's step counts on the
same rays times each step's operations counted from csrc/traverse.cu, and
for K1 and K2 only the work the call needs at least: see
``least_traversal_ops``), and the time of one PyTorch call that computes
the same function, where there is one.

Tolerances: hit, vol, cell and in_vol identical; t within rtol = atol =
1e-6; normals within 1e-5 (the kernel takes rsqrtf, as the plain
version's torch.rsqrt does on the card); lookup rows and probe results identical;
the random streams' draws identical bit for bit (int32 views); lookup backward per entry within 1e-5 * (sum of
|ct| over that entry's rows) + 1e-6 (the kernel adds in no fixed order;
at the captured shapes the plan's accumulator is held to it and the
other one's error is reported beside it); forward images (and the
reproject history): at most 0.1% of pixels off by more than 1e-3
(whitted's per-pixel scatter-add runs in no fixed order); gradients:
relative L2 <= 1e-4 on both parameters and relaxed images within 1e-5.
Kernel, plain and library times are per launch (``per_launch``): R
back-to-back calls between one pair of CUDA events, R doubled until the
window is at least 1 ms, the median of 5 windows (3 for the probes' plain
loops) divided by R, with a spin kernel ahead of each window so that the
events time the device; beside each, the host microseconds per call (a
host clock around the R enqueues). K1, K2, K4 and K4-bwd are also timed
on the calls the path really makes, captured from one 1080p frame, one
whitted 512x512 frame and one binned gradient: K1 and K2 on every call,
each held against the plain version (whose walk steps give the call's
bound); K4 and K4-bwd at the largest call of each table shape, K4-bwd
also on one-signed rows at the brick-sigma shape.  K3 is timed on every
exit call of the whitted frame, one media 256x256 path frame and two
media reproject frames, beside an empty launch of the same grid (the
launch floor); of a ray that does not march K3 returns zeros where the
plain version returns its entry t, which no caller reads, so K3 is held
to the plain version on the marching rays (and in in_vol and cell
everywhere).  With ``--baseline DIR`` (an unpacked checkout of an
earlier commit) the script also times that checkout's K1, K2, K3, K4,
K4-bwd, P1 and P4 (at B = 32, 256 and 1024) on the same inputs, in turns
with this one's (baseline, this, this, baseline), prints its ptxas
report, and times the 1080p frame with its K1/K2 swapped in, in turns.
Step times are host clocks around synchronised runs, 1 warm-up and 3
reps.

Phases print their results as they go.  Before the last line come one
JSON line with the per-kernel results and one line with the card's name
and power limit; the last line is {"ok": true, "device": {...}}.  Any
failed check raises, so the exit code is not 0.  Without a CUDA device
it exits with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
OPS_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
# 32-bit operations per unit of the walk of csrc/traverse.cu, counted from
# its source (each add, multiply, compare, select, logic op, load,
# conversion or division one), per unit of dda_occ.STEPS: the entry test
# of a (ray, volume) pair (object_ray + entry_t), a walk's set-up (six
# setup_axis and the volume's sizes; the walk reuses the entry test's
# object-space ray, whose 54 operations are the entry test's), an outer
# iteration (brick index and one bit of the brick bitmask), a descent
# (three axes re-seeded), a fine cell step and a macro brick step
WALK_OPS = dict(entries=120, walks=146, rows=12, descends=54, cells=41, bricks=17)
# operations of a world-space slab test of one (ray, volume) pair, the
# least that tells whether a ray may enter a volume: six subtract-multiply
# pairs, a min and a max per axis, four to combine them, two compares
BOX_OPS = 24


# ---- stand-in .vox files: what the asset presets and the game load, made
# from a seed (the MagicaVoxel files are not in the repository)

# file -> (size x, y, z; vox z is up), chunks besides SIZE/XYZI/RGBA
STANDIN_FILES = {
    "teapot.vox": ((126, 80, 61), ()),           # the real teapot's size
    "room.vox": ((120, 120, 90), ()),
    "roomGlass.vox": ((120, 120, 90), ()),
    "monu1.vox": ((48, 48, 64), ("nTRN",)),      # scene-graph chunks to skip
    "monu2.vox": ((64, 40, 60), ()),
    "monu3.vox": ((72, 50, 64), ()),             # wider than 64: downscaled
    "SmallBuilding01.vox": ((40, 40, 50), ()),
    "SmallBuilding02.vox": ((48, 36, 40), ("IMAP",)),
    "TallBuilding01.vox": ((80, 80, 120), ()),   # wider than 64: downscaled
    "player.vox": ((16, 16, 16), ()),
    "Text.vox": ((40, 6, 12), ("nTRN",)),
    "textWin.vox": ((60, 6, 14), ()),
}


def _vox_bytes(size, vox, palette, imap=None, graph=False):
    """A MagicaVoxel file: MAIN with SIZE, XYZI, optional scene-graph
    chunks (nTRN, nGRP, nSHP), RGBA and optional IMAP."""
    import struct

    import numpy as np

    def chunk(cid, content, children=b""):
        return cid + struct.pack("<ii", len(content), len(children)) + content + children

    kids = chunk(b"SIZE", struct.pack("<iii", *size))
    kids += chunk(b"XYZI", struct.pack("<i", len(vox)) + np.asarray(vox, np.uint8).tobytes())
    if graph:  # a transform node, a group and a shape: metadata the parsers skip
        kids += chunk(b"nTRN", struct.pack("<iiiiii", 0, 0, 1, -1, 0, 1) + struct.pack("<i", 0))
        kids += chunk(b"nGRP", struct.pack("<iii", 1, 0, 1) + struct.pack("<i", 2))
        kids += chunk(b"nSHP", struct.pack("<iiiii", 2, 0, 1, 0, 0))
    kids += chunk(b"RGBA", np.asarray(palette, np.uint8).tobytes())
    if imap is not None:
        kids += chunk(b"IMAP", np.asarray(imap, np.uint8).tobytes())
    return b"VOX " + struct.pack("<i", 150) + chunk(b"MAIN", b"", kids)


def _standin_grid(name, size, rng):
    """A model's voxel colour indices, uint8 [x, y, z] (0 empty)."""
    import numpy as np

    sx, sy, sz = size
    x, y, z = np.meshgrid(np.arange(sx), np.arange(sy), np.arange(sz), indexing="ij")
    g = np.zeros(size, np.uint8)
    pad = rng.integers(16, 255, size).astype(np.uint8)  # pad materials: palette colours
    if name == "teapot.vox":  # body, lid knob, spout and handle
        body = ((x - 63) / 42.0) ** 2 + ((y - 40) / 34.0) ** 2 + ((z - 24) / 22.0) ** 2 <= 1.0
        knob = ((x - 63) ** 2 + (y - 40) ** 2 <= 36) & (z >= 44) & (z < 52)
        spout = (np.abs(y - 40) <= 4) & (np.abs((z - 20) - 0.9 * (x - 100)) <= 4) & (x >= 96)
        handle = (np.abs(y - 40) <= 3) & (np.abs(np.hypot(x - 20, z - 26) - 11) <= 3) & (x < 24)
        g[body | knob | spout | handle] = 17 + (z[body | knob | spout | handle] // 8)
    elif name in ("room.vox", "roomGlass.vox"):  # glass floor, walls, a mirror, boxes
        wall = (x < 3) | (y < 3) | (x >= sx - 3) | (y >= sy - 3)
        g[wall] = pad[wall]
        g[(x < 3) & (y > 30) & (y < 90) & (z > 20) & (z < 70)] = 7       # mirror
        g[z < 3] = 8                                                    # glass floor
        for i, (cx, cy, m) in enumerate(((60, 60, 1), (85, 40, 5), (40, 85, 3))):
            g[(np.abs(x - cx) < 10) & (np.abs(y - cy) < 10) & (z >= 3) & (z < 20 + 8 * i)] = m
        if name == "roomGlass.vox":
            g[((x - 70) ** 2 + (y - 75) ** 2 + (z - 30) ** 2) < 144] = 8  # a glass ball
    elif name.startswith("monu"):  # a stepped base, a shaft with noise, a cap
        cx, cy = sx // 2, sy // 2
        r = np.maximum(np.abs(x - cx), np.abs(y - cy))
        step = r <= np.maximum(sx, sy) // 2 - 2 - z // 4
        shaft = (r <= sx // 6) & (rng.random(size) < 0.9)
        cap = (z >= sz - 8) & (r <= sx // 4)
        solid = (step & (z < sz // 4)) | shaft | cap
        g[solid] = 20 + (z[solid] * 3) // sz + 10 * int(name[4])
    elif "Building" in name:  # a shell with windows and a roof
        shell = ((x == 1) | (y == 1) | (x == sx - 2) | (y == sy - 2)) & (x >= 1) & (y >= 1) \
            & (x <= sx - 2) & (y <= sy - 2) & (z < sz - 4)
        windows = (z % 6 >= 2) & (z % 6 < 4) & ((x + y) % 5 < 2)
        roof = (z >= sz - 4) & (z < sz - 2) & (x >= 1) & (y >= 1) & (x <= sx - 2) & (y <= sy - 2)
        g[shell & ~windows] = 40 + (x[shell & ~windows] + y[shell & ~windows]) % 12
        g[shell & windows] = 7
        g[roof] = pad[roof]
    elif name == "player.vox":  # a cube with a SMOKE_PLAYER core showing on one face
        g[2:14, 2:14, 2:14] = 24
        g[4:12, 4:12, 4:14] = 14
    else:  # Text / textWin: letter strokes
        stroke = (x % 8 < 5) & ((z % 6 < 2) | (x % 8 < 2)) & (y >= 1) & (y < sy - 1)
        g[stroke] = 30
    return g


def write_standin_assets(directory, seed):
    """Write a stand-in for every .vox file the asset presets and the game
    load (STANDIN_FILES) into `directory`, from numpy's default_rng(seed):
    teapot.vox at the real model's 126x80x61; room.vox and roomGlass.vox
    with a GLASS (palette index 8) floor, a mirror (7) and boxes;
    monu1-3.vox, SmallBuilding01/02.vox and TallBuilding01.vox (monu3 and
    TallBuilding01 wider than 64, so grid_from_vox downscales them at
    gridsize 64); player.vox with a SMOKE_PLAYER (14) core; Text.vox and
    textWin.vox.  Palettes are random colours; SmallBuilding02.vox carries
    an IMAP chunk and monu1.vox and Text.vox scene-graph chunks.  The
    directory is made if missing.  -> the paths written."""
    import os

    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    paths = []
    for name, (size, extra) in STANDIN_FILES.items():
        g = _standin_grid(name, size, rng)
        xs, ys, zs = np.nonzero(g)
        vox = np.stack([xs, ys, zs, g[xs, ys, zs]], axis=1).astype(np.uint8)
        palette = rng.integers(40, 256, (256, 4)).astype(np.uint8)
        palette[:, 3] = 255
        palette[13] = (255, 200, 230, 255)  # colour index 14 (SMOKE_PLAYER): bright
        imap = None
        if "IMAP" in extra:
            # a display order: MagicaVoxel's identity order (1, 2, ..., 255,
            # 0) with colours 17..255 shuffled; 0 stays last, so empty
            # cells stay empty
            imap = ((np.arange(256) + 1) & 0xFF).astype(np.uint8)
            imap[16:255] = rng.permutation(imap[16:255])
        path = os.path.join(directory, name)
        with open(path, "wb") as f:
            f.write(_vox_bytes(size, vox, palette, imap, graph="nTRN" in extra))
        paths.append(path)
    return paths


_T0 = time.perf_counter()


def log(*a):
    """Print a line; a phase's line ("[n] ...") gets the seconds since the
    script started."""
    if a and isinstance(a[0], str) and a[0].startswith("["):
        a = (f"{a[0]} [t+{time.perf_counter() - _T0:.0f} s]",) + a[1:]
    print(*a, flush=True)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_, ops):
    """The least time the card could take -> (ms, "bytes" or "operations",
    the bytes' ms, the operations' ms)."""
    by_bytes, by_ops = nbytes_ / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations",
            by_bytes, by_ops)


def walk_ops(tally):
    return sum(WALK_OPS[k] * n for k, n in tally.items())


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


_CYCLES_PER_MS = []


def _hold_stream(ms):
    """Keep the current stream busy for about `ms` with a spin kernel."""
    import torch

    if not _CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS.append(10 ** 7 / start.elapsed_time(end))
    torch.cuda._sleep(int(ms * _CYCLES_PER_MS[0]))


def per_launch(fn, windows=5, min_window_ms=1.0, max_calls=512):
    """Per-launch device time and host time of fn() -> (ms, host us).

    After a warm-up, R back-to-back calls run between one pair of CUDA
    events, R doubled from 1 until the window is at least `min_window_ms`
    (or R reaches `max_calls`, which keeps the calls inside the launch
    queue); then the median of `windows` such windows, divided by R.
    Before each window a spin kernel holds the stream for twice the host
    time the R calls took last, so the events time the device and not the
    host's enqueue. The host time is a host clock around the R enqueues,
    read before the synchronise (median of the windows, divided by R)."""
    import torch

    fn()
    torch.cuda.synchronize()
    host_ms = 0.0

    def window(r):
        nonlocal host_ms
        _hold_stream(min(2.0 * host_ms * r + 0.2, 100.0))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(r):
            fn()
        host = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        host_ms = host / r
        return start.elapsed_time(end), host

    r = 1
    while window(r)[0] < min_window_ms and r < max_calls:
        r *= 2
    dev, host = zip(*(window(r) for _ in range(windows)))
    return statistics.median(dev) / r, statistics.median(host) / r * 1e3


def _module_of(root, name):
    """Module `name` of the package of another checkout at `root` (an
    unpacked ``git archive`` of an earlier commit), imported beside this
    one's: it builds its own kernels into `root`/build."""
    import importlib

    def ours():
        return {m: mod for m, mod in sys.modules.items()
                if m == "voxtracer_torch" or m.startswith("voxtracer_torch.")}

    saved = ours()
    for m in saved:
        del sys.modules[m]
    sys.path.insert(0, os.path.abspath(root))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)
        for m in ours():
            del sys.modules[m]
        sys.modules.update(saved)


def lookup_of(root):
    """The ``voxtracer_torch.kernels.lookup`` module of the checkout at `root`."""
    return _module_of(root, "voxtracer_torch.kernels.lookup")


def probes_of(root):
    """The ``voxtracer_torch.kernels.probes`` module of the checkout at `root`."""
    return _module_of(root, "voxtracer_torch.kernels.probes")


def traverse_of(root):
    """The ``voxtracer_torch.kernels.traverse`` module of the checkout at
    `root`; its ``traverse`` takes explicit t_limit and vol_enabled tensors."""
    return _module_of(root, "voxtracer_torch.kernels.traverse")


def in_turns(run, run_base):
    """Per-launch times of run (and, with run_base, run_base in turns:
    baseline, this, this, baseline) -> (this one's (ms, host us), the turns
    dict or None)."""
    if run_base is None:
        return per_launch(run), None
    b0, k0, k1, b1 = (per_launch(f) for f in (run_base, run, run, run_base))
    return k0, dict(this=[k0, k1], baseline=[b0, b1])


def turns_text(turns):
    if not turns:
        return ""
    seq = turns["baseline"][:1] + turns["this"] + turns["baseline"][1:]
    return ("; in turns baseline, this, this, baseline: "
            + ", ".join(f"{ms:.4f} ms ({us:.1f} us host)" for ms, us in seq))


def _mangled_names(mangled):
    """The length-prefixed names at the head of an Itanium-mangled symbol
    ("_ZN41_GLOBAL__N__..18lane_gather_kernelILb1E..." -> ["_GLOBAL__N__..",
    "lane_gather_kernel"])."""
    names, i = [], len(re.match(r"_ZN?", mangled).group(0)) if mangled.startswith("_Z") else 0
    while (m := re.match(r"\d+", mangled[i:])):
        n, i = int(m.group(0)), i + m.end()
        names.append(mangled[i:i + n])
        i += n
    return names


def ptxas_functions(text):
    """ptxas' -v report (the build's .log) per compiled function -> a list
    of dicts (name, stack, spill_stores, spill_loads, registers); the
    instances of traverse_kernel<mode> are named so, K1's variants
    traverse_kernel<nearest, count | no_normals>."""
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mangled = m.group(1)
            t = re.search(r"traverse_kernelILi(\d+)E(?:Li(\d+)E)?", mangled)
            if t:
                var = int(t.group(2) or 0)
                flags = [f for bit, f in ((1, "count"), (2, "no_normals")) if var & bit]
                name = (f"traverse_kernel<{('nearest', 'occluded')[int(t.group(1))]}"
                        + (f", {' | '.join(flags)}" if flags else "") + ">")
            else:
                name = next((n for n in reversed(_mangled_names(mangled)) if "kernel" in n),
                            mangled)
                form = re.search(r"(?:lane_gather|alu_loop)_kernelILb(\d)E", mangled)
                chain = re.search(r"chain_gather_kernelILi(\d+)ELb(\d)E", mangled)
                draw = re.search(r"rng_kernelI.*?E(\d)E.*?E(\d)E", mangled)
                if form:  # the two forms of P1's and P4's step
                    name += ("<few ops>", "<short chain>")[int(form.group(1))]
                elif chain:  # P3's copies of its table and form of its step
                    name += (f"<{chain.group(1)} copies, "
                             f"{('few ops', 'short chain')[int(chain.group(2))]}>")
                elif draw:  # the random streams' generator and output
                    name += (f"<{('hash', 'threefry')[int(draw.group(1))]}, "
                             f"{('uniform', 'normal')[int(draw.group(2))]}>")
            cur = dict(name=name)
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


@contextlib.contextmanager
def captured_lookups(calls, every_n=False):
    """Swap recording wrappers into the bindings through which the port
    reaches K4 and K4-bwd (the integrator's and the lookup module's own, as
    ``plain_versions`` swaps); for each (pass, K, C) keep a copy of the
    inputs of the largest call in `calls` (for the backward, the largest
    whose cotangent is not all zero), or with `every_n` of one call of
    each (pass, N, K, C) (for the backward, the first whose cotangent is
    not all zero, else the first; its plan is a function of N, K and C)."""
    from voxtracer_torch.kernels import lookup
    from voxtracer_torch.render import integrator

    kept_nonzero = {}

    def keep(key, args, nonzero=True):
        n = args[1].shape[0]
        if every_n:
            key = (key[0], n, *key[1:])
            fresh = key not in calls or (nonzero and not kept_nonzero[key])
        else:
            fresh = nonzero and (key not in calls or calls[key][1].shape[0] < n)
        if fresh:
            calls[key] = tuple(a.detach().clone() if hasattr(a, "clone") else a for a in args)
            kept_nonzero[key] = nonzero

    def fwd(fn):
        def rec(tab, idx):
            keep(("fwd", *tab.shape), (tab, idx))
            return fn(tab, idx)
        return rec

    def bwd(fn):
        def rec(ct, idx, k):
            # a segment of zero length passes an all-zero ct
            keep(("bwd", k, ct.shape[1]), (ct, idx, k), bool(ct.any()))
            return fn(ct, idx, k)
        return rec

    swaps = [(integrator, "lookup_rows", fwd), (lookup, "lookup_rows", fwd),
             (lookup, "lookup_rows_bwd", bwd)]
    kept = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in swaps]
    for mod, attr, wrap in swaps:
        setattr(mod, attr, wrap(getattr(mod, attr)))
    try:
        yield calls
    finally:
        for mod, attr, fn in kept:
            setattr(mod, attr, fn)


# the ray-side arguments of traverse(): o, d, t_limit, ray_active, vol_enabled;
# of exit_march(): o, d, ray_active, mode_code, vol_match
RAY_ARGS = range(5, 10)
# the most (volume, ray) pairs the plain walk holds at a time
PLAIN_PAIRS = 8 << 20


@contextlib.contextmanager
def captured_traversals(calls):
    """Swap recording wrappers into the bindings through which the port
    reaches K1, K2 (the integrator's and the relaxed march's, as
    ``plain_versions`` swaps) and K3 (the integrator's) and append each
    call to `calls` as (mode, args), mode "exit" for K3: a copy of its
    ray-side arguments (None kept), the scene's tensors as they are."""
    from voxtracer_torch.diff import volumetric
    from voxtracer_torch.render import integrator

    def copied(args):
        return tuple(a.detach().clone() if i in RAY_ARGS and a is not None else a
                     for i, a in enumerate(args))

    def wrap(fn):
        def rec(*args, mode="nearest"):
            calls.append((mode, copied(args)))
            return fn(*args, mode=mode)
        return rec

    def wrap_exit(fn):
        def rec(*args):
            calls.append(("exit", copied(args)))
            return fn(*args)
        return rec

    kept = [(mod, "traverse", mod.traverse) for mod in (integrator, volumetric)]
    kept.append((integrator, "exit_march", integrator.exit_march))
    for mod, attr, fn in kept:
        setattr(mod, attr, (wrap_exit if attr == "exit_march" else wrap)(fn))
    try:
        yield calls
    finally:
        for mod, attr, fn in kept:
            setattr(mod, attr, fn)


def explicit(args):
    """traverse() arguments with t_limit None as BIG and vol_enabled None
    as every volume (what an earlier checkout's traverse takes)."""
    import torch

    from voxtracer_torch.kernels.dda import BIG

    a = list(args)
    if a[7] is None:
        a[7] = torch.full((a[5].shape[0],), BIG, dtype=torch.float32, device=a[5].device)
    if a[9] is None:
        a[9] = torch.ones(a[1].shape[0], dtype=torch.bool, device=a[5].device)
    return tuple(a)


def same_traversal(k, p, what):
    """K1's or K2's result k against its plain version's p: hit, vol and
    cell identical, t within 1e-6, normals within 1e-5 -> the largest
    error of t and the normals."""
    import torch

    fields = ("hit",) if len(k) == 1 else ("hit", "vol", "cell")
    for f in fields:
        check(torch.equal(k[f], p[f].to(k[f].dtype)), f"{what}: {f} differs")
    if len(k) == 1:
        return 0.0
    check(torch.allclose(k["t"], p["t"], rtol=1e-6, atol=1e-6), f"{what}: t")
    nerr = max(max_err(k[c], p[c]) for c in ("nx", "ny", "nz"))
    check(nerr <= 1e-5, f"{what}: normals {nerr}")
    return max(nerr, max_err(k["t"], p["t"]))


def plain_traversal(args, mode, **variant):
    """The plain version of one K1 or K2 call (``variant``: traverse's
    count_iters or ablate).  It holds [V, N] pair tensors, so only the
    active rays walk (an idle ray's result is a miss: t BIG, vol -2, cell
    MAT_NONE, a zero normal, 0 trips), at most PLAIN_PAIRS (volume, ray)
    pairs at a time; the trips of count_iters come from one walk of all
    rays (``dda_occ.walk_trips`` takes each volume's entering rays alone)."""
    import torch

    from voxtracer_torch.core.types import MAT_NONE
    from voxtracer_torch.kernels import traverse
    from voxtracer_torch.kernels.dda import BIG
    from voxtracer_torch.kernels.dda_occ import walk_trips

    n, chunk = args[5].shape[0], max(4096, PLAIN_PAIRS // args[1].shape[0])
    if n <= chunk:
        return traverse.traverse_plain(*args, mode=mode, **variant)
    rays = args[8].nonzero()[:, 0]
    parts = []
    for i in range(0, rays.shape[0], chunk):
        a, sub = list(args), rays[i:i + chunk]
        for j in (5, 6, 7, 8):
            a[j] = None if args[j] is None else args[j][sub]
        parts.append(traverse.traverse_plain(*a, mode=mode, ablate=variant.get("ablate", ())))
    dev = args[5].device
    out = dict(hit=torch.zeros(n, dtype=torch.bool, device=dev))
    if mode == "nearest":
        out.update(t=torch.full((n,), BIG, device=dev),
                   cell=torch.full((n,), MAT_NONE, dtype=torch.int32, device=dev),
                   vol=torch.full((n,), -2, dtype=torch.int32, device=dev),
                   **{c: torch.zeros(n, device=dev) for c in ("nx", "ny", "nz")})
    for f in out:
        if parts:
            out[f][rays] = torch.cat([p[f] for p in parts]).to(out[f].dtype)
    if variant.get("count_iters"):
        out["iters"] = walk_trips(*explicit(args))
    return out


def same_exit(k, p, act, what):
    """K3's result k against its plain version's p on the rays that march
    (`act`): in_vol and cell identical, t within 1e-6, normals within 1e-5;
    on every ray in_vol and cell identical, and zeros from the kernel where
    the plain version leaves an idle ray's entry t (no caller reads it)
    -> the largest error of t and the normals."""
    import torch

    for f in ("in_vol", "cell"):
        check(torch.equal(k[f], p[f].to(k[f].dtype)), f"{what}: {f} differs")
    check(torch.allclose(k["t"][act], p["t"][act], rtol=1e-6, atol=1e-6), f"{what}: t")
    nerr = max(max_err(k[c][act], p[c][act]) for c in ("nx", "ny", "nz"))
    check(nerr <= 1e-5, f"{what}: normals {nerr}")
    for f in ("t", "nx", "ny", "nz"):
        check(not bool(k[f][~act].any()), f"{what}: {f} of an idle ray is not 0")
    return max(nerr, max_err(k["t"][act], p["t"][act]))


def least_traversal_ops(args, mode, out):
    """The operations one K1 or K2 call needs at least, from the plain walk
    of each enabled volume alone (per-ray step counts, so no volume's walk
    is cut short or lengthened by another's): per active ray,
    * K1: a box test per enabled volume, then the entry test and the walk
      of each volume the ray enters no later than its nearest hit, each
      walk only up to that hit (the limit just above it, as the kernel's);
    * K2, a ray that is occluded: one box test, the entry test and the walk
      to its hit of the volume where that costs least;
    * K2, a ray that is not: a box test per enabled volume, then the entry
      test and the walk to t_limit of every volume it enters before it.
    -> (operations, the per-step counts summed over what was counted)."""
    import torch

    from voxtracer_torch.kernels import traverse
    from voxtracer_torch.kernels.dda import BIG
    from voxtracer_torch.kernels.dda_occ import STEPS, entry_t

    g, gs, inv, fwd, cmin, o, d, tl, act, ven, occ, bsz = args
    v, n = gs.shape[0], o.shape[0]
    if tl is None:
        tl = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    if mode == "nearest":
        above = torch.nextafter(out["t"], torch.full_like(out["t"], math.inf))
        tl = torch.where(out["hit"], torch.minimum(tl, above), tl)
    g3 = g.shape[0] // v
    # per ray: the walks' cost and steps summed over the volumes counted; for
    # K2 the cheapest walk to a hit and its steps
    total = torch.zeros(n, dtype=torch.int64, device=o.device)
    steps = torch.zeros((len(STEPS), n), dtype=torch.int64, device=o.device)
    cheap = torch.full((n,), torch.iinfo(torch.int64).max, device=o.device)
    cheap_steps = torch.zeros_like(steps)
    enabled = 0
    for i in range(v):
        if ven is not None and not bool(ven[i]):
            continue
        enabled += 1
        # only the rays that enter the volume's cube walk it (the walk's own
        # entry test): the others cost no walk, and are left out of it
        sub = (act & (entry_t(inv[i:i + 1], cmin[i:i + 1], o, d)[0] < 1e33)).nonzero()[:, 0]
        if sub.numel() == 0:
            continue
        rt = {}
        r = traverse.traverse_plain(g[i * g3:(i + 1) * g3], gs[i:i + 1], inv[i:i + 1],
                                    fwd[i:i + 1], cmin[i:i + 1], o[sub], d[sub], tl[sub],
                                    act[sub], None, occ[:, i:i + 1], bsz[i:i + 1],
                                    mode="occluded", ray_tally=rt)
        # the entry test only for the pairs walked
        rt["entries"] = rt["walks"]
        st = torch.stack([rt[k] for k in STEPS])
        cost = sum(WALK_OPS[k] * rt[k] for k in STEPS)
        total[sub] += cost
        steps[:, sub] += st
        if mode == "occluded":
            better = r["hit"] & (cost < cheap[sub])
            cheap[sub] = torch.where(better, cost, cheap[sub])
            cheap_steps[:, sub] = torch.where(better[None], st, cheap_steps[:, sub])
    if not enabled:
        return 0, dict.fromkeys(STEPS, 0)
    boxes = BOX_OPS * enabled * act.long()
    if mode == "occluded":
        # an occluded ray: one box test and only its cheapest volume to a hit
        occluded = cheap < torch.iinfo(torch.int64).max
        total = torch.where(occluded, cheap, total)
        steps = torch.where(occluded[None], cheap_steps, steps)
        boxes = torch.where(occluded, BOX_OPS, boxes)
    ops = int(boxes.sum()) + int(total.sum())
    return ops, dict(zip(STEPS, steps.sum(1).tolist()))


def traverse_bound(args, out, mode, least=None):
    """The bound of one traverse() call: the bytes of its active rays
    (origin, direction, t limit where given), the active flags, the enabled
    flags where given, the occupancy plane it walks, its outputs and one
    grid cell per nearest hit; the operations it needs at least
    (``least_traversal_ops``, or `least` if given) -> (bound, the least
    work's step counts)."""
    o, t_limit, act, ven, occ = args[5], args[7], args[8], args[9], args[10]
    na = int(act.sum())
    by = act.numel() + na * (24 + (4 if t_limit is not None else 0)) + nbytes(occ[0])
    by += nbytes(*out.values()) + (ven.numel() if ven is not None else 0)
    if "t" in out:
        by += 4 * int(out["hit"].sum())
    ops, steps = least or least_traversal_ops(args, mode, out)
    return bound(by, ops), steps


def exit_bound(args, out, tally):
    """The bound of one exit_march() call: the bytes of its marching rays
    (origin, direction, medium code, volume), the active flags, the two
    exit planes, its outputs and one grid cell per ray that left its medium
    inside the grid; the operations of the plain walk's steps (`tally`)."""
    act, occ = args[7], args[10]
    by = act.numel() + 32 * int(act.sum()) + nbytes(occ[1:]) + nbytes(*out.values())
    return bound(by + 4 * int(out["in_vol"].sum()), walk_ops(tally))


# 32-bit operations an element of each draw of csrc/rng.cu, counted from
# its source (each of logf, log1pf, cosf and a square root one: a lower
# bound): hash bits 18 (two PCG steps of 8, two xors), threefry bits 73
# (two key adds, 20 rounds of add, rotate, xor, five injections of two
# adds, the final xor); a uniform 3 more, a Box-Muller normal 7 more over
# two uniforms, an erf_inv normal 40 more
RNG_OPS = dict(hash_uniform=21, hash_normal=49, threefry_uniform=76, threefry_normal=116)


def rng_draws(dev, key, n, report):
    """The random streams' kernel (csrc/rng.cu) at the 1080p frames'
    shapes, each draw held bit for bit (int32 views) to its plain torch ops
    and timed per launch against them: the path's hash normals (3, n) and
    uniforms (n, 2) and (3, n); the reprojected frame's threefry normals
    (n, 3) and uniforms (n, 2) and (n, 3).  One ``report`` entry a
    generator: the first draw's times, every draw's under ``draws``."""
    import torch

    from voxtracer_torch.core import rng

    salt_key = {"hash": (key, 4), "threefry": (rng.fold_in(key, 4),)}
    for gen, draws in (("hash", (("normal", (3, n)), ("uniform", (n, 2)), ("uniform", (3, n)))),
                       ("threefry", (("normal", (n, 3)), ("uniform", (n, 2)),
                                     ("uniform", (n, 3))))):
        entries = []
        for out, shape in draws:
            name = f"{gen}_{out}"
            args = (*salt_key[gen], shape, dev)
            got = getattr(rng, name)(*args)
            want = getattr(rng, name + "_plain")(*args)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"{name} {shape}: the kernel is not its plain version bit for bit")
            kern = per_launch(functools.partial(getattr(rng, name), *args))
            plain = per_launch(functools.partial(getattr(rng, name + "_plain"), *args),
                               windows=3)
            bnd = bound(nbytes(got), RNG_OPS[name] * got.numel())
            entries.append((name, shape, kern, plain, bnd))
        name, shape, kern, plain, bnd = entries[0]
        report(f"rng_{gen}", "voxtracer_torch/csrc/rng.cu",
               "none: XLA elementwise ops of voxtracer/core/rng.py", 0.0, kern, plain, bnd,
               None, draws=[dict(draw=d, shape=list(s), ms=k[0], host_us=k[1], plain_ms=p[0],
                                 plain_host_us=p[1], bound_ms=b[0], bound_by=b[1])
                            for d, s, k, p, b in entries])
        for d, s, k, p, b in entries:
            log(f"    {d} {tuple(s)}: kernel {k[0]:.4f} ms ({k[1]:.1f} us host) = "
                f"{b[0] / k[0]:.0%} of bound {b[0]:.4f} ms ({b[1]}), plain {p[0]:.4f} ms "
                f"({p[1]:.1f} us host)")


def clone_bounce(b):
    """A copy of a ``kernels.bounce.Bounce`` whose every tensor it writes is
    its own (the draws, the lights and K3's and K2's results are shared)."""
    import copy

    c = copy.copy(b)
    c.pk = b.pk.clone()
    c.rec = {k: v.clone() for k, v in b.rec.items()}
    for name in ("sh_o", "sh_d", "sh_t", "need", "nee_val", "lk_d", "lk_t", "lk_need",
                 "go_diffuse", "nee_mask", "lk_val", "march", "mode", "out_in_glass",
                 "out_active", "out_in_light"):
        x = getattr(b, name)
        setattr(c, name, None if x is None else x.clone())
    c.c = None
    return c


def bounce_bytes(stage, b):
    """The bytes a shading kernel of csrc/bounce.cu reads and writes on b
    with the random light (one shadow segment a ray), the buffers as they
    stand before it runs (the rays taking each branch counted from them):
    every ray's flags, and each active ray's state rows, hit record,
    material row, draws and outputs."""
    pk, n, rec = b.pk, b.n, b.rec
    act = int((pk[13] > 0.5).sum())
    if stage == "bounce_hit":
        miss = int(((pk[13] > 0.5) & (rec["mat"] == 255)).sum())
        emis = int(((pk[13] > 0.5) & (rec["mat"] == 15)).sum())
        return n * 13 + act * 13 + miss * 52 + emis * 52
    lk = 1 if b.has_lk else 0
    if stage == "bounce_nee":
        area = b.draws.g_nee is not None
        march = int(b.march.sum())
        per = 4 + 4 + 12 + 12 + 12 + 12 + 1 + 4 + 4 + 12 + 12 + 4 + 1 + 12 + 2 + (12 if area else 0)
        per += lk * (4 + 4 + 12 + 4 + 1 + 12 + (12 if area else 0))
        return n * 4 + (n - act) * (3 + lk) + act * per + march * 33
    scatter_max = int(((pk[13] > 0.5) & (rec["mat"] >= 9) & (rec["mat"] <= 14)).sum())
    per = 4 + 24 + 4 + 12 + 12 + 12 + 12 + 12 + 2 + 2 + 12 + 12 + 12 + 4 + 8 + 1
    per += 12 * 4 + 4 + 4 + 2 + lk * (1 + 1 + 12 + 4 + 1)
    return n * (8 + 4 * lk) + (n - act) * (2 + lk) + act * per + scatter_max * 12


def bounce_stages(dev, scene, cfg, key, report, depths=(0, 1)):
    """The bounce's shading kernels (csrc/bounce.cu) at the 1080p frame's
    shapes: each stage's buffers captured on bounces `depths` of the frame,
    the kernel held bit for bit to its plain version (``kernels.bounce``
    ``*_plain``) on a copy of them, and timed per launch against it; a
    stage writes its buffers in place, so each call first restores the
    packed state (the copy timed alone and taken off both).  The whole
    bounce is held bit for bit to the bounce on the plain stages
    (``bounce.PLAIN``) on a copy of the packed state.  One ``report``
    entry a kernel: bounce 0's times, every bounce's under ``bounces``."""
    import torch

    from voxtracer_torch.core.rng import fold_in
    from voxtracer_torch.kernels import bounce
    from voxtracer_torch.render import integrator
    from voxtracer_torch.render.camera import primary_rays

    n = cfg.width * cfg.height
    py, px = torch.meshgrid(torch.arange(cfg.height, dtype=torch.float32, device=dev) + 0.5,
                            torch.arange(cfg.width, dtype=torch.float32, device=dev) + 0.5,
                            indexing="ij")
    o, d = primary_rays(scene.camera, cfg.width, cfg.height, px.reshape(-1), py.reshape(-1))
    pk, active = integrator._first_path(cfg, o, d)
    stage_of = {"bounce_hit": (bounce.hit, bounce.hit_plain),
                "bounce_nee": (bounce.nee, bounce.nee_plain),
                "bounce_continue": (bounce.continue_, bounce.continue_plain)}
    entries = {name: [] for name in stage_of}
    for depth in range(max(depths) + 1):
        bkey = fold_in(key, depth)
        captured = {}

        def capture(name):
            def run(b):
                captured[name] = clone_bounce(b)
                stage_of[name][0](b)
            return run

        want = pk.clone()
        want_active = integrator._bounce_core(scene, cfg, want, active, bkey,
                                              stages=bounce.PLAIN)
        active = integrator._bounce_core(scene, cfg, pk, active, bkey,
                                         stages=bounce.Stages(*(capture(k) for k in stage_of)))
        check(torch.equal(pk.view(torch.int32), want.view(torch.int32))
              and torch.equal(active, want_active),
              f"bounce {depth}: the kernels' state is not the plain stages' bit for bit")
        if depth in depths:
            for name, (kern_fn, plain_fn) in stage_of.items():
                b0 = captured[name]
                bk, bp = clone_bounce(b0), clone_bounce(b0)
                kern_fn(bk)
                plain_fn(bp)
                act = b0.pk[13] > 0.5
                outs = {"pk": (bk.pk, bp.pk, None)}
                if name == "bounce_hit":
                    outs.update(march=(bk.march, bp.march, None), mode=(bk.mode, bp.mode, None))
                elif name == "bounce_nee":
                    for f in ("t", "nx", "ny", "nz"):
                        outs[f] = (bk.rec[f], bp.rec[f], None)
                    for f in ("need", "go_diffuse", "nee_mask"):
                        outs[f] = (getattr(bk, f), getattr(bp, f), None)
                    outs.update(sh_o=(bk.sh_o, bp.sh_o, act[:, None]),
                                sh_d=(bk.sh_d, bp.sh_d, act[:, None]),
                                sh_t=(bk.sh_t, bp.sh_t, act),
                                nee_val=(bk.nee_val, bp.nee_val, act[None]))
                else:
                    outs.update(in_glass=(bk.out_in_glass, bp.out_in_glass, None),
                                active=(bk.out_active, bp.out_active, None))
                for f, (x, y, m) in outs.items():
                    if x.is_floating_point():
                        x, y = x.view(torch.int32), y.view(torch.int32)
                    if m is not None:
                        x, y = torch.where(m, x, 0), torch.where(m, y, 0)
                    check(torch.equal(x, y), f"{name}, bounce {depth}: {f} is not the plain "
                                             "version's bit for bit")
                work, pk0 = clone_bounce(b0), b0.pk
                restore = per_launch(lambda: work.pk.copy_(pk0))

                def call(fn, work=work, pk0=pk0):
                    work.pk.copy_(pk0)
                    fn(work)

                kern = per_launch(functools.partial(call, kern_fn))
                plain = per_launch(functools.partial(call, plain_fn), windows=3)
                kern = (kern[0] - restore[0], kern[1])
                plain = (plain[0] - restore[0], plain[1])
                bnd = bound(bounce_bytes(name, b0), 0)
                entries[name].append(dict(bounce=depth, active=int(act.sum()), ms=kern[0],
                                          host_us=kern[1], plain_ms=plain[0],
                                          plain_host_us=plain[1], bound_ms=bnd[0],
                                          restore_ms=restore[0], kern=kern, plain=plain,
                                          bnd=bnd))
                log(f"    {name} bounce {depth} ({int(act.sum())} of {n} rays active): kernel "
                    f"{kern[0]:.4f} ms ({kern[1]:.1f} us host) = {bnd[0] / kern[0]:.0%} of "
                    f"bound {bnd[0]:.4f} ms (bytes), plain {plain[0]:.4f} ms ({plain[1]:.1f} us "
                    f"host); the state's restore {restore[0]:.4f} ms taken off both")
    for name, es in entries.items():
        e = es[0]
        report(name, "voxtracer_torch/csrc/bounce.cu",
               "none: XLA's fused elementwise ops of voxtracer/render/integrator.py _bounce_core",
               0.0, e["kern"], e["plain"], e["bnd"], None,
               bounces=[{k: v for k, v in x.items() if k not in ("kern", "plain", "bnd")}
                        for x in es])


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


@contextlib.contextmanager
def plain_versions(chunked=False):
    """Swap the plain versions in for the kernels in every binding the
    port reaches them through: the integrator's (which every renderer,
    render/reproject.py included, uses; its path bounce's shading takes
    the plain stages), the relaxed march's traversal,
    the lookup module's own names (which its autograd Function calls) and
    the random streams' ``draw`` (which every draw of core/rng.py calls).
    chunked: the integrator's K1/K2 calls go through ``plain_traversal``
    (the active rays only, at most PLAIN_PAIRS pairs at a time), which a
    1080p frame over 111 volumes needs."""
    from voxtracer_torch.diff import volumetric
    from voxtracer_torch.kernels import bounce, lookup, rng, traverse
    from voxtracer_torch.render import integrator

    def chunked_traversal(*args, mode="nearest"):
        return plain_traversal(args, mode)

    def plain_draw(*args, plain, **kw):
        return plain()

    def plain_bounce(*args, _kept=integrator._bounce_core, **kw):
        return _kept(*args, **kw, stages=bounce.PLAIN)

    swaps = [(integrator, "_bounce_core", plain_bounce),
             (integrator, "traverse", chunked_traversal if chunked else traverse.traverse_plain),
             (integrator, "exit_march", traverse.exit_march_plain),
             (integrator, "lookup_rows", lookup.lookup_rows_plain),
             (volumetric, "traverse", traverse.traverse_plain),
             (lookup, "lookup_rows", lookup.lookup_rows_plain),
             (lookup, "lookup_rows_bwd", lookup.lookup_rows_bwd_plain),
             (rng, "draw", plain_draw)]
    kept = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in swaps]
    for mod, attr, plain in swaps:
        setattr(mod, attr, plain)
    try:
        yield
    finally:
        for mod, attr, fn in kept:
            setattr(mod, attr, fn)


def pixels_off(a, b):
    """Check that at most 0.1% of pixels of two images differ by more than
    1e-3; return (that share, the largest difference)."""
    diff = (a - b).abs().amax(-1)
    frac = float((diff > 1e-3).float().mean())
    check(frac <= 1e-3, f"{frac:.4%} of pixels differ by more than 1e-3")
    return frac, float(diff.max())


def host_times(fn, reps=3):
    """fn() once to warm up, then `reps` runs timed on the host clock, each
    ending in a device synchronise -> (median, min, spread, times) in ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for rep in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times), max(times) - min(times), times


def rel_l2(a, b):
    return float((a - b).norm() / b.norm())


def replay_phases(scene, cfg, key, smi, reset_counts, counts, time_traversal, measure, bwd_err,
                  results):
    """Phases [18]-[21]: the frozen-path replay gradients and the thin-lens
    frame, on `scene` (the 1080p monu-like scene) and on 256x144 and 256^2
    scenes, with main's helpers (``smi`` is the log lines' card suffix;
    ``results`` the kernels' JSON entries) -> {path: launch counts}."""
    import numpy as np
    import torch

    from voxtracer_torch import cli
    from voxtracer_torch.core.rng import fold_in
    from voxtracer_torch.diff import path_replay, replay_active, train, volumetric
    from voxtracer_torch.kernels import lookup
    from voxtracer_torch.render import integrator
    from voxtracer_torch.scene.presets import glass_sphere_box, media_path, monu_like_path

    dev = scene.device
    n = cfg.width * cfg.height
    paths = {}

    def marches(pre):
        out = list(pre["marches"].items())
        for name, lst in pre["light_marches"].items():
            out += [(f"{name}[{i}]", m) for i, m in enumerate(lst)]
        return out

    # ---- 18. the active replay at full width, counted: the precompute
    # (hard traversals, K1) and one gradient (K4 and K4-bwd); then timed,
    # its peak memory, the FD check of scripts/bench_replay_active.py and 3
    # Adam steps toward a target rendered at the true params
    params = volumetric.params_from_scene(scene)
    pcalls, lcalls = [], {}
    reset_counts()
    t0 = time.perf_counter()
    with captured_traversals(pcalls):
        pre = replay_active.replay_precompute(scene, cfg, key)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    denom = float(n * 3)
    zero = torch.zeros((pre["n_c"], 3), device=dev)
    grad_fn, loss_fn = replay_active.make_replay_grad_fn(scene, cfg, pre, zero, denom)
    spec, arrs = replay_active.split_pre(pre)
    with captured_lookups(lcalls, every_n=True):
        g = grad_fn(params)
    torch.cuda.synchronize()
    size = f"{cfg.width}x{cfg.height}"
    paths[f"replay {size} precompute + gradient"] = launched = counts()
    for kk in ("traverse_nearest", "lookup_rows", "lookup_rows_bwd"):
        check(launched[kk] > 0, f"{kk} not launched by the replay precompute and gradient")
    for f in ("density_logits", "albedo_table"):
        gf = getattr(g, f)
        check(bool(torch.isfinite(gf).all()) and float(gf.abs().max()) > 0,
              f"replay {f} gradient is not finite or all zero")
    log(f"[18] replay precompute {cfg.width}x{cfg.height}: {pre_s:.2f} s (with copies of its "
        f"K1 calls' rays), n_hit {pre['n_hit']}, n_c {pre['n_c']}, media lanes "
        f"{pre['media_lanes']}; launches {launched}")
    for name, m in marches(pre):
        log(f"    march {name}: m {m['m']}, bins (steps, segments) "
            f"{[(st, hi - lo) for st, lo, hi in m.get('bins', [])]}")
    med, lo, spread, times = host_times(lambda: grad_fn(params))
    torch.cuda.reset_peak_memory_stats()
    grad_fn(params)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"[18] replay gradient {cfg.width}x{cfg.height}: median {med:.1f} ms, min {lo:.1f} ms, "
        f"spread {spread:.1f} ms -> {n / med / 1e3:.3f} Mrays/s; peak memory "
        f"{peak / 2**30:.2f} GiB ({peak} bytes) ({smi}); reps {times}")

    # the FD check on the strongest density cell, eps 2e-2; the loss's sum
    # taken in float64, so that the two losses' difference (one cell of a
    # 1080p frame) is not lost to the rounding of the whole frame's sum
    live = (torch.arange(pre["n_c"], device=dev) < pre["n_hit"])[:, None]

    def loss64(p):
        with torch.no_grad():
            img = replay_active.render_replay_active(p, scene, cfg, spec, arrs).double()
        return float(torch.where(live, img * img, 0.0).sum()) / denom

    gd = g.density_logits
    cell = tuple(int(i) for i in np.unravel_index(int(gd.abs().argmax()), gd.shape))
    eps = 2e-2
    vals = []
    for sgn in (1.0, -1.0):
        dl = params.density_logits.clone()
        dl[cell] += sgn * eps
        vals.append(loss64(dataclasses.replace(params, density_logits=dl)))
    fd = (vals[0] - vals[1]) / (2 * eps)
    ad = float(gd[cell])
    fd_rel = abs(fd - ad) / max(abs(fd), 1e-30)
    check(fd_rel <= 0.02, f"replay FD: fd {fd} ad {ad} relative error {fd_rel}")
    log(f"[18] replay FD, cell {cell}, eps {eps}: fd {fd:.6g}, ad {ad:.6g}, relative error "
        f"{fd_rel:.4%} (bar 2%); loss at the params {float(loss_fn(params)):.6g}")

    # 3 Adam steps (the port's optimizer, diff/train.py): target rendered at
    # the true params; start from 8 albedo rows of the hit lanes pulled to
    # grey and volume 1's density thinned (logit 6 -> 1), as
    # scripts/demo_inverse_replay.py starts
    with torch.no_grad():
        target = replay_active.render_replay_active(params, scene, cfg, spec, arrs)
    at = params.albedo_table.clone()
    rows = [int(r) for r in torch.unique(pre["m0"][pre["hit"]]) if int(r) < 255][:8]
    at[rows] = 0.5 * at[rows] + 0.25
    dl = params.density_logits.clone()
    dl[1] = torch.where(dl[1] > 0, 1.0, dl[1])
    tp = volumetric.DiffParams(density_logits=dl, albedo_table=at)
    _, init = train.make_train_step(cfg, lr=3e-2)
    opt = init(tp)
    losses, times = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = replay_active.mse_loss_replay_active(tp, scene, cfg, spec, arrs, target, denom)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        times.append((time.perf_counter() - t0) * 1e3)
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"replay Adam losses {losses}")
    log(f"[18] replay 3 Adam steps (lr 3e-2, albedo rows {rows}, volume 1 thinned): losses "
        f"{losses}; step ms {times} ({smi})")
    del tp, opt, target, g

    # ---- 19. the kernels on the replay's calls: K1 on every call of the
    # precompute; K4 and K4-bwd on every distinct shape of one gradient
    log(f"[19] K1 on the {len(pcalls)} calls of the {cfg.width}x{cfg.height} replay precompute:")
    k1 = next(r for r in results if r["name"] == "traverse_nearest")
    for i, (mode, args) in enumerate(pcalls):
        check(mode == "nearest", f"the precompute made a {mode} traversal")
        entry = time_traversal(f"replay precompute, K1 call {i}", mode, args,
                                 plain_too=i == 0)[0]
        entry["path"] = "replay precompute"
        k1.setdefault("calls", []).append(entry)
    del pcalls
    log(f"[19] K4 and K4-bwd on the {len(lcalls)} distinct call shapes of one replay gradient:")
    sms = lookup.device_consts(0)[0]
    for key_ in sorted(lcalls, key=str):
        if key_[0] == "fwd":
            tab, idx = lcalls[key_]
            got = lookup.lookup_rows(tab, idx)
            check(torch.equal(got, lookup.lookup_rows_plain(tab, idx)),
                  f"K4 rows differ at {list(tab.shape)} x {idx.shape[0]}")
            cidx = idx.clamp(0, tab.shape[0] - 1)
            *_, entry = measure(
                f"replay K4 {list(tab.shape)} x {idx.shape[0]}",
                lambda: lookup.lookup_rows(tab, idx), None,
                lambda: lookup.lookup_rows_plain(tab, idx),
                lambda: torch.index_select(tab, 0, cidx), "index_select",
                bound(nbytes(tab, idx, got), 3 * got.numel()), {})
            entry.update(path="replay gradient", max_abs_err=0.0)
            next(r for r in results if r["name"] == "lookup_rows")["shapes"].append(entry)
        else:
            ct, idx, kk = lcalls[key_]
            planned = lookup.bwd_plan(ct.shape[0], kk, ct.shape[1], sms)[0]
            zero = not bool(ct.any())
            if zero:
                # every call of this shape passed zeros (no lead or tail
                # sample of its segments lies in a grid with a length):
                # zeros back, then held on normal rows at the same ids
                check(not bool(lookup.lookup_rows_bwd(ct, idx, kk).any()),
                      f"K4-bwd of zeros at [{kk}, {ct.shape[1]}] x {idx.shape[0]}")
                gen = torch.Generator(device=dev).manual_seed(idx.shape[0])
                err, ratio = bwd_err(torch.randn(ct.shape, generator=gen, device=dev), idx,
                                       kk, planned)
            else:
                err, ratio = bwd_err(ct, idx, kk, planned)
            acc = ct.new_zeros((kk, ct.shape[1]))
            cidx = idx.clamp(0, kk - 1)
            *_, entry = measure(
                f"replay K4-bwd [{kk}, {ct.shape[1]}] x {idx.shape[0]} (acc={planned})",
                lambda: lookup.lookup_rows_bwd(ct, idx, kk), None,
                lambda: lookup.lookup_rows_bwd_plain(ct, idx, kk),
                lambda: acc.index_add_(0, cidx, ct), "f32 index_add_",
                bound(nbytes(ct, idx) + kk * ct.shape[1] * 4, 3 * ct.numel()), {})
            entry.update(path="replay gradient", plan=planned, max_abs_err=err,
                         error_over_tolerance=ratio, zero_cotangent=zero)
            log(f"      error {err:.3g}, {ratio:.3g} x the tolerance"
                + (" (the step's cotangent all zero: held on normal rows at its ids)"
                   if zero else ""))
            next(r for r in results if r["name"] == "lookup_rows_bwd")["shapes"].append(entry)
    del lcalls

    # the whole replay at 256x144 through the kernels against the plain
    # versions: the precompute's frozen structure, then the gradient and
    # the image on the kernels' precompute
    sw, sh = 256, 144
    sscene, scfg = monu_like_path(sw, sh, bounces=4)
    sscene = sscene.to(dev)
    sparams = volumetric.params_from_scene(sscene)
    spre = replay_active.replay_precompute(sscene, scfg, key)
    with plain_versions():
        ppre = replay_active.replay_precompute(sscene, scfg, key)
    for k_ in ("n_hit", "n_c"):
        check(spre[k_] == ppre[k_], f"replay precompute {k_}: kernels vs plain")
    check(torch.equal(spre["sel"], ppre["sel"]), "replay precompute sel: kernels vs plain")
    same_bins = True
    for (name, a), (_, b) in zip(marches(spre), marches(ppre)):
        check(a["m"] == b["m"], f"replay march {name}: m kernels vs plain")
        same_bins &= a.get("bins") == b.get("bins")
    sgrad, _ = replay_active.make_replay_grad_fn(
        sscene, scfg, spre, torch.zeros((spre["n_c"], 3), device=dev), float(sw * sh * 3))

    def grad_and_image():
        with torch.no_grad():
            img = replay_active.render_replay_active(sparams, sscene, scfg,
                                                     *replay_active.split_pre(spre))
        return sgrad(sparams), img

    ga, ia = grad_and_image()
    with plain_versions():
        gb, ib = grad_and_image()
    rel = {f: rel_l2(getattr(ga, f), getattr(gb, f)) for f in ("density_logits", "albedo_table")}
    for f, r in rel.items():
        check(r <= 1e-4, f"replay {f} gradient: kernels vs plain relative L2 {r}")
    idiff = max_err(ia, ib)
    check(idiff <= 1e-5, f"replay image: kernels vs plain max diff {idiff}")
    log(f"[19] replay {sw}x{sh} kernels vs plain: precompute n_hit, sel and segment counts "
        f"equal, bins {'equal' if same_bins else 'differ'}; gradient relative L2 density "
        f"{rel['density_logits']:.3g}, albedo {rel['albedo_table']:.3g}; image max diff "
        f"{idiff:.3g}")

    # the active estimator against the capability one on the non-media hit
    # lanes (tests/test_replay_active.py's bar) on that test's scene, one
    # model (monu_path's which=(1,)) and the floor; the three-model scene's
    # figures beside it, not held
    for seeds, held in (((1,), True), ((1, 2, 3), False)):
        escene, ecfg = monu_like_path(sw, sh, bounces=4, seeds=seeds)
        escene = escene.to(dev)
        ep = volumetric.params_from_scene(escene)
        epre = replay_active.replay_precompute(escene, ecfg, key)
        with torch.no_grad():
            img_a = replay_active.render_replay_active(ep, escene, ecfg,
                                                       *replay_active.split_pre(epre))
            ref = path_replay.render_diff_replay(ep, escene, ecfg, key, n_steps=48, seg_steps=24)
        dd = (img_a - ref.reshape(-1, 3)[epre["sel"].long()])[epre["hit"]].abs()
        mean, p95 = float(dd.mean()), float(torch.quantile(dd.reshape(-1), 0.95))
        if held:
            check(mean < 0.03 and p95 < 0.15, f"active vs capability: mean {mean}, p95 {p95}")
        log(f"[19] active vs capability replay {sw}x{sh}, {len(seeds)} model(s): mean "
            f"{mean:.4f}, 95th percentile {p95:.4f} ({'held to' if held else 'beside'} "
            f"0.03 / 0.15)")

    # ---- 20. the capability replay through the media chains: the media
    # scene (glass and smoke) and glassbox at 256x256, forward and gradient,
    # counted and timed; then through the plain versions
    media = 256
    for name, (mscene, mcfg) in (("media", media_path(media, media)),
                                 ("glassbox", glass_sphere_box(media, media))):
        mscene = mscene.to(dev)
        mp = volumetric.params_from_scene(mscene, occupied_logit=0.5)
        tgt = torch.zeros((mcfg.height, mcfg.width, 3), device=dev)
        vg = volumetric.value_and_grad(path_replay.mse_loss_replay)

        def fwd():
            with torch.no_grad():
                return path_replay.render_diff_replay(mp, mscene, mcfg, key)

        reset_counts()
        img = fwd()
        loss, mg = vg(mp, mscene, mcfg, tgt, key)
        torch.cuda.synchronize()
        paths[f"capability replay {name} {media}^2 forward + gradient"] = launched = counts()
        for kk in ("traverse_nearest", "exit_march", "lookup_rows", "lookup_rows_bwd"):
            check(launched[kk] > 0, f"{kk} not launched by the {name} capability replay")
        check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0.01,
              f"{name} replay image")
        fmed, flo, fspread, _ = host_times(fwd)
        gmed, glo, gspread, _ = host_times(lambda: vg(mp, mscene, mcfg, tgt, key))
        with plain_versions():
            pimg = fwd()
            _, pg = vg(mp, mscene, mcfg, tgt, key)
        frac, dmax = pixels_off(img, pimg)
        rel = {f: rel_l2(getattr(mg, f), getattr(pg, f)) for f in ("density_logits",
                                                                     "albedo_table")}
        for f, r in rel.items():
            check(r <= 1e-4, f"{name} replay {f} gradient: kernels vs plain relative L2 {r}")
        log(f"[20] capability replay {name} {media}x{media} (48 + 24 steps): image mean "
            f"{float(img.mean()):.4f}, loss {float(loss):.6g}; forward median {fmed:.1f} ms "
            f"(min {flo:.1f}, spread {fspread:.1f}), gradient median {gmed:.1f} ms (min "
            f"{glo:.1f}, spread {gspread:.1f}) ({smi}); kernels vs plain: {frac:.4%} of pixels "
            f"off by more than 1e-3 (max {dmax:.3g}), gradient relative L2 density "
            f"{rel['density_logits']:.3g}, albedo {rel['albedo_table']:.3g}; launches {launched}")

    # ---- 21. the thin-lens frame: the 1080p path frame autofocused on the
    # centre pixel with use_dof (cli render --dof's set-up), counted, timed
    # beside the pinhole frame in turns, and held to the plain versions
    dscene, focal = cli.autofocus(scene, cfg, 2.0)
    dcfg = dataclasses.replace(cfg, use_dof=True)
    reset_counts()
    dimg = integrator.render_tiled(dscene, dcfg, key, 1, 1)
    torch.cuda.synchronize()
    paths[f"dof {size} frame"] = launched = counts()
    for kk in ("traverse_nearest", "traverse_occluded", "lookup_rows"):
        check(launched[kk] > 0, f"{kk} not launched by the DOF frame")
    check(bool(torch.isfinite(dimg).all()) and 0.02 < float(dimg.mean()) < 10.0,
          f"DOF frame mean {float(dimg.mean())}")
    turns = [host_times(lambda: integrator.render_tiled(sc, cf, fold_in(key, 1), 1, 1))[0]
             for sc, cf in ((scene, cfg), (dscene, dcfg), (dscene, dcfg), (scene, cfg))]
    with plain_versions():
        pimg = integrator.render_tiled(dscene, dcfg, key, 1, 1)
    frac, dmax = pixels_off(dimg, pimg)
    log(f"[21] DOF {cfg.width}x{cfg.height} path frame, focal distance {focal:.3f}, defocus 2: "
        f"mean {float(dimg.mean()):.4f}; launches {launched}; in turns pinhole, DOF, DOF, pinhole: "
        + ", ".join(f"{ms:.1f} ms" for ms in turns) + f" ({smi}); kernels vs plain: "
        f"{frac:.4%} of pixels off by more than 1e-3 (max {dmax:.3g})")
    return paths


def asset_phases(dev, key, smi, reset_counts, counts, time_traversal, results):
    """Phases [22]-[24]: the .vox ingest, the five asset presets and the
    game, all on stand-in .vox files (``write_standin_assets``, seed 0) in
    a temporary directory, with main's helpers (``smi`` is the log lines'
    card suffix; ``results`` the kernels' JSON entries) -> {path: launch
    counts}."""
    import tempfile

    import numpy as np
    import torch

    from voxtracer_torch import cli, native
    from voxtracer_torch.config import RenderConfig
    from voxtracer_torch.core.rng import fold_in
    from voxtracer_torch.core.types import SMOKE_PLAYER
    from voxtracer_torch.game.level import Game
    from voxtracer_torch.io import vox
    from voxtracer_torch.kernels import traverse
    from voxtracer_torch.render import integrator
    from voxtracer_torch.scene import presets
    from voxtracer_torch.scene.instances import VolumeSpec, build_volumes
    from voxtracer_torch.scene.lights import make_lights
    from voxtracer_torch.scene.materials import default_materials
    from voxtracer_torch.scene.volume import solid_grid

    paths = {}
    tmp = tempfile.TemporaryDirectory()
    kept_dir = presets.ASSET_DIR
    try:
        # ---- 22. the stand-ins, parsed by the numpy and the native parser
        t0 = time.perf_counter()
        files = write_standin_assets(tmp.name, 0)
        log(f"[22] {len(files)} stand-in .vox files written in {time.perf_counter() - t0:.2f} s")
        check(native.available(), "the native .vox parser did not build")
        for path in files:
            data = open(path, "rb").read()
            (want,) = vox.parse_vox(data)[:1]
            grid, pal = native.parse_vox_native(data)
            check(np.array_equal(grid, want.grid) and np.array_equal(pal, want.palette),
                  f"{os.path.basename(path)}: the native parser differs from the numpy one")
        big = max(files, key=os.path.getsize)
        data = open(big, "rb").read()
        secs = {}
        for name, fn in (("numpy", lambda: vox.parse_vox(data)),
                         ("native", lambda: native.parse_vox_native(data))):
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            secs[name] = min(ts)
        parser = vox.load_vox_with_parser(big)[1]
        log(f"[22] every stand-in equal through both parsers; load_vox uses the {parser} "
            f"parser; {os.path.basename(big)} ({len(data)} bytes): numpy {secs['numpy']:.4f} s, "
            f"native {secs['native']:.4f} s (the fastest of 5)")

        # ---- 23. the asset presets at their own sizes: the frame cli render
        # draws (render, scanline order), counted, timed, and against the
        # plain versions: the teapot and the rooms at full size; the 1080p
        # presets at 480x270 (a plain 1080p frame takes about 30 s), and
        # city_xl_path at 256x128, below the ray count from which "auto"
        # reorders its paged bounces (a reordered frame draws other samples
        # where one ulp moves a ray across a sort cell: [17])
        presets.ASSET_DIR = tmp.name
        cases = (("teapot_primary 256^2, 128^3", presets.teapot_primary, {}, None),
                 ("room_whitted 512^2, depth 5", presets.room_whitted, {}, None),
                 ("room_whitted glass 512^2, depth 3", presets.room_whitted,
                  dict(glass=True), None),
                 ("monu_path 1080p, 4 bounces", presets.monu_path, {}, (480, 270)),
                 ("city_path 1080p, 4 bounces", presets.city_path, {}, (480, 270)),
                 ("city_xl_path 1080p, 4 bounces", presets.city_xl_path, {}, (256, 128)))
        glass_calls = []
        for what, build, kw, small in cases:
            t0 = time.perf_counter()
            scene, cfg = build(**kw)
            built = time.perf_counter() - t0
            scene = scene.to(dev)
            vols = scene.volumes
            reset_counts()
            img = integrator.render(scene, cfg, key)
            torch.cuda.synchronize()
            c = counts()
            need = ["traverse_nearest"] + (["traverse_occluded", "lookup_rows"]
                                           if cfg.mode != "primary" else [])
            need += ["exit_march"] if "room" in what else []
            for kk in need:
                check(c[kk] > 0, f"{kk} not launched by the {what} frame")
            mean = float(img.mean())
            check(tuple(img.shape) == (cfg.height, cfg.width, 3), f"{what}: {tuple(img.shape)}")
            check(bool(torch.isfinite(img).all()) and 0.0 < mean < 50.0, f"{what}: mean {mean}")
            paths[f"{what.split(',')[0]} frame"] = c
            med, lo, spread, times = host_times(lambda: integrator.render(scene, cfg,
                                                                          fold_in(key, 1)))
            scfg = cfg if small is None else dataclasses.replace(cfg, width=small[0],
                                                                 height=small[1])
            a = integrator.render(scene, scfg, key)
            t0 = time.perf_counter()
            with plain_versions():
                b = integrator.render(scene, scfg, key)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            frac, dmax = pixels_off(a, b)
            log(f"[23] {what} (stand-ins): {vols.n} volumes"
                + (f" in {len(vols.pages)} pages" if vols.pages else "")
                + f", built in {built:.1f} s; mean {mean:.4f}; median {med:.1f} ms, min "
                f"{lo:.1f} ms, spread {spread:.1f} ms ({smi}); reps {times}; launches {c}; "
                f"kernels vs plain at {scfg.width}x{scfg.height}: max diff {dmax:.3g}, "
                f"{frac:.4%} of pixels off by more than 1e-3, plain frame {plain_s:.1f} s")
            if kw.get("glass"):
                with captured_traversals(glass_calls):
                    integrator.render(scene, cfg, key)
                torch.cuda.synchronize()
            del scene, img, a, b

        # K1, K2 and K3 on every call of the roomGlass frame: one 128^3 glass
        # floor under the exit march; each call held to the plain walk, with
        # its bound (the plain version timed on K1's and K2's first call)
        log(f"[23] K1, K2 and K3 on the {len(glass_calls)} calls of the roomGlass 512^2 frame:")
        seen = {}
        for mode, args in glass_calls:
            i = seen[mode] = seen.get(mode, -1) + 1
            kname = dict(nearest="K1", occluded="K2", exit="K3")[mode]
            label = f"roomGlass 512^2 frame, {kname} call {i}"
            if mode == "exit":
                tally = {}
                k = traverse.exit_march(*args)
                err = same_exit(k, traverse.exit_march_plain(*args, tally=tally), args[7], label)
                bnd = exit_bound(args, k, tally)
                kern = per_launch(lambda: traverse.exit_march(*args))
                floor = per_launch(lambda: traverse.launch_floor(args[5].shape[0], dev))
                nr, na = args[5].shape[0], int(args[7].sum())
                log(f"    {label}: {nr} rays, {na} march, {int(k['in_vol'].sum())} leave inside "
                    f"the grid; kernel {kern[0]:.4f} ms ({kern[1]:.1f} us host) = "
                    f"{bnd[0] / kern[0]:.0%} of bound {bnd[0]:.4f} ms ({bnd[1]}), launch floor "
                    f"{floor[0]:.4f} ms ({smi})")
                entry = dict(call=label, rays=nr, active=na, ms=kern[0], host_us=kern[1],
                             bound_ms=bnd[0], bound_by=bnd[1], share=bnd[0] / kern[0],
                             floor_ms=floor[0], max_abs_err=err)
                rname = "exit_march"
            else:
                entry = time_traversal(label, mode, args, plain_too=i == 0, with_base=False)[0]
                rname = f"traverse_{mode}"
            entry["path"] = "roomGlass 512^2 frame"
            next(r for r in results if r["name"] == rname).setdefault("calls", []).append(entry)
        del glass_calls

        # ---- 24. the game at 256x212 (the reference's fixed resolution),
        # cli play's 6 bounces with the light kill on: cmd_play's loop for 8
        # steps of real probes, then tests/test_game.py's scripted
        # progression through chunks 1-3; a frame per chunk counted, timed
        # and against the plain versions
        game = Game(seed=0, asset_dir=tmp.name)
        gcfg = RenderConfig(width=256, height=212, mode="path", max_bounces=6,
                            detect_light_kill=True)
        times = []
        reset_counts()
        steps = cli.play_steps(game, gcfg, ["w"] * 8, dev, times)
        torch.cuda.synchronize()
        c = counts()
        check(steps == 8 and all(p is not None for p, _ in times), f"cli play: {times}")
        for kk in ("traverse_nearest", "traverse_occluded", "lookup_rows"):
            check(c[kk] > 0, f"{kk} not launched by cli play's loop")
        paths["game, cli play 8 steps"] = c
        probe_ms = [p for p, _ in times]
        log(f"[24] cli play's loop, 8 steps at 256x212 (stand-ins): player at "
            f"{tuple(round(float(x), 3) for x in game.volumes[0].position)}, chunk "
            f"{game.state.current_chunk}; probe ms {[round(p, 2) for p in probe_ms]} (median "
            f"{statistics.median(probe_ms):.2f}); frame ms {[round(f, 1) for _, f in times]} "
            f"({smi}); launches {c}")

        def fake_probe(o, d, dist):
            point = np.array([0.0, 0.0, game.state.trigger_checkpoint - 1.0], np.float32)
            return 1, 1.0, point, np.array([0.0, 1.0, 0.0], np.float32)

        gkey = fold_in(key, 24)
        for chunk in range(4):
            if chunk:
                game.tick(0.016, "w", fake_probe)
                check(game.state.current_chunk == chunk, f"chunk {game.state.current_chunk}")
            scene = game.build_scene(gcfg.width, gcfg.height, dev)
            reset_counts()
            img, lit = integrator.render_game_frame(scene, gcfg, gkey)
            torch.cuda.synchronize()
            c = counts()
            for kk in ("traverse_nearest", "traverse_occluded", "lookup_rows"):
                check(c[kk] > 0, f"{kk} not launched by the chunk {chunk} game frame")
            check(bool(torch.isfinite(img).all()), f"chunk {chunk} frame has non-finite values")
            paths[f"game frame, chunk {chunk}"] = c
            med, lo, spread, ftimes = host_times(
                lambda: integrator.render_game_frame(scene, gcfg, fold_in(gkey, 1)))
            with plain_versions():
                pimg, plit = integrator.render_game_frame(scene, gcfg, gkey)
            frac, dmax = pixels_off(img, pimg)
            check(bool(lit) == bool(plit), f"chunk {chunk}: light-kill flags differ")
            log(f"[24] game chunk {chunk}: {scene.volumes.n} volumes, "
                f"{scene.triangles.v0.shape[0]} triangles, {scene.spheres.radius.shape[0]} "
                f"spheres, {scene.lights.n_spot} spot and {scene.lights.n_area} area lights; "
                f"mean {float(img.mean()):.4f}, light kill {bool(lit)}; median {med:.1f} ms, "
                f"min {lo:.1f} ms, spread {spread:.1f} ms ({smi}); reps {ftimes}; launches {c}; "
                f"kernels vs plain: max diff {dmax:.3g}, {frac:.4%} of pixels off by more than "
                f"1e-3, flags equal")
        check(game.volumes[-1].gridsize == 32 and game.state.current_chunk == 3, "no win text")
        check(sum(c.get("exit_march", 0) for p_, c in paths.items() if "chunk" in p_) > 0,
              "exit_march not launched by the game's frames")

        # the lit and the dark case of tests/test_game.py:118-156
        vols = build_volumes([VolumeSpec(position=(0, 0, 0), gridsize=4,
                                         grid=solid_grid(4, SMOKE_PLAYER))])
        mats = default_materials()
        mats.albedo[SMOKE_PLAYER] = torch.tensor([1.0, 0.7, 1.0])
        lcfg = RenderConfig(width=16, height=16, mode="path", max_bounces=2,
                            detect_light_kill=True, activate_sky=False)
        flags = {}
        for name, col in (("lit", 500.0), ("dark", 1e-4)):
            sc = presets._assemble(vols, mats, make_lights(point=((0.0, 0.0, -1.2, col, col,
                                                                   col),))).to(dev)
            lit = bool(integrator.render_game_frame(sc, lcfg, key)[1])
            with plain_versions():
                plit = bool(integrator.render_game_frame(sc, lcfg, key)[1])
            check(lit == plit == (name == "lit"), f"{name} scene: light kill {lit} / {plit}")
            flags[name] = lit
        log(f"[24] light kill on the card: {flags} (kernels and plain versions agree)")
    finally:
        presets.ASSET_DIR = kept_dir
        tmp.cleanup()
    return paths


LIVE_SIZE = (256, 212)  # the viewer's and cli live's size (camera.h:4-5)
# scripts/viewer_fps.py's script (idle, one move, idle) with one material
# edit; 24 frames
LIVE_SCRIPT = [set()] * 8 + [{"w"}] + [set()] * 7 + [{"m"}] + [set()] * 7
SHARD_RANKS = 4
# the sharded step's size: the 1-rank dense step (16 march steps over 4
# volumes) fits the card at 1080p
STEP_SIZE = (1920, 1080)


def _kernel_counts():
    from voxtracer_torch.kernels import lookup, rng, traverse

    return dict(traverse.launches, **lookup.launches, **rng.launches)


def _reset_kernel_counts():
    from voxtracer_torch.kernels import lookup, rng, traverse

    for c in (traverse.launches, lookup.launches, rng.launches):
        for k in c:
            c[k] = 0


def sharded_frames_rank(frames, reps):
    """One rank of [26]: each (label, preset name, preset kwargs) of
    `frames` through render_sharded on this process's mesh -> {label:
    launches, peak memory, host ms of `reps` frames after the counted one,
    and (rank 0) the counted frame's image and the same frame under the
    plain versions, every rank tracing its share plainly}."""
    import torch

    from voxtracer_torch.core.rng import fold_in, make_key
    from voxtracer_torch.dist.mesh import make_mesh, render_sharded
    from voxtracer_torch.scene import presets

    mesh = make_mesh()
    out = {}
    for label, preset, kw in frames:
        scene, cfg = getattr(presets, preset)(**kw)
        scene = scene.to(mesh.device)
        key = make_key(0)
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
        _reset_kernel_counts()
        img = render_sharded(scene, cfg, key, 1, mesh)
        torch.cuda.synchronize(mesh.device)
        counted = _kernel_counts()
        peak = torch.cuda.max_memory_allocated(mesh.device)
        times = []
        for i in range(reps):
            t0 = time.perf_counter()
            render_sharded(scene, cfg, fold_in(key, 1 + i), 1, mesh)
            torch.cuda.synchronize(mesh.device)
            times.append((time.perf_counter() - t0) * 1e3)
        with plain_versions():
            plain = render_sharded(scene, cfg, key, 1, mesh)
        rank0 = mesh.index == 0
        out[label] = dict(launches=counted, peak=peak, times=times, rank=mesh.index,
                          image=img.cpu().numpy() if rank0 else None,
                          plain=plain.cpu().numpy() if rank0 else None)
        del scene, img, plain
    return out


def sharded_step_rank(width, height, n_steps, plain=False):
    """One rank of [26]: one train_demo step of the monu-like scene at
    width x height on this process's ('data', 'model') mesh, through the
    kernels or (`plain`) the plain versions -> its mesh coordinates, the
    loss, its gradients (density slab, albedo), launches, peak memory and
    the step's host ms."""
    import torch

    from voxtracer_torch.dist.train import make_mesh_2d, train_demo
    from voxtracer_torch.scene.presets import monu_like_path

    mesh = make_mesh_2d()
    scene, cfg = monu_like_path(width, height, bounces=4)
    scene = scene.to(mesh.device)
    target = torch.zeros((height, width, 3), device=mesh.device)
    torch.cuda.synchronize(mesh.device)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    _reset_kernel_counts()
    t0 = time.perf_counter()
    with plain_versions() if plain else contextlib.nullcontext():
        params, loss = train_demo(scene, cfg, target, mesh, iters=1, n_steps=n_steps)
    torch.cuda.synchronize(mesh.device)
    ms = (time.perf_counter() - t0) * 1e3
    return dict(shape=mesh.shape, coords=mesh.coords, loss=loss, ms=ms,
                grad_density=params.density_logits.grad.cpu().numpy(),
                grad_albedo=params.albedo_table.grad.cpu().numpy(),
                launches=_kernel_counts(), peak=torch.cuda.max_memory_allocated(mesh.device))


def wavefront_frames_rank(frames, reps):
    """One rank of [28]: each (label, preset name, preset kwargs, config
    fields, plain) of `frames` through render_sharded on this process's
    mesh -> {label: launches of the counted frame, peak memory, host ms of
    `reps` frames after it, the exchanges of one more frame (what, bytes,
    ms, the device synchronised around each), its queue iterations, and
    (rank 0) the counted frame's image and, with `plain`, the same frame
    under the plain versions, every rank tracing its share plainly}."""
    import torch

    from voxtracer_torch.core.rng import fold_in, make_key
    from voxtracer_torch.dist.mesh import make_mesh, render_sharded
    from voxtracer_torch.scene import presets

    mesh = make_mesh()
    out = {}
    for label, preset, kw, cfg_kw, plain in frames:
        scene, cfg = getattr(presets, preset)(**kw)
        cfg = dataclasses.replace(cfg, **cfg_kw)
        scene = scene.to(mesh.device)
        key = make_key(0)
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
        _reset_kernel_counts()
        img = render_sharded(scene, cfg, key, 1, mesh)
        torch.cuda.synchronize(mesh.device)
        counted = _kernel_counts()
        peak = torch.cuda.max_memory_allocated(mesh.device)
        times = []
        for i in range(reps):
            t0 = time.perf_counter()
            render_sharded(scene, cfg, fold_in(key, 1 + i), 1, mesh)
            torch.cuda.synchronize(mesh.device)
            times.append((time.perf_counter() - t0) * 1e3)
        stats = {}
        render_sharded(scene, cfg, fold_in(key, 1 + reps), 1, mesh, stats)
        pimg = None
        if plain:
            with plain_versions(chunked=True):
                pimg = render_sharded(scene, cfg, key, 1, mesh)
        rank0 = mesh.index == 0
        out[label] = dict(launches=counted, peak=peak, times=times, rank=mesh.index,
                          exchanges=stats.get("exchanges", []),
                          iters=stats.get("queue_iterations"),
                          image=img.cpu().numpy() if rank0 else None,
                          plain=None if pimg is None or not rank0 else pimg.cpu().numpy())
        del scene, img, pimg
        torch.cuda.empty_cache()
    return out


def wavefront_phase(smi, city_size=(1920, 1080), room_size=(512, 512)):
    """Phase [28]: the sharded frames that share one global wavefront, on 1
    rank (this process) and on SHARD_RANKS ranks spawned on the one card:
    the city_xl_like 1080p path frame, whose bounce reorder sorts the
    whole wavefront (the state gathered at each reorder), and the
    roomglass 512^2 whitted frame with random light choice, whose light
    samples are drawn at each branch's slot in the global queue (one
    indicator sum an iteration); for scale, the city frame without the
    reorder and the roomglass frame with every light summed, on 1 rank.
    -> {path: launch counts}."""
    import numpy as np

    from voxtracer_torch.dist import multihost

    (cw, ch), (rw, rh) = city_size, room_size
    city = f"city_xl_like {cw}x{ch} path, 4 bounces, reorder auto"
    room = f"roomglass {rw}x{rh} whitted, depth 3, random light choice"
    ckw, rkw = dict(width=cw, height=ch), dict(width=rw, height=rh, glass=True)
    shared = ((city, "city_xl_like_path", ckw, {}, True),
              (room, "room_whitted", rkw, dict(deterministic_lights=False), True))
    scale = ((city + " -> none", "city_xl_like_path", ckw, dict(bounce_reorder="none"), False),
             (room + " -> all lights summed", "room_whitted", rkw, {}, False))
    one = wavefront_frames_rank(shared + scale, 3)
    many = multihost.spawn(wavefront_frames_rank, SHARD_RANKS, (shared, 3), timeout=900)
    paths = {}

    def ms(times):
        return (f"median {statistics.median(times):.1f}, min {min(times):.1f}, spread "
                f"{max(times) - min(times):.1f}")

    for label, _, _, _, _ in shared:
        a, b = one[label], many[0][label]
        ndiff = int((a["image"] != b["image"]).any(-1).sum())
        check(ndiff == 0, f"[28] {label}: {SHARD_RANKS} ranks differ from 1 rank in {ndiff} "
              "pixels")
        check(bool(np.isfinite(a["image"]).all()) and 0.01 < float(a["image"].mean()) < 10,
              f"[28] {label}: mean {float(a['image'].mean())}")
        held = []
        for x in (a, b):
            off = int((np.abs(x["image"] - x["plain"]).max(-1) > 1e-3).sum())
            check(off == 0, f"[28] {label}: {off} pixels off the plain versions by more than "
                  "1e-3")
            held.append(float(np.abs(x["image"] - x["plain"]).max()))
        need = ["traverse_nearest", "traverse_occluded", "lookup_rows"]
        need += ["exit_march"] if label == room else []
        for r in [a] + [m[label] for m in many]:
            for kk in need:
                check(r["launches"][kk] > 0, f"[28] {label}: rank {r['rank']} launched no {kk}")
        paths[f"[28] {label}, 1 rank"] = a["launches"]
        for m in many:
            paths[f"[28] {label}, rank {m[label]['rank']} of {SHARD_RANKS}"] = m[label]["launches"]
        launches = [{k: v for k, v in m[label]["launches"].items() if v} for m in many]
        if label == city:
            kinds = {}
            for rk, x in ((1, a), (SHARD_RANKS, b)):
                re_ = [(bts, t) for w_, bts, t in x["exchanges"] if w_ == "reorder"]
                check(len(re_) > 0, f"[28] {label}: no reorder on {rk} rank(s)")
                kinds[rk] = (f"{len(re_)} reorders a frame, {re_[0][0] / 1e6:.1f} MB a rank "
                             f"each, ms {[round(t, 1) for _, t in re_]}; un-permute "
                             + ", ".join(f"{bts / 1e6:.1f} MB {t:.1f} ms" for w_, bts, t
                                         in x["exchanges"] if w_ == "unpermute")
                             + f"; {sum(w_ == 'alive' for w_, _, _ in x['exchanges'])} "
                             "alive sums")
            detail = f"1 rank: {kinds[1]}; {SHARD_RANKS} ranks (rank 0): {kinds[SHARD_RANKS]}"
        else:
            q = [(bts, t) for w_, bts, t in b["exchanges"] if w_ == "queue"]
            check(a["iters"] == b["iters"] and len(q) == b["iters"][0],
                  f"[28] {label}: queue iterations {a['iters']} / {b['iters']}, {len(q)} sums")
            summed = one[room + " -> all lights summed"]["image"]
            moved = float((np.abs(a["image"] - summed).max(-1) > 1e-3).mean())
            check(moved > 0.01, f"[28] {label}: random light choice moved {moved:.4%} of the "
                  "pixels of the all-lights frame")
            detail = (f"{a['iters'][0]} queue iterations; {q[0][0] / 1e6:.3f} MB exchanged an "
                      f"iteration (a [2W] uint8 indicator), ms {ms([t for _, t in q])}; "
                      f"{moved:.2%} of pixels off the all-lights frame by more than 1e-3")
        log(f"[28] render_sharded {label}: {SHARD_RANKS} ranks equal 1 rank bit for bit (mean "
            f"{float(a['image'].mean()):.4f}); both 0 pixels off the plain versions by more "
            f"than 1e-3 (max diff {held[0]:.3g} / {held[1]:.3g}); frame ms on rank 0's clock, 1 "
            f"rank {ms(a['times'])} (reps {[round(t, 1) for t in a['times']]}), {SHARD_RANKS} "
            f"ranks {ms(b['times'])} (reps {[round(t, 1) for t in b['times']]}) ({smi}); peak "
            f"memory MiB 1 rank {a['peak'] / 2**20:.0f}, per rank "
            f"{[round(m[label]['peak'] / 2**20) for m in many]}; {detail}; launches 1 rank "
            f"{ {k: v for k, v in a['launches'].items() if v} }, per rank {launches}")
    for label, _, _, _, _ in scale:
        x = one[label]
        paths[f"[28] {label}, 1 rank"] = x["launches"]
        log(f"[28] {label}, 1 rank: frame ms {ms(x['times'])} (reps "
            f"{[round(t, 1) for t in x['times']]}) ({smi}); mean {float(x['image'].mean()):.4f}; "
            f"peak memory MiB {x['peak'] / 2**20:.0f}; launches "
            f"{ {k: v for k, v in x['launches'].items() if v} }")
    return paths


def live_dist_phases(dev, key, smi, reset_counts, counts):
    """Phases [25]-[28]: the live viewer on stand-in .vox files, the
    ray-sharded frames and train step over torch.distributed (4 ranks on
    the one card), the scaling bench and the sharded frames that share
    one global wavefront -> {path: launch counts}."""
    import io
    import tempfile

    import numpy as np
    import torch

    from voxtracer_torch.bench import scaling
    from voxtracer_torch.dist import multihost
    from voxtracer_torch.kernels import traverse
    from voxtracer_torch.render import integrator
    from voxtracer_torch.scene import presets
    from voxtracer_torch.viewer import LiveSession, TermDisplay, run_live

    paths = {}
    tmp = tempfile.TemporaryDirectory()
    kept_dir, kept_env = presets.ASSET_DIR, os.environ.get("VOX_ASSETS")
    try:
        write_standin_assets(tmp.name, 0)
        presets.ASSET_DIR = os.environ["VOX_ASSETS"] = tmp.name
        w, h = LIVE_SIZE

        # ---- 25. the live viewer, headless, at 256x212: cli live's default
        # preset (monu, path, 4 bounces) and roomglass (whitted: K3 through
        # the glass floor), each built at its own size as cli live builds it
        disp = TermDisplay(out=io.StringIO())
        for name in ("monu", "roomglass"):
            scene, cfg = presets.PRESETS[name]()
            cfg = dataclasses.replace(cfg, width=w, height=h)
            scene = scene.to(dev)
            reset_counts()
            frames, report = run_live(scene, cfg, script=LIVE_SCRIPT, display=False)
            torch.cuda.synchronize()
            c = counts()
            need = ["traverse_nearest", "traverse_occluded", "lookup_rows"]
            need += ["exit_march"] if cfg.mode == "whitted" else []
            for kk in need:
                check(c[kk] > 0, f"{kk} not launched by the live {name} frames")
            check(frames == len(LIVE_SCRIPT), f"live {name}: {frames} frames")
            paths[f"live {name} {w}x{h}, {frames} frames"] = c
            ms = [t * 1e3 for t in report.times[1:]]  # frame 0 loads the kernels' tables
            med = statistics.median(ms)
            # the terminal assembly of one frame (no device)
            rgb = np.random.default_rng(0).integers(0, 256, (h, w, 3)).astype(np.uint8)
            ansi = []
            for _ in range(5):
                t0 = time.perf_counter()
                disp.show(rgb, "status")
                ansi.append((time.perf_counter() - t0) * 1e3)
            ansi_ms = statistics.median(ansi)
            per_frame = {k: v / frames for k, v in c.items() if v}
            log(f"[25] live {name} {w}x{h} ({cfg.mode}, {cfg.max_bounces} bounces, "
                f"{scene.volumes.n} volumes), {frames} frames (idle, a move, idle, an edit, "
                f"idle): frame ms median {med:.1f}, min {min(ms):.1f}, spread "
                f"{max(ms) - min(ms):.1f} (frames 1-{frames - 1}); TermDisplay assembly "
                f"{ansi_ms:.2f} ms; {1e3 / (med + ansi_ms):.1f} fps end to end against the "
                f"reference's >5 fps bar ({smi}); launches a frame {per_frame}")
            # the final accumulator and image of a short script (a move and
            # an edit) through the kernels and through the plain versions
            short = [set(), {"w"}, set(), {"m"}, set()]
            got, calls = [], []
            for plain in (False, True):
                live = LiveSession(scene, cfg)
                with (plain_versions() if plain else captured_traversals(calls)):
                    for keys in short:
                        rgb8 = live.frame(keys, 33.0)
                got.append((live.acc, rgb8))
            # every K1, K2 and K3 call of those frames against its plain
            # version on the same inputs
            err = 0.0
            for i, (mode, args) in enumerate(calls):
                what = f"live {name}, {mode} call {i}"
                if mode == "exit":
                    err = max(err, same_exit(traverse.exit_march(*args),
                                             traverse.exit_march_plain(*args), args[7], what))
                else:
                    err = max(err, same_traversal(traverse.traverse(*args, mode=mode),
                                                  plain_traversal(args, mode), what))
            (ka, kr), (pa, pr) = got
            frac, dmax = pixels_off(ka, pa)
            off = round(frac * ka[..., 0].numel())
            lv = np.abs(kr.astype(np.int32) - pr.astype(np.int32)).max(-1)
            log(f"[25] live {name}, {len(short)} frames with a move and an edit, kernels vs "
                f"plain: each of the {len(calls)} K1/K2/K3 calls equal in hit, volume and cell "
                f"on the same inputs (t and normals within {err:.3g}); accumulator max diff "
                f"{dmax:.3g}, {off} pixels off by more than 1e-3; uint8 image "
                f"{int((lv > 0).sum())} pixels differ, by at most {int(lv.max())} level(s)")
            check(off == 0, f"live {name}: {off} pixels of the accumulator off by more than "
                  f"1e-3, kernels vs plain")
            del scene, live, got, calls
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "voxtracer_torch.cli", "live", "--script",
                              "..w.", "--no-display"], capture_output=True, text=True, env=env,
                             timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
        check(run.returncode == 0 and "live: 4 frames rendered" in run.stderr,
              f"cli live exited {run.returncode}: {run.stderr[-2000:]}")
        log(f"[25] cli live --script ..w. --no-display (monu, 256x212): exit 0 in "
            f"{time.perf_counter() - t0:.1f} s")

        # ---- 26. ray-sharded frames and the sharded step: 1 rank in this
        # process, 4 ranks spawned on the one card
        backend = multihost.backend_for(SHARD_RANKS)
        log(f"[26] {SHARD_RANKS} ranks on {torch.cuda.device_count()} card(s): backend "
            f"{backend} (NCCL when every rank has a card of its own; ranks sharing a card use "
            f"gloo, collectives through host copies; every rank renders on the card)")
        frames = (("monu_like 1920x1080 path, 4 bounces", "monu_like_path", {}),
                  ("glassbox 512x512 whitted, depth 5", "glass_sphere_box",
                   dict(width=512, height=512)))
        one = sharded_frames_rank(frames, 3)
        many = multihost.spawn(sharded_frames_rank, SHARD_RANKS, (frames, 3), timeout=600)
        for label, _, _ in frames:
            a, b = one[label], many[0][label]
            same = np.array_equal(a["image"], b["image"])
            ndiff = int((a["image"] != b["image"]).any(-1).sum())
            check(same, f"{label}: {SHARD_RANKS} ranks differ from 1 rank in {ndiff} pixels")
            check(bool(np.isfinite(a["image"]).all()) and 0.01 < float(a["image"].mean()) < 10,
                  f"{label}: mean {float(a['image'].mean())}")
            for r in many:
                check(r[label]["launches"]["traverse_nearest"] > 0,
                      f"{label}: rank {r[label]['rank']} launched no K1")
            # each rank's share through the kernels against the plain versions
            held = [pixels_off(torch.from_numpy(x["image"]), torch.from_numpy(x["plain"]))
                    for x in (a, b)]
            paths[f"sharded {label}, rank 0 of {SHARD_RANKS}"] = b["launches"]
            paths[f"sharded {label}, 1 rank"] = a["launches"]
            log(f"[26] render_sharded {label}: {SHARD_RANKS} ranks equal 1 rank bit for bit "
                f"(mean {float(a['image'].mean()):.4f}); host ms a frame, 1 rank "
                f"{statistics.median(a['times']):.1f} (reps {[round(t, 1) for t in a['times']]}), "
                f"{SHARD_RANKS} ranks (rank 0) {statistics.median(b['times']):.1f} (reps "
                f"{[round(t, 1) for t in b['times']]}) ({smi}); peak memory MiB 1 rank "
                f"{a['peak'] / 2**20:.0f}, per rank {[round(r[label]['peak'] / 2**20) for r in many]}"
                f"; launches 1 rank {a['launches']}, per rank "
                f"{[r[label]['launches'] for r in many]}; kernels vs plain, 1 rank: max diff "
                f"{held[0][1]:.3g}, {held[0][0]:.4%} of pixels off by more than 1e-3; "
                f"{SHARD_RANKS} ranks: max diff {held[1][1]:.3g}, {held[1][0]:.4%}")
        del one, many
        # the branch queue without its exact order, twice on 1 rank: the
        # card's per-pixel scatter-add (atomics) in no fixed order
        wscene, wcfg = presets.glass_sphere_box(512, 512)
        wscene = wscene.to(dev)
        w1, w2 = (integrator.render(wscene, wcfg, key) for _ in range(2))
        log(f"[26] the whitted 512x512 frame twice through render (the queue's scatter-add): "
            f"{int((w1 != w2).any(-1).sum())} pixels differ bit-wise, max "
            f"{float((w1 - w2).abs().max()):.3g}")
        del wscene, w1, w2
        sw, sh = STEP_SIZE
        one = sharded_step_rank(sw, sh, 16)
        many = multihost.spawn(sharded_step_rank, SHARD_RANKS, (sw, sh, 16), timeout=600)
        check(one["shape"] == (1, 1) and many[0]["shape"] == (2, 2), "mesh shapes")
        full = np.concatenate([r["grad_density"] for r in many if r["coords"][0] == 0], axis=1)
        rel_d = float(np.linalg.norm(full - one["grad_density"])
                      / np.linalg.norm(one["grad_density"]))
        rel_a = max(float(np.linalg.norm(r["grad_albedo"] - one["grad_albedo"])
                          / np.linalg.norm(one["grad_albedo"])) for r in many)
        dloss = max(abs(r["loss"] - one["loss"]) / abs(one["loss"]) for r in many)
        check(dloss <= 1e-5, f"sharded step: loss off by {dloss:.3g} relative")
        check(rel_d <= 1e-4 and rel_a <= 1e-4,
              f"sharded step: gradient relative L2 density {rel_d:.3g}, albedo {rel_a:.3g}")
        for r in many:
            check(r["launches"]["lookup_rows_bwd"] > 0 and r["launches"]["lookup_rows"] > 0,
                  f"rank at {r['coords']}: no K4 / K4-bwd launch")
        # the 1-rank step through the plain versions: [9]'s gradient gate
        plain = sharded_step_rank(sw, sh, 16, plain=True)
        ploss = abs(one["loss"] - plain["loss"]) / abs(plain["loss"])
        prel = {f: float(np.linalg.norm(one[f] - plain[f]) / np.linalg.norm(plain[f]))
                for f in ("grad_density", "grad_albedo")}
        check(ploss <= 1e-5 and max(prel.values()) <= 1e-4,
              f"sharded step, kernels vs plain: loss {ploss:.3g} relative, gradient relative L2 "
              f"{prel}")
        paths[f"sharded step {sw}x{sh}, rank 0 of {SHARD_RANKS}"] = many[0]["launches"]
        paths[f"sharded step {sw}x{sh}, 1 rank"] = one["launches"]
        log(f"[26] train_demo step, monu_like {sw}x{sh}, 16 march steps, (2, 2) mesh against 1 "
            f"rank: loss {one['loss']:.6g} (off by {dloss:.3g} relative), gradient relative L2 "
            f"density {rel_d:.3g}, albedo {rel_a:.3g}; step ms 1 rank {one['ms']:.1f}, per rank "
            f"{[round(r['ms'], 1) for r in many]} ({smi}); peak memory MiB 1 rank "
            f"{one['peak'] / 2**20:.0f}, per rank {[round(r['peak'] / 2**20) for r in many]}; "
            f"launches 1 rank {one['launches']}, per rank {[r['launches'] for r in many]}; "
            f"1 rank kernels vs plain: loss off by {ploss:.3g} relative, gradient relative L2 "
            f"density {prel['grad_density']:.3g}, albedo {prel['grad_albedo']:.3g}")
        del one, many, plain

        # ---- 27. the scaling bench at 1080p on the one card
        res = scaling.measure(1920, 1080, 1, 3)
        check([r["devices"] for r in res] == [1, 2, 4] and all(r["rays_s"] > 0 for r in res),
              f"scaling: {res}")
        log("[27] bench.scaling 1920x1080 monu_path (one stand-in model, 4 bounces): "
            + "; ".join(f"{r['devices']} rank(s) {r['seconds'] * 1e3:.1f} ms a frame, "
                        f"{r['rays_s'] / 1e6:.3f} Mrays/s, efficiency {r['efficiency']:.3f}"
                        for r in res) + f" ({smi})")

        # ---- 28. the sharded frames that share one global wavefront
        # (stand-ins: roomglass)
        t0 = time.perf_counter()
        paths.update(wavefront_phase(smi))
        log(f"[28] {time.perf_counter() - t0:.1f} s")
    finally:
        presets.ASSET_DIR = kept_dir
        if kept_env is None:
            os.environ.pop("VOX_ASSETS", None)
        else:
            os.environ["VOX_ASSETS"] = kept_env
        tmp.cleanup()
    return paths


def busy_share(fn):
    """fn() once to warm up, then once under torch.profiler -> (the kernels'
    summed device ms, the profiled run's wall ms, their ratio: the device's
    busy share; the profiler's own host work makes it a lower bound)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3
    check(dev_ms > 0, "the profiler saw no device time")
    return dev_ms, wall, dev_ms / wall


@contextlib.contextmanager
def chunk_log(lives):
    """Record the live lanes of each bounce a chunked loop traces
    (``integrator._trace_chunks``' live_end) into `lives`."""
    from voxtracer_torch.render import integrator

    kept = integrator._trace_chunks

    def rec(*args):
        lives.append(args[4])
        return kept(*args)

    integrator._trace_chunks = rec
    try:
        yield lives
    finally:
        integrator._trace_chunks = kept


OPTION_KERNELS = ("traverse_nearest", "traverse_occluded", "exit_march", "lookup_rows",
                  "lookup_rows_bwd")


def options_phase(dev, scene, cfg, params, plan, key, smi, reset_counts, counts, measure,
                  results, city_size=(1920, 1080), room_size=512):
    """Phase [29]: the JAX package's render options on the card, each beside
    the run without it in one call, with main's helpers and the monu-like
    1080p `scene` and its (2,10)@4 bin `plan`: the wavefront compaction
    (compact_chunks 1 / 4 / 8), the reordered loop's live-prefix chunks on
    city_xl_like 1080p (reorder_compact_chunks 1 / 4), the whitted batch
    sort on stand-in roomglass 512^2 at depth 3, the threefry sampler
    against the hash, and the fused gradient step with importance = 8 on
    the long-span bins against uniform nodes.  Each option's frame or step
    is held to the plain versions (images: 0.1% of pixels off by more than
    1e-3; gradients: relative L2 1e-4), timed (``host_times``) with its
    launches and the device's busy share (``busy_share``) -> {path: launch
    counts}."""
    import tempfile

    import torch

    from voxtracer_torch.core.rng import fold_in
    from voxtracer_torch.diff import train
    from voxtracer_torch.kernels import lookup, traverse
    from voxtracer_torch.render import integrator
    from voxtracer_torch.render.camera import primary_rays
    from voxtracer_torch.scene import presets

    paths = {}
    n = cfg.width * cfg.height

    def ms(t):
        return f"median {t[0]:.1f} ms, min {t[1]:.1f} ms, spread {t[2]:.1f} ms"

    def counted(what, fn, need):
        """fn() with the counts set to 0 before and read after -> its
        result; the counts go to paths[what], and each kernel in `need` must
        have been launched."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        c = {kk: v for kk, v in counts().items() if kk in OPTION_KERNELS}
        for kk in need:
            check(c[kk] > 0, f"[29] {what}: {kk} not launched")
        paths[f"[29] {what}"] = c
        return out, c

    def frame_of(scene_, cfg_):
        return lambda: integrator.render_tiled(scene_, cfg_, key, 1, 1)

    def timed_calls(what, fn):
        """Every K1, K2 and K3 call of fn(), each held to its plain version
        and timed per launch beside its bound, the plain version timed on
        each kernel's first call -> {"K1" | "K2" | "K3": [(ms, bound ms,
        plain ms or None), ...]}; each call's entry joins its kernel's JSON
        "calls"."""
        calls = []
        with captured_traversals(calls):
            fn()
        torch.cuda.synchronize()
        per = {}
        for i, (mode, args) in enumerate(calls):
            label = f"{what}, call {i}"
            if mode == "exit":
                tally = {}
                out = traverse.exit_march(*args)
                err = same_exit(out, traverse.exit_march_plain(*args, tally=tally), args[7], label)
                bnd = exit_bound(args, out, tally)
                kern = per_launch(lambda: traverse.exit_march(*args))
                plain = functools.partial(traverse.exit_march_plain, *args)
                name, kname, act = "K3", "exit_march", args[7]
            else:
                out = traverse.traverse(*args, mode=mode)
                err = same_traversal(out, plain_traversal(args, mode), label)
                bnd = traverse_bound(args, out, mode)[0]
                kern = per_launch(lambda: traverse.traverse(*args, mode=mode))
                plain = functools.partial(plain_traversal, args, mode)
                name, kname, act = ("K1", "K2")[mode == "occluded"], f"traverse_{mode}", args[8]
            plain_ms = None if name in per else per_launch(plain, windows=3)[0]
            per.setdefault(name, []).append((kern[0], bnd[0], plain_ms))
            next(r for r in results if r["name"] == kname).setdefault("calls", []).append(dict(
                call=f"{label} ({name})", path=f"[29] {what}", rays=args[5].shape[0],
                active=int(act.sum()), ms=kern[0], host_us=kern[1], bound_ms=bnd[0],
                bound_by=bnd[1], share=bnd[0] / kern[0], plain_ms=plain_ms, max_abs_err=err))
        return per

    def calls_text(per):
        return "; ".join(f"{k} {[round(t, 4) for t, _, _ in v]} ms, sum "
                         f"{sum(t for t, _, _ in v):.4f} ms against a bound of "
                         f"{sum(b for _, b, _ in v):.4f} ms (plain, first call {v[0][2]:.4f} ms)"
                         for k, v in sorted(per.items()))

    path_need = ("traverse_nearest", "traverse_occluded", "lookup_rows")

    # ---- compaction: monu_like 1080p, 4 bounces, compact_chunks 1 / 4 / 8
    runs = {}
    for chunks in (1, 4, 8):
        c_cfg = dataclasses.replace(cfg, compact_chunks=chunks)
        check(integrator.path_loop(scene, c_cfg, n) == ("plain" if chunks == 1 else "compact"),
              f"[29] compact_chunks {chunks}: the loop")
        lives = []
        with chunk_log(lives):
            img, c = counted(f"monu_like 1080p, compact_chunks {chunks}", frame_of(scene, c_cfg),
                             path_need)
        mean = float(img.mean())
        check(bool(torch.isfinite(img).all()) and 0.02 < mean < 10.0,
              f"[29] compact_chunks {chunks}: mean {mean}")
        runs[chunks] = dict(cfg=c_cfg, img=img, launches=c, lives=lives,
                            times=host_times(frame_of(scene, c_cfg)),
                            busy=busy_share(frame_of(scene, c_cfg)))
        if chunks < 8:  # K1 and K2 on every call: the plain loop's and 4 chunks'
            runs[chunks]["per"] = timed_calls(f"monu_like 1080p, compact_chunks {chunks}",
                                              frame_of(scene, c_cfg))
    for chunks in (4, 8):
        with plain_versions():
            plain = frame_of(scene, runs[chunks]["cfg"])()
        runs[chunks]["off"] = pixels_off(runs[chunks]["img"], plain)
        del plain
    live = [f"{v / n:.1%}" for v in runs[4]["lives"]]
    for chunks, r in runs.items():
        log(f"[29] monu_like {cfg.width}x{cfg.height}, 4 bounces, compact_chunks {chunks}: frame "
            f"{ms(r['times'])} (reps {[round(t, 1) for t in r['times'][3]]}); mean "
            f"{float(r['img'].mean()):.4f}; launches {r['launches']}; device busy "
            f"{r['busy'][2]:.1%} ({r['busy'][0]:.1f} of {r['busy'][1]:.1f} ms profiled)"
            + (f"; per launch {calls_text(r['per'])}" if "per" in r else "")
            + (f"; chunks traced a bounce {[-(-v // (n // chunks)) for v in r['lives']]}; "
               f"kernels vs plain: {r['off'][0]:.4%} of pixels off by more than 1e-3 (max "
               f"{r['off'][1]:.3g})" if chunks > 1 else "") + f" ({smi})")
    log(f"[29] live rays at each bounce of the monu_like frame: {live}")
    del runs

    # ---- the reordered loop's live-prefix chunks: city_xl_like 1080p, reorder auto
    cscene, ccfg = presets.city_xl_like_path(*city_size)
    cscene = cscene.to(dev)
    cn = ccfg.width * ccfg.height
    check(integrator.path_loop(cscene, ccfg, cn) == "reorder", "[29] city_xl_like reorders")
    runs = {}
    for kc in (1, 4):
        k_cfg = dataclasses.replace(ccfg, reorder_compact_chunks=kc)
        lives = []
        with chunk_log(lives):
            img, c = counted(f"city_xl_like 1080p, reorder auto, reorder_compact_chunks {kc}",
                             frame_of(cscene, k_cfg), path_need)
        check(bool(torch.isfinite(img).all()), f"[29] reorder_compact_chunks {kc}: not finite")
        runs[kc] = dict(img=img, launches=c, lives=lives, times=host_times(frame_of(cscene, k_cfg)),
                        busy=busy_share(frame_of(cscene, k_cfg)))
        if kc > 1:
            with plain_versions(chunked=True):
                plain = frame_of(cscene, k_cfg)()
            runs[kc]["off"] = pixels_off(img, plain)
            del plain
    for kc, r in runs.items():
        log(f"[29] city_xl_like {ccfg.width}x{ccfg.height}, 4 bounces, reorder auto, "
            f"reorder_compact_chunks "
            f"{kc}: frame {ms(r['times'])} (reps {[round(t, 1) for t in r['times'][3]]}); "
            f"mean {float(r['img'].mean()):.4f}; launches {r['launches']}; device busy "
            f"{r['busy'][2]:.1%} ({r['busy'][0]:.1f} of {r['busy'][1]:.1f} ms profiled)"
            + (f"; live lanes a bounce {[f'{v / cn:.1%}' for v in r['lives']]}; kernels vs "
               f"plain: {r['off'][0]:.4%} of pixels off by more than 1e-3 (max "
               f"{r['off'][1]:.3g})" if kc > 1 else "") + f" ({smi})")
    del runs, cscene

    # ---- the whitted batch sort: stand-in roomglass 512^2, depth 3
    tmp = tempfile.TemporaryDirectory()
    kept_dir = presets.ASSET_DIR
    try:
        write_standin_assets(tmp.name, 0)
        presets.ASSET_DIR = tmp.name
        rscene, rcfg = presets.room_whitted(room_size, room_size, glass=True)
    finally:
        presets.ASSET_DIR = kept_dir
        tmp.cleanup()
    rscene = rscene.to(dev)
    rn = rcfg.width * rcfg.height
    ro, rd = primary_rays(rscene.camera, rcfg.width, rcfg.height,
                          *integrator._pixel_grid(rcfg, dev))
    ro = ro.contiguous()
    runs = {}
    for on in (False, True):
        s_cfg = dataclasses.replace(rcfg, whitted_sort_batch=on)
        (img, iters, peak), c = counted(
            f"roomglass {room_size}^2 whitted, depth 3, whitted_sort_batch {on}",
            lambda: integrator.whitted_queue(rscene, s_cfg, ro, rd, s_cfg.max_bounces),
            path_need + ("exit_march",))
        per = timed_calls(f"roomglass {room_size}^2, whitted_sort_batch {on}",
                          lambda: integrator.whitted_queue(rscene, s_cfg, ro, rd,
                                                           s_cfg.max_bounces))
        runs[on] = dict(img=img, iters=iters, peak=peak, launches=c, per=per,
                        times=host_times(lambda: integrator.whitted_queue(
                            rscene, s_cfg, ro, rd, s_cfg.max_bounces)),
                        busy=busy_share(lambda: integrator.whitted_queue(
                            rscene, s_cfg, ro, rd, s_cfg.max_bounces)))
        with plain_versions():
            plain = integrator.whitted_queue(rscene, s_cfg, ro, rd, s_cfg.max_bounces)[0]
        runs[on]["off"] = pixels_off(img, plain)
    sort_diff = float((runs[True]["img"] - runs[False]["img"]).abs().max())
    for on, r in runs.items():
        log(f"[29] roomglass {rcfg.width}x{rcfg.height} whitted, depth 3 (stand-ins), "
            f"whitted_sort_batch {on}: "
            f"frame {ms(r['times'])} (reps {[round(t, 1) for t in r['times'][3]]}); "
            f"{r['iters']} queue iterations, peak population {r['peak']} "
            f"({r['peak'] / rn:.2f} N); launches {r['launches']}; per launch "
            + calls_text(r["per"]) + f"; device busy {r['busy'][2]:.1%} ({r['busy'][0]:.1f} of {r['busy'][1]:.1f} ms "
            f"profiled); kernels vs plain: {r['off'][0]:.4%} of pixels off by more than 1e-3 "
            f"(max {r['off'][1]:.3g}) ({smi})")
    log(f"[29] roomglass: sorted vs unsorted batches, largest pixel difference {sort_diff:.3g} "
        f"(the sums' order)")
    del runs, rscene

    # ---- the threefry sampler against the hash: monu_like 1080p path
    t_cfg = dataclasses.replace(cfg, rng="threefry")
    timg, tc = counted("monu_like 1080p, rng threefry", frame_of(scene, t_cfg), path_need)
    h0 = frame_of(scene, cfg)()
    h1 = integrator.render_tiled(scene, cfg, fold_in(key, 1), 1, 1)
    m0, m1, mt = float(h0.mean()), float(h1.mean()), float(timg.mean())
    # the standard error of a frame's mean from the spread of two hash keys'
    # frames, a pixel (its channels' mean) a sample; the threefry mean less
    # the two hash frames' mean has sqrt(1.5) of it
    se = float((h0 - h1).mean(-1).std()) / math.sqrt(2 * n)
    check(abs(mt - 0.5 * (m0 + m1)) <= 4.0 * math.sqrt(1.5) * se,
          f"[29] threefry mean {mt} against hash means {m0}, {m1} (standard error {se})")
    t_times, h_times = host_times(frame_of(scene, t_cfg)), host_times(frame_of(scene, cfg))
    t_busy, h_busy = busy_share(frame_of(scene, t_cfg)), busy_share(frame_of(scene, cfg))
    with plain_versions():
        plain = frame_of(scene, t_cfg)()
    t_off = pixels_off(timg, plain)
    del plain, h0, h1
    log(f"[29] monu_like {cfg.width}x{cfg.height}, 4 bounces, rng threefry: frame "
        f"{ms(t_times)} (reps "
        f"{[round(t, 1) for t in t_times[3]]}), device busy {t_busy[2]:.1%} ({t_busy[0]:.1f} of "
        f"{t_busy[1]:.1f} ms profiled); rng hash: frame {ms(h_times)} (reps "
        f"{[round(t, 1) for t in h_times[3]]}), device busy {h_busy[2]:.1%} ({h_busy[0]:.1f} of "
        f"{h_busy[1]:.1f} ms profiled); means threefry {mt:.5f}, hash keys 0 / 1 {m0:.5f} / "
        f"{m1:.5f} (standard error of a frame mean {se:.2g}); launches {tc}; kernels vs plain: "
        f"{t_off[0]:.4%} of pixels off by more than 1e-3 (max {t_off[1]:.3g}) ({smi})")

    # ---- importance = 8 on the long-span bins of the fused step
    iplan = train.prepare_bins(scene, cfg, torch.zeros((cfg.height, cfg.width, 3), device=dev),
                               bin_steps=(2, 10), edges=(4.0,), tiles=2, span_steps=1,
                               importance=8)
    steps = {}
    for what, p in (("uniform", plan), ("importance 8", iplan)):
        (loss, grads), c = counted(f"1080p gradient, (2,10)@4 bins, {what}",
                                   lambda: train.binned_grads(params, scene, p),
                                   ("traverse_nearest", "lookup_rows", "lookup_rows_bwd"))
        steps[what] = dict(loss=float(loss), grads=grads, launches=c,
                           times=host_times(lambda: train.fused_step(params, scene, cfg, key, p)),
                           busy=busy_share(lambda: train.binned_grads(params, scene, p)))
    with plain_versions():
        ploss, pgrads = train.binned_grads(params, scene, iplan)
    g = steps["importance 8"]["grads"]
    rel = {f: rel_l2(getattr(g, f), getattr(pgrads, f)) for f in ("density_logits",
                                                                  "albedo_table")}
    for f, r in rel.items():
        check(r <= 1e-4, f"[29] importance gradient {f}: kernels vs plain relative L2 {r}")
    gu = steps["uniform"]["grads"].density_logits.flatten()
    cos = float(torch.dot(gu, g.density_logits.flatten())
                / (gu.norm() * g.density_logits.norm()))
    for what, s in steps.items():
        log(f"[29] fused step {cfg.width}x{cfg.height}, (2,10)@4 bins, {what}: "
            f"{ms(s['times'])} (reps "
            f"{[round(t, 1) for t in s['times'][3]]}); gradient loss {s['loss']:.6f}, launches "
            f"{s['launches']}; gradient device busy {s['busy'][2]:.1%} ({s['busy'][0]:.1f} of "
            f"{s['busy'][1]:.1f} ms profiled) ({smi})")
    log(f"[29] importance gradient kernels vs plain: relative L2 density "
        f"{rel['density_logits']:.3g}, albedo {rel['albedo_table']:.3g}; density gradient "
        f"cosine with the uniform nodes' {cos:.4f}")
    # K4 at the probes' shape: the brick means [2048, 1] x P x N of each
    # long-span bin, beside the plain version and index_select
    calls = {}
    with captured_lookups(calls, every_n=True):
        train.binned_grads(params, scene, iplan)
    torch.cuda.synchronize()
    probe_n = {8 * b.o.shape[0] for b in iplan.bins if b.clamp}
    k_b = scene.volumes.n * scene.volumes.occ.shape[2]
    entry = next(r for r in results if r["name"] == "lookup_rows")
    for key_ in sorted(kk for kk in calls if kk[0] == "fwd" and kk[1] in probe_n
                       and kk[2:] == (k_b, 1)):
        tab, idx = calls[key_]
        got = lookup.lookup_rows(tab, idx)
        check(torch.equal(got, lookup.lookup_rows_plain(tab, idx)),
              f"[29] K4 rows differ at the probe shape {list(tab.shape)} x {idx.shape[0]}")
        cidx = idx.clamp(0, tab.shape[0] - 1)
        *_, shape_entry = measure(
            f"[29] K4 importance probes {list(tab.shape)} x {idx.shape[0]}",
            lambda: lookup.lookup_rows(tab, idx), None,
            lambda: lookup.lookup_rows_plain(tab, idx), lambda: torch.index_select(tab, 0, cidx),
            "index_select", bound(nbytes(tab, idx, got), 3 * got.numel()), {})
        entry["shapes"].append(shape_entry)
    check(any(kk[1] in probe_n for kk in calls if kk[0] == "fwd"),
          "[29] no K4 call at the importance probes' shape")
    return paths


ABLATIONS = ("_ABLATE_ALB_FETCH", "_ABLATE_BSIG_ADJ", "_ABLATE_CELL_FETCH",
             "_ABLATE_CELL_SCATTER", "_ABLATE_SPANS", "_ABLATE_CLAMP")
VARIANT_KERNELS = ("traverse_nearest", "traverse_nearest_count", "traverse_nearest_no_normals")
DENSE_STEPS = 16  # the dense per-pair march's samples a pair ([26]'s sharded step)


def trip_stats(iters, active):
    """K1's per-ray trips -> mean, p50, p99 and max over the active rays,
    and the divergence factor: over warps of 32 consecutive rays in launch
    order, the sum of 32 x each warp's most trips over the sum of all
    trips (the lane-trips a warp issues per trip some lane needs)."""
    import torch

    it = iters[active].float()
    warps = torch.nn.functional.pad(iters.float(), (0, -iters.shape[0] % 32)).reshape(-1, 32)
    return dict(mean=float(it.mean()), p50=float(torch.quantile(it, 0.5)),
                p99=float(torch.quantile(it, 0.99)), max=int(it.max()),
                divergence=float(32.0 * warps.amax(1).sum() / warps.sum()))


def switches_phase(dev, scene, cfg, params, plan, key, args1, smi, reset_counts, counts, report):
    """Phase [30]: the JAX package's last switches on the card, with main's
    helpers, the monu-like 1080p `scene`, its (2,10)@4 `plan` and K1's
    call on its primary rays `args1`:
    * K1's two variants (``traverse(count_iters=True)``, ``ablate=("norm",)``)
      on those rays and on the city_xl_like 1080p primary rays (111
      volumes): each held to its plain version (the trips identical), hit,
      t, vol and cell identical to K1's, per launch beside K1 (the
      counter's cost, the normal epilogue's share); the trips a ray and the
      divergence factor (``trip_stats``);
    * the 1080p fused step under each ``volumetric._ABLATE_*`` flag and
      under none: step ms, the gradient's device ms and busy share, its
      launches; every flag is put back in a ``finally``;
    * the dense per-pair gradient (``span_steps=0``, DENSE_STEPS samples)
      on the largest 1080p band that fits without ``volumetric._REMAT``,
      with and without it: peak memory, ms, the gradients within relative
      L2 1e-6.
    -> {path: launch counts}."""
    import torch

    from voxtracer_torch.core.rng import fold_in
    from voxtracer_torch.diff import train, volumetric
    from voxtracer_torch.kernels import traverse
    from voxtracer_torch.render import integrator
    from voxtracer_torch.render.camera import primary_rays
    from voxtracer_torch.scene.presets import city_xl_like_path

    paths = {}

    # ---- K1's variants on two sets of 1080p primary rays
    cscene, ccfg = city_xl_like_path(1920, 1080)
    cscene = cscene.to(dev)
    cv = cscene.volumes
    px, py = integrator._pixel_grid(ccfg, dev)
    co, cd = primary_rays(cscene.camera, ccfg.width, ccfg.height, px, py)
    cargs = (cv.grids.reshape(-1), cv.gridsize, cv.inv, cv.fwd, cv.cube_min, co.contiguous(),
             cd.contiguous(), None, torch.ones(co.shape[0], dtype=torch.bool, device=dev), None,
             cv.occ, cv.bricksize)
    sets = {"monu_like 1080p primary rays": args1,
            f"city_xl_like 1080p primary rays ({cv.n} volumes)": cargs}
    variants = {"count": dict(count_iters=True), "no_normals": dict(ablate=("norm",))}
    first = {}
    for label, args in sets.items():
        act = args[8]
        k1 = traverse.traverse(*args)
        reset_counts()
        got = {v: traverse.traverse(*args, **kw) for v, kw in variants.items()}
        torch.cuda.synchronize()
        c = counts()
        for v in variants:
            check(c[f"traverse_nearest_{v}"] == 1, f"[30] {label}: the {v} variant not launched")
        paths[f"[30] K1 variants, {label}"] = {kk: c[kk] for kk in VARIANT_KERNELS}
        for v, k in got.items():
            for f in ("hit", "t", "vol", "cell"):
                check(torch.equal(k[f], k1[f]), f"[30] {label}, {v} variant: {f} is not K1's")
        check(not any(bool(got["no_normals"][c_].any()) for c_ in ("nx", "ny", "nz")),
              f"[30] {label}: the no-normals variant wrote normals")
        errs = {}
        for v, kw in variants.items():
            p = plain_traversal(args, "nearest", **kw)
            errs[v] = same_traversal(got[v], p, f"[30] {label}, {v} variant")
            if v == "count":
                check(torch.equal(got[v]["iters"], p["iters"]),
                      f"[30] {label}: trips differ from the plain walk's")
            del p
        ts = trip_stats(got["count"]["iters"], act)
        # in turns: K1, count, no normals, K1
        times = [per_launch(lambda kw=kw: traverse.traverse(*args, **kw))
                 for kw in ({}, variants["count"], variants["no_normals"], {})]
        k1_ms = statistics.mean((times[0][0], times[3][0]))
        least = least_traversal_ops(args, "nearest", k1)
        bnds = {v: traverse_bound(args, got[v], "nearest", least)[0] for v in variants}
        plain = ({v: per_launch(functools.partial(plain_traversal, args, "nearest", **kw),
                                windows=3) for v, kw in variants.items()} if not first else None)
        log(f"[30] K1 variants, {label}: {int(act.sum())} active rays, "
            f"{int(k1['hit'].sum())} hits; per launch K1 {times[0][0]:.4f} / {times[3][0]:.4f} "
            f"ms, count {times[1][0]:.4f} ms ({times[1][1]:.1f} us host; the counter "
            f"{times[1][0] - k1_ms:+.4f} ms, {times[1][0] / k1_ms - 1:+.1%}; bound "
            f"{bnds['count'][0]:.4f} ms, {bnds['count'][1]}), no normals {times[2][0]:.4f} ms "
            f"({times[2][1]:.1f} us host; the epilogue's share {1 - times[2][0] / k1_ms:.1%}; "
            f"bound {bnds['no_normals'][0]:.4f} ms)"
            + ("" if plain is None else f"; plain count {plain['count'][0]:.4f} ms, plain no "
               f"normals {plain['no_normals'][0]:.4f} ms")
            + f"; trips a ray: mean {ts['mean']:.3f}, p50 {ts['p50']:.0f}, p99 {ts['p99']:.0f}, "
            f"max {ts['max']}; divergence factor {ts['divergence']:.3f} ({smi})")
        for i, v in enumerate(variants, start=1):
            entry = dict(call=label, rays=args[5].shape[0], active=int(act.sum()),
                         ms=times[i][0], host_us=times[i][1], k1_ms=k1_ms,
                         bound_ms=bnds[v][0], bound_by=bnds[v][1], max_abs_err=errs[v],
                         **(ts if v == "count" else {}))
            if v not in first:  # the JSON entry: the first set's figures, every set's call
                first[v] = [entry]
                report(f"traverse_nearest_{v}", "voxtracer_torch/csrc/traverse.cu",
                       "voxtracer/kernels/pallas_dda.py:1048", errs[v], times[i], plain[v],
                       bnds[v], None, phase=30, calls=first[v])
            else:
                first[v].append(entry)
        del got, k1
    del cscene, cv, cargs, sets

    # ---- the fused step under each ablation and under none
    rows = {}
    try:
        for flag in (None,) + ABLATIONS:
            if flag:
                setattr(volumetric, flag, True)
            what = flag or "no ablation"
            reset_counts()
            loss, grads = train.binned_grads(params, scene, plan)
            torch.cuda.synchronize()
            c = {kk: v for kk, v in counts().items() if kk in OPTION_KERNELS}
            paths[f"[30] 1080p gradient, {what}"] = c
            check(math.isfinite(float(loss)) and all(
                bool(torch.isfinite(getattr(grads, f)).all())
                for f in ("density_logits", "albedo_table")), f"[30] {what}: not finite")
            if flag is None:
                for kk in ("traverse_nearest", "lookup_rows", "lookup_rows_bwd"):
                    check(c[kk] > 0, f"[30] {kk} not launched by the gradient")
            rows[what] = dict(loss=float(loss), launches=c,
                              times=host_times(lambda: train.fused_step(params, scene, cfg,
                                                                        fold_in(key, 1), plan)),
                              busy=busy_share(lambda: train.binned_grads(params, scene, plan)))
            if flag:
                setattr(volumetric, flag, False)
    finally:
        for flag in ABLATIONS:
            setattr(volumetric, flag, False)
    none = rows["no ablation"]["busy"][0]
    for what, r in rows.items():
        t = r["times"]
        log(f"[30] fused step {cfg.width}x{cfg.height}, (2,10)@4 bins, {what}: median "
            f"{t[0]:.1f} ms, min {t[1]:.1f} ms, spread {t[2]:.1f} ms; gradient device "
            f"{r['busy'][0]:.2f} ms of {r['busy'][1]:.1f} ms profiled (busy {r['busy'][2]:.1%}; "
            f"{1 - r['busy'][0] / none:+.1%} of the unablated gradient's device time saved); loss "
            f"{r['loss']:.6f}; launches {r['launches']} ({smi})")

    # ---- the dense per-pair gradient with and without the rematerialisation
    def dense(band):
        """-> loss, gradients, ms, and the peak memory above what was
        allocated before the step."""
        tgt = torch.zeros((band, cfg.width, 3), device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, g = volumetric.value_and_grad(volumetric.mse_loss)(params, scene, cfg, tgt,
                                                                 DENSE_STEPS, rows=band)
        torch.cuda.synchronize()
        return (loss, g, (time.perf_counter() - t0) * 1e3,
                torch.cuda.max_memory_allocated() - held)

    band = None
    for rows_ in (cfg.height, cfg.height // 2, cfg.height // 4, cfg.height // 8):
        try:
            dense(rows_)
            band = rows_
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
    check(band is not None, "[30] no band of the dense gradient fits")
    reset_counts()
    loss0, g0, ms0, peak0 = dense(band)
    paths[f"[30] dense gradient, {band} rows"] = c = {kk: v for kk, v in counts().items()
                                                     if kk in OPTION_KERNELS}
    check(c["lookup_rows"] > 0 and c["lookup_rows_bwd"] > 0,
          "[30] the dense gradient launched no K4 or K4-bwd")
    volumetric._REMAT = True
    try:
        reset_counts()
        loss1, g1, ms1, peak1 = dense(band)
        paths[f"[30] dense gradient, {band} rows, remat"] = {kk: v for kk, v in counts().items()
                                                            if kk in OPTION_KERNELS}
    finally:
        volumetric._REMAT = False
    rel = {f: rel_l2(getattr(g1, f), getattr(g0, f)) for f in ("density_logits", "albedo_table")}
    for f, r in rel.items():
        check(r <= 1e-6, f"[30] remat gradient {f}: relative L2 {r} against the stored one")
    check(float(loss0) == float(loss1), f"[30] remat loss {float(loss1)} against {float(loss0)}")
    log(f"[30] dense gradient {cfg.width}x{band} (the largest band of 1080 / 2^i rows that fits "
        f"without remat), {DENSE_STEPS} steps a pair: stored {ms0:.1f} ms, peak "
        f"{peak0 / 2**30:.2f} GiB ({peak0} bytes above what was held before the step); remat "
        f"{ms1:.1f} ms, peak {peak1 / 2**30:.2f} GiB ({peak1} bytes): peak x{peak1 / peak0:.3f}, "
        f"time x{ms1 / ms0:.3f}; gradients "
        f"relative L2 density {rel['density_logits']:.3g}, albedo {rel['albedo_table']:.3g}; "
        f"launches stored {paths[f'[30] dense gradient, {band} rows']}, remat "
        f"{paths[f'[30] dense gradient, {band} rows, remat']} ({smi})")
    return paths


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="DIR",
                    help="an unpacked checkout of another commit: time its K1, K2, K4, "
                         "K4-bwd, P1 and P4 beside this one's, in turns, on the calls the "
                         "path makes")
    baseline = ap.parse_args(argv).baseline
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    import numpy as np

    from voxtracer_torch import probe
    from voxtracer_torch.core import mathx
    from voxtracer_torch.core.rng import (fold_in, hash_uniform, make_key, threefry_normal,
                                          threefry_uniform)
    from voxtracer_torch.core.types import GLASS, MAT_NONE, SMOKE_LOW_DENSITY, SMOKE_PLAYER
    from voxtracer_torch.diff import train, volumetric
    from voxtracer_torch.kernels import build, lookup, probes, traverse
    from voxtracer_torch.kernels import bounce as bounce_kernel
    from voxtracer_torch.kernels import rng as rng_kernel
    from voxtracer_torch.kernels.dda import BIG, EXIT_GLASS, EXIT_SMOKE
    from voxtracer_torch.kernels.dda_occ import entry_t
    from voxtracer_torch.render import integrator, reproject
    from voxtracer_torch.render.camera import primary_rays
    from voxtracer_torch.scene.presets import (city_xl_like_path, glass_sphere_box, media_path,
                                               monu_like_path)

    dev = torch.device("cuda", 0)

    # ---- 1. device
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[1] device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
        f"nvidia-smi: {smi}")

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.lib()
    log(f"[2] build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")
    ptx = ptxas_functions(lib_path.with_suffix(".log").read_text())
    for f in ptx:
        log(f"    ptxas: {f['name']}: {f.get('registers')} registers, {f.get('stack')} bytes "
            f"stack frame, {f.get('spill_stores')} bytes spill stores, {f.get('spill_loads')} "
            f"bytes spill loads")
    check(any(f["name"].startswith("traverse_kernel") for f in ptx),
          "no traverse_kernel in ptxas' report")
    # with --baseline: another checkout's K1/K2 and K4/K4-bwd, timed in
    # turns with this one's (baseline, this, this, baseline)
    base = lookup_of(baseline) if baseline else None
    base_tr = traverse_of(baseline) if baseline else None
    if base_tr is not None:
        for f in ptxas_functions(base_tr.build.build().with_suffix(".log").read_text()):
            log(f"    baseline ptxas: {f['name']}: {f.get('registers')} registers, "
                f"{f.get('stack')} bytes stack frame, {f.get('spill_stores')} bytes spill "
                f"stores, {f.get('spill_loads')} bytes spill loads")

    # ---- 3. each kernel against its plain version at the slice's shapes
    scene, cfg = monu_like_path(1920, 1080, bounces=4)
    scene = scene.to(dev)
    vols = scene.volumes
    vargs = (vols.grids.reshape(-1), vols.gridsize, vols.inv, vols.fwd, vols.cube_min)
    n = cfg.width * cfg.height
    key = make_key(0)
    # the frame's primary rays, with the path mode's pixel jitter
    py, px = torch.meshgrid(torch.arange(cfg.height, dtype=torch.float32, device=dev),
                            torch.arange(cfg.width, dtype=torch.float32, device=dev),
                            indexing="ij")
    u = hash_uniform(key, 100, (n, 2), dev)
    o, d = primary_rays(scene.camera, cfg.width, cfg.height,
                        px.reshape(-1) + u[:, 0], py.reshape(-1) + u[:, 1])
    o = o.contiguous()
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    results = []

    def report(kname, source, replaces, err, kern, plain, bnd, library, phase=3, **extra):
        """kern, plain and library are per_launch results (library may be
        None)."""
        results.append(dict(name=kname, route="cuda", source=source,
                            replaces=replaces, launches=0, max_abs_err=err,
                            ms=kern[0], host_us=kern[1], plain_ms=plain[0],
                            plain_host_us=plain[1], bound_ms=bnd[0], bound_by=bnd[1],
                            library_ms=library and library[0],
                            library_host_us=library and library[1], **extra))
        lib_txt = "none" if library is None else f"{library[0]:.4f} ms ({library[1]:.1f} us host)"
        log(f"[{phase}] {kname}: max_abs_err {err:.3g}; per launch: kernel {kern[0]:.4f} ms "
            f"({kern[1]:.1f} us host), plain {plain[0]:.4f} ms ({plain[1]:.1f} us host), "
            f"bound {bnd[0]:.4f} ms ({bnd[1]}; bytes {bnd[2]:.4f} ms, operations "
            f"{bnd[3]:.4f} ms), library {lib_txt} ({smi})")

    def reset_counts():
        for c in (traverse.launches, lookup.launches, probes.launches, rng_kernel.launches,
                  bounce_kernel.launches):
            for kk in c:
                c[kk] = 0

    def counts():
        return dict(traverse.launches, **lookup.launches, **probes.launches,
                    **rng_kernel.launches, **bounce_kernel.launches)

    def time_traversal(label, mode, args, plain_too=False, with_base=True):
        """K1 or K2 on one call: held against the plain version; then per
        launch the kernel, the baseline's in turns (unless with_base is off:
        a baseline may refuse the call's volume count) and, if plain_too,
        the plain version -> (the call's entry, kernel, plain or None,
        bound)."""
        k = traverse.traverse(*args, mode=mode)
        p = plain_traversal(args, mode)
        err = same_traversal(k, p, label)
        del p
        bnd, least = traverse_bound(args, k, mode)
        ex = explicit(args)
        kern, turns = in_turns(lambda: traverse.traverse(*args, mode=mode),
                               (lambda: base_tr.traverse(*ex, mode=mode))
                               if base_tr and with_base else None)
        plain = (per_launch(functools.partial(traverse.traverse_plain, *args, mode=mode),
                            windows=3) if plain_too else None)
        nr, na, nh = args[5].shape[0], int(args[8].sum()), int(k["hit"].sum())
        log(f"    {label}: {nr} rays, {na} active, {nh} hits; kernel {kern[0]:.4f} ms "
            f"({kern[1]:.1f} us host) = {bnd[0] / kern[0]:.0%} of bound {bnd[0]:.4f} ms "
            f"({bnd[1]}; bytes {bnd[2]:.4f} ms, operations {bnd[3]:.4f} ms)"
            + (f", plain {plain[0]:.4f} ms" if plain else "") + turns_text(turns)
            + f"; least walk steps {least} ({smi})")
        entry = dict(call=label, rays=nr, active=na, hits=nh, ms=kern[0], host_us=kern[1],
                     bound_ms=bnd[0], bound_by=bnd[1], share=bnd[0] / kern[0],
                     plain_ms=plain and plain[0], max_abs_err=err)
        if turns:  # the baseline's mean over its two turns
            entry.update(baseline_ms=statistics.mean(ms for ms, _ in turns["baseline"]),
                         baseline_host_us=statistics.mean(us for _, us in turns["baseline"]))
        return entry, kern, plain, bnd

    # K1 on the frame's primary rays, as find_nearest_world passes them (no
    # t limit, every volume)
    args1 = (*vargs, o, d, None, ones, None, vols.occ, vols.bricksize)
    e1, kern1, plain1, bnd1 = time_traversal("K1 primary rays", "nearest", args1,
                                             plain_too=True)
    report("traverse_nearest", "voxtracer_torch/csrc/traverse.cu",
           "voxtracer/kernels/pallas_dda.py:1048", e1["max_abs_err"], kern1, plain1, bnd1,
           None, primary=e1)

    # K2: the primary hits' shadow rays to the point light, as
    # is_occluded_world passes them (every volume)
    k = traverse.traverse(*args1, mode="nearest")
    hit = k["hit"]
    nrm = torch.stack([k["nx"], k["ny"], k["nz"]], -1)
    ph = o + k["t"][:, None] * d
    so = mathx.offset_ray(ph, nrm).contiguous()
    to_l = scene.lights.point_pos[0] - so
    dst = torch.sqrt(mathx.dot3(to_l, to_l))
    sd = (to_l / dst[:, None]).contiguous()
    args2 = (*vargs, so, sd, dst, hit, None, vols.occ, vols.bricksize)
    e2, kern2, plain2, bnd2 = time_traversal("K2 primary shadow rays", "occluded", args2,
                                             plain_too=True)
    report("traverse_occluded", "voxtracer_torch/csrc/traverse.cu",
           "voxtracer/kernels/pallas_dda.py:1048", 0.0, kern2, plain2, bnd2, None, primary=e2)

    # K3: rays started inside the glass and smoke cells of the media scene
    mscene, mcfg = media_path(256, 256)
    mscene = mscene.to(dev)
    mv = mscene.volumes
    mvargs = (mv.grids.reshape(-1), mv.gridsize, mv.inv, mv.fwd, mv.cube_min)
    mn = mcfg.width * mcfg.height
    my, mx = torch.meshgrid(torch.arange(mcfg.height, dtype=torch.float32, device=dev) + 0.5,
                            torch.arange(mcfg.width, dtype=torch.float32, device=dev) + 0.5,
                            indexing="ij")
    mo, md = primary_rays(mscene.camera, mcfg.width, mcfg.height, mx.reshape(-1), my.reshape(-1))
    mo = mo.contiguous()
    mh = traverse.traverse(*mvargs, mo, md, torch.full((mn,), BIG, device=dev),
                           torch.ones(mn, dtype=torch.bool, device=dev),
                           torch.ones(mv.n, dtype=torch.bool, device=dev), mv.occ,
                           mv.bricksize, mode="nearest")
    glass = mh["hit"] & (mh["cell"] == GLASS)
    smoke = mh["hit"] & (mh["cell"] >= SMOKE_LOW_DENSITY) & (mh["cell"] <= SMOKE_PLAYER)
    check(int(glass.sum()) > 0 and int(smoke.sum()) > 0, "media rays reach glass and smoke")
    mnrm = torch.stack([mh["nx"], mh["ny"], mh["nz"]], -1)
    eo = mathx.offset_ray(mo + mh["t"][:, None] * md, -mnrm).contiguous()
    emask = glass | smoke
    code = torch.where(glass, EXIT_GLASS, EXIT_SMOKE).to(torch.int32)
    evol = mh["vol"].contiguous()

    def exit_k():
        return traverse.exit_march(*mvargs, eo, md, emask, code, evol, mv.occ, mv.bricksize)

    def exit_p(tally=None):
        return traverse.exit_march_plain(*mvargs, eo, md, emask, code, evol, mv.occ,
                                         mv.bricksize, tally=tally)

    tally3 = {}
    k3, p3 = exit_k(), exit_p(tally3)
    err3 = same_exit(k3, p3, emask, "K3")
    left = int(k3["in_vol"].sum())
    log(f"    K3: {int(glass.sum())} glass + {int(smoke.sum())} smoke rays of {mn}, "
        f"{left} left their medium inside the grid; plain walk steps {tally3}")
    report("exit_march", "voxtracer_torch/csrc/traverse.cu",
           "voxtracer/kernels/pallas_dda.py:903", err3,
           per_launch(exit_k), per_launch(exit_p),
           exit_bound((*mvargs, eo, md, emask, code, evol, mv.occ, mv.bricksize), k3, tally3),
           None)

    # K4 over the material table, 2,073,600 random ids, out-of-range ones
    # included (timed in [7], at the shapes and ids the path makes)
    m = scene.materials
    mtab = torch.cat([m.albedo, m.roughness[:, None], m.emissive[:, None],
                      m.ior[:, None]], dim=1).contiguous()
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(-8, 264, (n,), generator=gen, device=dev, dtype=torch.int32)
    check(torch.equal(lookup.lookup_rows(mtab, idx), lookup.lookup_rows_plain(mtab, idx)),
          "K4 rows differ")

    # the random streams at the frames' shapes
    rng_draws(dev, key, n, report)

    # the bounce's shading kernels at the frame's shapes (bounces 0 and 1)
    bounce_stages(dev, scene, cfg, key, report)

    # ---- 4 + 5. the forward half of the main path, counted: 1080p
    # monu-like, then media
    reset_counts()
    img = integrator.render_tiled(scene, cfg, key, 1, 1)
    torch.cuda.synchronize()
    mean = float(img.mean())
    check(tuple(img.shape) == (1080, 1920, 3), f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "1080p image has non-finite values")
    check(0.02 < mean < 10.0, f"1080p image mean {mean}")
    after_monu = counts()
    for kk in ("traverse_nearest", "traverse_occluded", "lookup_rows", "bounce_hit",
               "bounce_nee", "bounce_continue"):
        check(after_monu[kk] > 0, f"{kk} not launched by the 1080p frame")
    log(f"[4] 1080p path frame: mean {mean:.4f}; launches {after_monu}")

    mimg = integrator.render_tiled(mscene, mcfg, key, 1, 1)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(mimg).all()), "media image has non-finite values")
    fwd_counts = counts()
    check(fwd_counts["exit_march"] > 0, "exit_march not launched by the media frame")
    log(f"[5] media 256x256 path frame: mean {float(mimg.mean()):.4f}; "
        f"launches {fwd_counts}")

    # forward time: 1 warm-up + 3 reps of the full frame
    times = []
    integrator.render_tiled(scene, cfg, fold_in(key, 1), 1, 1)
    torch.cuda.synchronize()
    for rep in range(3):
        t0 = time.perf_counter()
        integrator.render_tiled(scene, cfg, fold_in(key, 2 + rep), 1, 1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    log(f"[4] forward 1920x1080, 4 bounces, 1 spp: median {med:.1f} ms, "
        f"min {min(times):.1f} ms, spread {max(times) - min(times):.1f} ms "
        f"-> {n / med / 1e3:.3f} Mrays/s ({smi}); reps {times}")
    if base_tr is not None:
        # the same frame with the baseline's K1/K2 swapped in (given the
        # explicit t limits and enabled flags its callers allocated), in
        # turns: baseline, this, this, baseline; median of 3 frames each
        def base_traverse(*args, mode="nearest"):
            return base_tr.traverse(*explicit(args), mode=mode)

        def frame_median(traverse_fn):
            kept = integrator.traverse
            integrator.traverse = traverse_fn
            try:
                return host_times(lambda: integrator.render_tiled(scene, cfg, fold_in(key, 5), 1,
                                                                  1))[0]
            finally:
                integrator.traverse = kept

        turns_f = [frame_median(f) for f in (base_traverse, traverse.traverse,
                                             traverse.traverse, base_traverse)]
        log(f"[4] forward 1920x1080 in turns baseline, this, this, baseline (K1/K2 swapped): "
            + ", ".join(f"{ms:.1f} ms" for ms in turns_f) + f" ({smi})")

    # ---- 6. a whole image through the kernels vs through the plain versions
    sscene, scfg = monu_like_path(256, 128, bounces=4)
    sscene = sscene.to(dev)
    a = integrator.render_tiled(sscene, scfg, key, 1, 1)

    with plain_versions():
        b = integrator.render_tiled(sscene, scfg, key, 1, 1)
    frac, dmax = pixels_off(a, b)
    log(f"[6] 256x128 kernels vs plain: max diff {dmax:.3g}, "
        f"{frac:.4%} of pixels differ by more than 1e-3")

    # ---- 7. the gradient step's precompute, then K4's backward against its
    # plain version at the step's shapes
    t0 = time.perf_counter()
    params = volumetric.params_from_scene(scene)
    plan = train.prepare_bins(scene, cfg, torch.zeros((cfg.height, cfg.width, 3), device=dev),
                              bin_steps=(2, 10), edges=(4.0,), tiles=2, span_steps=1)
    core_rows = max(b.o.shape[0] for b in plan.bins if b.steps == 10)
    log(f"[7] 1080p bins (2 bands, (2,10) steps at edge 4), k = {plan.k} of "
        f"{vols.n}: " + ", ".join(f"{b.n_active} rays @ {b.steps} steps"
                                   f"{' + clamp' if b.clamp else ''}" for b in plan.bins)
        + f"; precompute {time.perf_counter() - t0:.1f} s")

    def bwd_err(ct, idx, k, acc=None, hold=True):
        """K4-bwd against its plain version -> (largest error, largest error
        over its tolerance); fails past the tolerance if `hold`."""
        got = lookup.lookup_rows_bwd(ct, idx, k, acc=acc)
        want = lookup.lookup_rows_bwd_plain(ct, idx, k)
        err = (got - want).abs()
        tol = 1e-5 * lookup.lookup_rows_bwd_plain(ct.abs(), idx, k) + 1e-6
        ratio = float((err / tol).max())
        check(not hold or ratio <= 1.0, f"K4 backward [{k}, {ct.shape[1]}] (acc={acc}) out of "
              f"tolerance: error {ratio:.3g} x the tolerance")
        check(float(want.abs().max()) > 0, "K4 backward: an all-zero cotangent sum")
        return float(err.max()), ratio

    # albedo: ~10 core steps x the band's active rays, material ids as the
    # march's cell column gives them (sampled cells), then out-of-range ids
    n_alb = 10 * core_rows
    cells = torch.randint(0, vols.grids.numel(), (n_alb,), generator=gen, device=dev)
    idx_m = vols.grids.reshape(-1)[cells].to(torch.int32)
    idx_o = torch.randint(-8, 264, (n_alb,), generator=gen, device=dev, dtype=torch.int32)
    ct3 = torch.randn((n_alb, 3), generator=gen, device=dev)
    # brick sigma: one brick segment of the core bin over the [V * M^3, 1] table
    k_b = vols.n * vols.occ.shape[2]
    idx_b = torch.randint(-8, k_b + 8, (core_rows,), generator=gen, device=dev,
                          dtype=torch.int32)
    ct1 = torch.randn((core_rows, 1), generator=gen, device=dev)
    err7 = max(bwd_err(ct3, idx_m, 256)[0], bwd_err(ct3, idx_o, 256)[0],
               bwd_err(ct1, idx_b, k_b)[0])

    # K4 and K4-bwd at the shapes the path really uses, with the ids it
    # really makes: the largest call per table shape in one 1080p frame
    # (material [256,6], bounce 0), one whitted 512x512 frame (the queue's
    # material [256,5], its first pass) and one binned gradient (albedo
    # [256,3], the largest core chunk; brick sigma [2048,1], the largest
    # lead/tail segment)
    wscene, wcfg = glass_sphere_box(512, 512)
    wscene = wscene.to(dev)
    calls, tcalls, ends = {}, [], []
    with captured_lookups(calls), captured_traversals(tcalls):
        integrator.render_tiled(scene, cfg, key, 1, 1)
        ends.append(len(tcalls))
        integrator.render_tiled(wscene, wcfg, key, 1, 1)
        ends.append(len(tcalls))
        train.binned_grads(params, scene, plan)
    torch.cuda.synchronize()
    # K3's calls: the whitted frame's, then those of the media 256^2 path
    # frame and of two media reproject frames
    mcalls = []
    with captured_traversals(mcalls):
        integrator.render_tiled(mscene, mcfg, key, 1, 1)
        ends.append(len(mcalls))
        mh_ = torch.zeros((mcfg.height, mcfg.width, 3), device=dev)
        for i in range(2):
            _, mh_, _ = reproject.render_reproject_frame(
                mscene, dataclasses.replace(mcfg, mode="reproject"), mscene.camera, mh_,
                fold_in(key, i))
    torch.cuda.synchronize()
    exits = {"whitted 512^2 frame": [a for m_, a in tcalls[ends[0]:ends[1]] if m_ == "exit"],
             "media 256^2 path frame": [a for m_, a in mcalls[:ends[2]] if m_ == "exit"],
             "media 256^2 reproject, 2 frames": [a for m_, a in mcalls[ends[2]:] if m_ == "exit"]}
    del mcalls
    traced = {"path 1080p frame": [c for c in tcalls[:ends[0]] if c[0] != "exit"],
              "whitted 512^2 frame": [c for c in tcalls[ends[0]:ends[1]] if c[0] != "exit"],
              "gradient": [c for c in tcalls[ends[1]:] if c[0] != "exit"]}
    for pth, want in (("path 1080p frame", ("nearest", "occluded")),
                      ("whitted 512^2 frame", ("nearest", "occluded")), ("gradient", ("nearest",))):
        for mode in want:
            check(any(m == mode for m, _ in traced[pth]), f"no {mode} traversal in the {pth}")
    fwd_keys = [("fwd", 256, 6), ("fwd", 256, 5), ("fwd", 256, 3), ("fwd", k_b, 1)]
    bwd_keys = [("bwd", 256, 3), ("bwd", k_b, 1)]
    for key_ in fwd_keys + bwd_keys:
        check(key_ in calls, f"no K4 call {key_} in the frame and the gradient")
    def measure(what, run, run_base, plain, library, lib_name, bnd, variants):
        """Per-launch times of one shape -> (kernel, plain, bound, library,
        the shape's JSON entry); logs them beside the bound, then the
        kernel's variants (name -> call) timed the same way."""
        kern, turns = in_turns(run, base and run_base)
        plain, lib = per_launch(plain), per_launch(library)
        txt = (f"    {what}: kernel {kern[0]:.4f} ms ({kern[1]:.1f} us host; "
               f"{bnd[0] / kern[0]:.0%} of bound {bnd[0]:.4f} ms, {bnd[1]}), plain "
               f"{plain[0]:.4f} ms, {lib_name} {lib[0]:.4f} ms ({lib[1]:.1f} us host)")
        txt += turns_text(turns)
        var = {name: per_launch(f) for name, f in variants.items()}
        if var:
            txt += "; variants " + ", ".join(f"{name} {ms:.4f} ms ({us:.1f} us host)"
                                             for name, (ms, us) in var.items())
        log(txt + f" ({smi})")
        return kern, plain, bnd, lib, dict(shape=what, ms=kern[0], host_us=kern[1],
                                           plain_ms=plain[0], bound_ms=bnd[0], bound_by=bnd[1],
                                           library_ms=lib[0], library_host_us=lib[1],
                                           turns=turns, variants=var)

    shapes = {"lookup_rows": [], "lookup_rows_bwd": []}
    first = {}
    for key_ in fwd_keys:
        tab, idx_ = calls[key_]
        got = lookup.lookup_rows(tab, idx_)
        check(torch.equal(got, lookup.lookup_rows_plain(tab, idx_)),
              f"K4 rows differ at {list(tab.shape)} x {idx_.shape[0]}")
        cidx = idx_.clamp(0, tab.shape[0] - 1)
        *m_, entry = measure(
            f"K4 {list(tab.shape)} x {idx_.shape[0]}", lambda: lookup.lookup_rows(tab, idx_),
            lambda: base.lookup_rows(tab, idx_), lambda: lookup.lookup_rows_plain(tab, idx_),
            lambda: torch.index_select(tab, 0, cidx), "index_select",
            bound(nbytes(tab, idx_, got), 3 * got.numel()), {})  # clamp twice, load
        shapes["lookup_rows"].append(entry)
        first.setdefault("lookup_rows", m_)

    def bwd_bound(ct, idx, k):  # clamp twice and one add per element
        return bound(nbytes(ct, idx) + k * ct.shape[1] * 4, 3 * ct.numel())

    for key_ in bwd_keys:
        ct_, idx_, kk = calls[key_]
        # the plan's accumulator is held to the tolerance; the other one's
        # error is reported beside it
        planned = lookup.bwd_plan(ct_.shape[0], kk, ct_.shape[1], lookup.device_consts(0)[0])[0]
        errs = {v: bwd_err(ct_, idx_, kk, v, hold=v == planned) for v in ("shared", "direct")}
        err7 = max(err7, errs[planned][0])
        n_ = idx_.shape[0]
        cnt = torch.unique(idx_.clamp(0, kk - 1), return_counts=True)[1]
        log(f"    K4-bwd [{kk}, {ct_.shape[1]}] x {idx_.shape[0]}: plan acc={planned}; error / "
            f"tolerance " + ", ".join(f"acc={v} {r:.3g}" for v, (_, r) in errs.items())
            + f"; {cnt.numel()} distinct ids, the commonest on {float(cnt.max()) / n_:.1%} of "
            f"the rows; {float((ct_ != 0).any(1).float().mean()):.1%} of the rows non-zero, sum "
            f"of |ct| {float(ct_.abs().sum()):.6g}")
        acc = ct_.new_zeros((kk, ct_.shape[1]))
        cidx = idx_.clamp(0, kk - 1)
        *m_, entry = measure(
            f"K4-bwd [{kk}, {ct_.shape[1]}] x {idx_.shape[0]}",
            lambda: lookup.lookup_rows_bwd(ct_, idx_, kk),
            lambda: base.lookup_rows_bwd(ct_, idx_, kk),
            lambda: lookup.lookup_rows_bwd_plain(ct_, idx_, kk),
            lambda: acc.index_add_(0, cidx, ct_), "f32 index_add_", bwd_bound(ct_, idx_, kk),
            {f"acc={v}": functools.partial(lookup.lookup_rows_bwd, ct_, idx_, kk, acc=v)
             for v in ("shared", "direct")})
        shapes["lookup_rows_bwd"].append(entry)
        first.setdefault("lookup_rows_bwd", m_)
    # K4-bwd on one-signed rows at the brick-sigma shape, where the plan
    # (which reads shapes only) picks the direct accumulator: the gradient's
    # own ids with the zero rows replaced, then 2,918,400 rows on 4 bricks,
    # then on 1; both accumulators are held to the tolerance
    ct_b, idx_b, _ = calls[("bwd", k_b, 1)]
    fill = torch.rand(ct_b.shape, generator=gen, device=dev) + 0.5
    n_c = 2_918_400
    four = torch.randint(0, k_b, (4,), generator=gen, device=dev, dtype=torch.int32)
    ct_c = torch.rand((n_c, 1), generator=gen, device=dev) + 0.5
    one_signed = {
        f"the gradient's {idx_b.shape[0]} ids, zero rows replaced":
            (torch.where(ct_b == 0, fill, ct_b.abs()), idx_b),
        f"{n_c} rows on 4 bricks":
            (ct_c, four[torch.randint(0, 4, (n_c,), generator=gen, device=dev)].contiguous()),
        f"{n_c} rows on 1 brick": (ct_c, four[:1].expand(n_c).contiguous())}
    for what, (ct_, idx_) in one_signed.items():
        planned = lookup.bwd_plan(ct_.shape[0], k_b, 1, lookup.device_consts(0)[0])[0]
        errs = {v: bwd_err(ct_, idx_, k_b, v)[1] for v in ("shared", "direct")}
        if base is not None:  # the baseline's direct accumulator, not held
            want = lookup.lookup_rows_bwd_plain(ct_, idx_, k_b)
            tol = 1e-5 * lookup.lookup_rows_bwd_plain(ct_.abs(), idx_, k_b) + 1e-6
            errs["baseline direct"] = float(
                ((base.lookup_rows_bwd(ct_, idx_, k_b, acc="direct") - want).abs() / tol).max())
        kern, turns = in_turns(lambda: lookup.lookup_rows_bwd(ct_, idx_, k_b),
                               base and (lambda: base.lookup_rows_bwd(ct_, idx_, k_b)))
        log(f"    K4-bwd [{k_b}, 1] one-signed, {what}: plan acc={planned}; error / tolerance "
            + ", ".join(f"{v} {r:.3g}" for v, r in errs.items())
            + f"; kernel {kern[0]:.4f} ms ({kern[1]:.1f} us host)" + turns_text(turns)
            + f" ({smi})")
        shapes["lookup_rows_bwd"].append(dict(shape=f"K4-bwd [{k_b}, 1] one-signed, {what}",
                                              ms=kern[0], host_us=kern[1], plan=planned,
                                              error_over_tolerance=errs, turns=turns))
    del one_signed, ct_b, ct_c, fill
    # each JSON entry: the first shape (material [256,6]; albedo [256,3]),
    # the others under "shapes"
    for kname, replaces, err in (("lookup_rows", "voxtracer/kernels/lookup.py:33", 0.0),
                                 ("lookup_rows_bwd", "voxtracer/diff/volumetric.py:95", err7)):
        report(kname, "voxtracer_torch/csrc/lookup.cu", replaces, err, *first[kname], phase=7,
               shapes=shapes[kname])

    # K1 and K2 on every call the path frame, the whitted frame and the
    # gradient made, each held against the plain version; the plain version
    # timed on the first call of each kind per path
    log("[7] K1 and K2 on the calls of one 1080p path frame, one whitted 512x512 frame and "
        "one binned gradient:")
    for pth, cl in traced.items():
        seen = {}
        for mode, args in cl:
            i = seen[mode] = seen.get(mode, -1) + 1
            entry = time_traversal(f"{pth}, {('K1', 'K2')[mode == 'occluded']} call {i}", mode,
                                   args, plain_too=i == 0)[0]
            entry["path"] = pth
            next(r for r in results if r["name"] == f"traverse_{mode}") \
                .setdefault("calls", []).append(entry)
    del tcalls, traced

    # K3 on every exit call of the whitted frame and the media frames, each
    # held against the plain version; beside each the launch floor: an
    # empty launch of the same grid
    log("[7] K3 on the exit calls of one whitted 512x512 frame, one media 256x256 path frame "
        "and two media reproject frames:")
    k3_entry = next(r for r in results if r["name"] == "exit_march")
    for pth, cl in exits.items():
        check(len(cl) > 0, f"no exit march in the {pth}")
        for i, args in enumerate(cl):
            label = f"{pth}, K3 call {i}"
            tally = {}
            k = traverse.exit_march(*args)
            err = same_exit(k, traverse.exit_march_plain(*args, tally=tally), args[7], label)
            bnd = exit_bound(args, k, tally)
            kern, turns = in_turns(lambda: traverse.exit_march(*args),
                                   base_tr and (lambda: base_tr.exit_march(*args)))
            nr, na = args[5].shape[0], int(args[7].sum())
            floor = per_launch(lambda: traverse.launch_floor(nr, dev))
            least = max(bnd[0], floor[0])
            log(f"    {label}: {nr} rays, {na} march, {int(k['in_vol'].sum())} leave inside the "
                f"grid; kernel {kern[0]:.4f} ms ({kern[1]:.1f} us host) = {bnd[0] / kern[0]:.0%} "
                f"of bound {bnd[0]:.4f} ms ({bnd[1]}; bytes {bnd[2]:.4f} ms, operations "
                f"{bnd[3]:.4f} ms), {least / kern[0]:.0%} of the larger of the bound and the "
                f"launch floor {floor[0]:.4f} ms ({floor[1]:.1f} us host)" + turns_text(turns)
                + f" ({smi})")
            entry = dict(call=label, path=pth, rays=nr, active=na, ms=kern[0], host_us=kern[1],
                         bound_ms=bnd[0], bound_by=bnd[1], share=bnd[0] / kern[0],
                         floor_ms=floor[0], share_of_bound_or_floor=least / kern[0],
                         max_abs_err=err)
            if turns:
                entry.update(
                    baseline_ms=statistics.mean(ms for ms, _ in turns["baseline"]),
                    baseline_host_us=statistics.mean(us for _, us in turns["baseline"]))
            k3_entry.setdefault("calls", []).append(entry)
    del exits

    # ---- 8. the gradient half of the main path, counted, then the fused
    # step (forward frame + gradient) timed
    reset_counts()
    loss, grads = train.binned_grads(params, scene, plan)
    torch.cuda.synchronize()
    grad_counts = counts()
    for kk in ("traverse_nearest", "lookup_rows", "lookup_rows_bwd"):
        check(grad_counts[kk] > 0, f"{kk} not launched by the 1080p gradient")
    for f in ("density_logits", "albedo_table"):
        gf = getattr(grads, f)
        check(bool(torch.isfinite(gf).all()), f"{f} gradient has non-finite values")
        check(float(gf.abs().max()) > 0, f"{f} gradient is all zero")
    log(f"[8] 1080p gradient: loss {float(loss):.6f}, |d density| {float(grads.density_logits.norm()):.4g}, "
        f"|d albedo| {float(grads.albedo_table.norm()):.4g}; launches {grad_counts}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        train.binned_grads(params, scene, plan)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"[8] binned gradient alone (after the counted run as warm-up): median "
        f"{statistics.median(times):.1f} ms, min {min(times):.1f} ms, spread "
        f"{max(times) - min(times):.1f} ms ({smi}); reps {times}")
    torch.cuda.reset_peak_memory_stats()
    train.fused_step(params, scene, cfg, fold_in(key, 10), plan)
    torch.cuda.synchronize()
    times = []
    for rep in range(3):
        t0 = time.perf_counter()
        img_mean, _ = train.fused_step(params, scene, cfg, fold_in(key, 11 + rep), plan)
        float(img_mean)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    log(f"[8] fused step 1920x1080 (forward frame + binned gradient): median {med:.1f} ms, "
        f"min {min(times):.1f} ms, spread {max(times) - min(times):.1f} ms "
        f"-> {n / med / 1e3:.3f} Mrays/s fwd+bwd; peak memory {peak / 2**30:.2f} GiB "
        f"({peak} bytes) ({smi}); reps {times}")

    # ---- 9. one gradient through the kernels vs through the plain versions
    sparams = volumetric.params_from_scene(sscene)
    splan = train.prepare_bins(sscene, scfg, torch.zeros((scfg.height, scfg.width, 3), device=dev))

    def grad_and_image():
        _, g = train.binned_grads(sparams, sscene, splan)
        return g, volumetric.render_diff(sparams, sscene, scfg, 10, k=splan.k, span_steps=1)

    ga, ia = grad_and_image()
    with plain_versions():
        gb, ib = grad_and_image()
    rel = {}
    for f in ("density_logits", "albedo_table"):
        a, b = getattr(ga, f), getattr(gb, f)
        check(float(b.abs().max()) > 0, f"plain {f} gradient is all zero")
        rel[f] = float((a - b).norm() / b.norm())
        check(rel[f] <= 1e-4, f"{f} gradient: kernels vs plain relative L2 {rel[f]}")
    idiff = float((ia - ib).abs().max())
    check(idiff <= 1e-5, f"relaxed image: kernels vs plain max diff {idiff}")
    log(f"[9] 256x128 gradient kernels vs plain: relative L2 density {rel['density_logits']:.3g}, "
        f"albedo {rel['albedo_table']:.3g}; relaxed image max diff {idiff:.3g}")

    # ---- 10. the trainer: 3 Adam steps at 1080p on the union-span march
    step, init = train.make_train_step(cfg, n_steps=10, lr=1e-2, k=plan.k, span_steps=1)
    tparams = volumetric.params_from_scene(scene)
    opt = init(tparams)
    zero = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    losses, times = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        tparams, opt, tl = step(tparams, opt, scene, zero)
        losses.append(float(tl))
        times.append((time.perf_counter() - t0) * 1e3)
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0], f"trainer losses {losses}")
    log(f"[10] trainer 1920x1080, 3 Adam steps: losses {losses}; step ms {times} ({smi})")

    # ---- 11. whitted: glass_sphere_box at 512x512, depth 5, through the
    # branch queue
    reset_counts()
    wimg = integrator.render_tiled(wscene, wcfg, key, 1, 1)
    torch.cuda.synchronize()
    whitted_counts = counts()
    for kk in ("traverse_nearest", "traverse_occluded", "exit_march", "lookup_rows"):
        check(whitted_counts[kk] > 0, f"{kk} not launched by the whitted frame")
    wmean = float(wimg.mean())
    check(tuple(wimg.shape) == (512, 512, 3), f"whitted image shape {tuple(wimg.shape)}")
    check(bool(torch.isfinite(wimg).all()), "whitted image has non-finite values")
    check(0.01 < wmean < 10.0, f"whitted image mean {wmean}")
    # the queue's figures, from one more (uncounted) pass over the frame's
    # primary rays in scanline order (render_tiled's are in tile order)
    wy, wx = torch.meshgrid(torch.arange(512.0, device=dev), torch.arange(512.0, device=dev),
                            indexing="ij")
    wo, wd = primary_rays(wscene.camera, 512, 512, wx.reshape(-1), wy.reshape(-1))
    qimg, iters, peak = integrator.whitted_queue(wscene, wcfg, wo.contiguous(), wd,
                                                 wcfg.max_bounces)
    pixels_off(qimg.reshape(512, 512, 3), wimg)
    log(f"[11] whitted 512x512 glassbox, depth {wcfg.max_bounces}: mean {wmean:.4f}; queue "
        f"{iters} iterations, peak population {peak} ({peak / (512 * 512):.2f} N); "
        f"launches {whitted_counts}")
    med, lo, spread, times = host_times(lambda: integrator.render_tiled(wscene, wcfg, key, 1, 1))
    log(f"[11] whitted 512x512, depth 5: median {med:.1f} ms, min {lo:.1f} ms, spread "
        f"{spread:.1f} ms -> {512 * 512 / med / 1e3:.3f} Mrays/s ({smi}); reps {times}")

    # ---- 12. the 512x512 whitted frame of [11] through the kernels vs
    # through the plain versions
    t0 = time.perf_counter()
    with plain_versions():
        b = integrator.render_tiled(wscene, wcfg, key, 1, 1)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    frac, dmax = pixels_off(wimg, b)
    log(f"[12] whitted 512x512 depth 5 kernels vs plain: max diff {dmax:.3g}, "
        f"{frac:.4%} of pixels differ by more than 1e-3; plain frame {plain_s:.2f} s")

    # ---- 13. reproject: the 1080p monu-like frame, 4 bounces; frame 0
    # fills the history (counted), then 1 warm-up and 3 timed frames; then
    # the media scene (counted on its own)
    rcfg = dataclasses.replace(cfg, mode="reproject")
    hist = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    reset_counts()
    rimg, hist, gbuf = reproject.render_reproject_frame(scene, rcfg, scene.camera, hist, key)
    torch.cuda.synchronize()
    rp_counts = counts()
    for kk in ("traverse_nearest", "traverse_occluded", "lookup_rows"):
        check(rp_counts[kk] > 0, f"{kk} not launched by the reproject frame")
    for what, x in (("image", rimg), ("history", hist)):
        check(tuple(x.shape) == (1080, 1920, 3), f"reproject {what} shape {tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()), f"reproject {what} has non-finite values")
    rmean = float(rimg.mean())
    check(0.02 < rmean < 1.0, f"reproject image mean {rmean}")
    hit_share = float((gbuf["m0"] != MAT_NONE).float().mean())
    log(f"[13] reproject 1920x1080, 4 bounces: image mean {rmean:.4f}, history mean "
        f"{float(hist.mean()):.4f}, {hit_share:.1%} first hits; launches {rp_counts}")
    frame = 0

    def next_frame():
        nonlocal rimg, hist, frame
        frame += 1
        rimg, hist, _ = reproject.render_reproject_frame(scene, rcfg, scene.camera, hist,
                                                         fold_in(key, frame))

    med, lo, spread, times = host_times(next_frame)
    check(bool(torch.isfinite(rimg).all() and torch.isfinite(hist).all()),
          "reproject frames 1-4 have non-finite values")
    log(f"[13] reproject 1920x1080, frame 1 warm-up, frames 2-4 timed, each blending with "
        f"the history: median {med:.1f} ms, min {lo:.1f} ms, spread {spread:.1f} ms -> "
        f"{n / med / 1e3:.3f} Mrays/s ({smi}); frames {times}")
    # the jax.random streams one bounce draws: uniform (n,2), (n,3), (n,)
    # and normal (n,3) twice
    tk = fold_in(key, 5)
    rng_ms = (per_launch(lambda: threefry_uniform(tk, (n, 2), dev))[0]
              + per_launch(lambda: threefry_uniform(tk, (n, 3), dev))[0]
              + per_launch(lambda: threefry_uniform(tk, (n,), dev))[0]
              + 2 * per_launch(lambda: threefry_normal(tk, (n, 3), dev))[0])
    log(f"[13] threefry streams of one 1080p bounce: {rng_ms:.2f} ms of device time "
        f"(x {rcfg.max_bounces + 1} bounces at most) ({smi})")
    mrcfg = dataclasses.replace(mcfg, mode="reproject")
    mhist = torch.zeros((mcfg.height, mcfg.width, 3), device=dev)
    reset_counts()
    for i in range(2):
        mrimg, mhist, _ = reproject.render_reproject_frame(mscene, mrcfg, mscene.camera, mhist,
                                                           fold_in(key, i))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(mrimg).all()), "media reproject image has non-finite values")
    media_rp_counts = counts()
    check(media_rp_counts["exit_march"] > 0,
          "exit_march not launched by the media reproject frames")
    log(f"[13] media 256x256 reproject, 2 frames: mean {float(mrimg.mean()):.4f}; "
        f"launches {media_rp_counts}")

    # ---- 14. a resolved reproject frame through the kernels vs through the
    # plain versions: frame 0 fills the history, frame 1 blends with it
    qscene, qcfg = monu_like_path(256, 128, bounces=4)
    qscene = qscene.to(dev)
    qcfg = dataclasses.replace(qcfg, mode="reproject")

    def two_frames():
        h0 = torch.zeros((128, 256, 3), device=dev)
        _, h1, _ = reproject.render_reproject_frame(qscene, qcfg, qscene.camera, h0, key)
        return reproject.render_reproject_frame(qscene, qcfg, qscene.camera, h1,
                                                fold_in(key, 1))[:2]

    a, ah = two_frames()
    with plain_versions():
        b, bh = two_frames()
    frac, dmax = pixels_off(a, b)
    hfrac, hmax = pixels_off(ah, bh)
    log(f"[14] reproject 256x128 kernels vs plain (frame 1): image max diff {dmax:.3g}, "
        f"{frac:.4%} of pixels off by more than 1e-3; history max diff {hmax:.3g}, {hfrac:.4%}")

    # ---- 15. the kernel probes: each probe kernel against its plain
    # version at B = 32, 256 and 1024 over random int32 tables and indices
    # (near and far floats for P4) at the entry point's loop counts, timed
    # at B = 256 and 1024 (P1 and P4 take their few-ops forms there; with
    # --baseline: each probe at each B in turns with the other checkout's,
    # at k and 2k iterations for cycles an iteration); then the entry point
    # voxtracer_torch.probe, counted, with each probe in cycles an iteration
    # at each B
    prng = np.random.default_rng(15)
    probe_src = dict(P1="scripts/probe_pallas.py:78", P3="scripts/probe_pallas.py:118",
                     P4="scripts/probe_pallas.py:162")
    base_probes = probes_of(baseline) if baseline else None
    max_clock = float(probe.smi("clocks.max.sm").split()[0]) * 1e6

    def wide(shape):
        return torch.from_numpy(prng.integers(-2 ** 31, 2 ** 31 - 1, shape)
                                .astype(np.int32)).to(dev)

    for b in (32, 256, 1024):
        far = prng.uniform(size=(b, 128)) < 0.25
        y = np.where(far, prng.uniform(-1e9, 2e9, (b, 128)), prng.uniform(-100, 100, (b, 128)))
        pargs = dict(P1=(wide((b, 128)), wide((b, 128))), P3=(wide((16, 128)), wide((b, 128))),
                     P4=(wide((b, 128)), torch.from_numpy(y.astype(np.float32)).to(dev)))
        for pid, args in pargs.items():
            pname = probe.KERNELS[pid]
            kern, plain = getattr(probes, pname), getattr(probes, pname + "_plain")
            kname = pname if pid == "P3" else f"{pname}_{probes.form(pname, b)}"
            it = probe.START_K[pid]
            got, want = kern(*args, it), plain(*args, it)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{kname} [B={b}] differs from its plain version")
            turns = None
            if base_probes is not None:
                base_kern = getattr(base_probes, pname)
                check(torch.equal(base_kern(*args, it), want),
                      f"baseline {pname} [B={b}] differs from the plain version")
                kt, turns = in_turns(lambda: kern(*args, it), lambda: base_kern(*args, it))
                _, turns2 = in_turns(lambda: kern(*args, 2 * it),
                                     lambda: base_kern(*args, 2 * it))
                cyc = {w: (statistics.mean(ms for ms, _ in turns2[w])
                           - statistics.mean(ms for ms, _ in turns[w])) * 1e-3 / it * max_clock
                       for w in ("this", "baseline")}
                log(f"[15] {kname} [B={b}], {it} iterations: kernel {kt[0]:.4f} ms "
                    f"({kt[1]:.1f} us host){turns_text(turns)}; at {2 * it}"
                    f"{turns_text(turns2)[1:]}; cycles an iteration at "
                    f"{max_clock / 1e6:.0f} MHz: this {cyc['this']:.2f}, baseline "
                    f"{cyc['baseline']:.2f} ({smi})")
            if b == 32:
                continue
            report(kname, "voxtracer_torch/csrc/probes.cu", probe_src[pid], 0.0,
                   per_launch(lambda: kern(*args, it)),
                   per_launch(lambda: plain(*args, it), windows=3),
                   bound(nbytes(*args, got), probe.COUNTS[pid][2] * it * got.numel()), None,
                   phase=15, rows=b)
            if turns:  # the baseline's mean over its two turns
                results[-1].update(
                    baseline_ms=statistics.mean(ms for ms, _ in turns["baseline"]),
                    baseline_host_us=statistics.mean(us for _, us in turns["baseline"]))
    log(f"[15] lane_gather, chain_gather, alu_loop equal their plain versions at B = 32, "
        f"256, 1024 ({probe.START_K} iterations)")
    for f in ptx:
        if f["name"].startswith(("lane_gather_kernel", "chain_gather_kernel", "alu_loop_kernel")):
            log(f"[15] ptxas: {f['name']}: {f.get('registers')} registers, {f.get('stack')} "
                f"bytes stack frame, {f.get('spill_stores')} bytes spill stores")
            check(f.get("stack") == 0 and f.get("spill_stores") == 0,
                  f"ptxas: {f['name']} has a stack frame or spills")
    reset_counts()
    measured = probe.main()
    torch.cuda.synchronize()
    probe_counts = counts()
    for kk in probes.launches:
        check(probe_counts[kk] > 0, f"{kk} not launched by voxtracer_torch.probe")
    for r in measured:
        check(math.isfinite(r["ns"]) and r["ns"] > 0 and r["bound_ns"] > 0,
              f"probe {r['probe']} [B={r['B']}]: {r['ns']} ns/idx")
    log(f"[15] voxtracer_torch.probe: {len(measured)} probes; launches {probe_counts}")
    for pid in ("P1", "P3", "P4"):
        log(f"[15] {pid} cycles an iteration: " + "; ".join(
            f"B = {r['B']}: {r['cycles']:.2f} ({r['ns']:.6f} ns/idx, clocks.sm "
            f"{r['clocks_sm'][0]} -> {r['clocks_sm'][1]})" for r in measured if r["probe"] == pid)
            + f" ({smi})")

    # ---- 16. past 64 volumes: the city_xl-layout stand-in (110 procedural
    # 64^3 buildings and the floor, 5 pages), one 1080p 4-bounce frame
    # through the entry point with the bounce reorder on "auto", counted;
    # then timed as the port runs it (one launch over all volumes), with a
    # launch a page (the page-by-page walk of the CPU path, swapped in here
    # for the card) and without the reorder
    t0 = time.perf_counter()
    cscene, ccfg = city_xl_like_path(1920, 1080)
    cscene = cscene.to(dev)
    cv = cscene.volumes
    check(cv.n == 111 and len(cv.pages) == 5, f"city layout: {cv.n} volumes")
    check(integrator._pages(cscene, cv.inv) is None, "the card walks pages")
    log(f"[16] city_xl-layout stand-in: {cv.n} volumes of {cv.pad_size}^3 in pages "
        f"{[(p.vol_off, p.n) for p in cv.pages]} (walk order), grids "
        f"{nbytes(cv.grids) / 2**20:.0f} MiB, occupancy {nbytes(cv.occ) / 2**20:.0f} MiB; "
        f"built in {time.perf_counter() - t0:.1f} s")
    reset_counts()
    cimg = integrator.render_tiled(cscene, ccfg, key, 1, 1)
    torch.cuda.synchronize()
    city_counts = counts()
    for kk in ("traverse_nearest", "traverse_occluded", "lookup_rows"):
        check(city_counts[kk] > 0, f"{kk} not launched by the 111-volume frame")
    cmean = float(cimg.mean())
    check(tuple(cimg.shape) == (1080, 1920, 3), f"city image shape {tuple(cimg.shape)}")
    check(bool(torch.isfinite(cimg).all()), "city image has non-finite values")
    check(0.02 < cmean < 10.0, f"city image mean {cmean}")
    log(f"[16] 111 volumes, 1080p path frame, reorder auto: mean {cmean:.4f}; launches "
        f"{city_counts}")

    def paged_on_card(scene_, rays):
        return scene_.volumes.pages if integrator._is_paged(scene_) else None

    def city_frame(pages_fn=None, **cfg_kw):
        kept = integrator._pages
        if pages_fn is not None:
            integrator._pages = pages_fn
        try:
            return host_times(lambda: integrator.render_tiled(
                cscene, dataclasses.replace(ccfg, **cfg_kw), fold_in(key, 1), 1, 1))
        finally:
            integrator._pages = kept

    for what, kw in (("one launch, reorder auto", {}),
                     ("a launch a page, reorder auto", dict(pages_fn=paged_on_card)),
                     ("one launch, reorder none", dict(bounce_reorder="none")),
                     ("a launch a page, reorder none", dict(pages_fn=paged_on_card,
                                                            bounce_reorder="none")),
                     ("one launch, reorder auto, again", {})):
        med, lo, spread, times = city_frame(**kw)
        log(f"[16] 111 volumes 1920x1080, 4 bounces, {what}: median {med:.1f} ms, min {lo:.1f} "
            f"ms, spread {spread:.1f} ms -> {n / med / 1e3:.3f} Mrays/s ({smi}); reps {times}")

    # K1 and K2 on every call of that frame (reorder auto): one launch
    # against the plain walk and against a launch a page; how many rays each
    # page's cull keeps; then one launch with the floor's page first
    ccalls = []
    with captured_traversals(ccalls):
        integrator.render_tiled(cscene, ccfg, key, 1, 1)
    torch.cuda.synchronize()
    floor_page = int((cv.gridsize == 1).nonzero()[0, 0]) // 24
    first = list(range(24 * floor_page, min(24 * floor_page + 24, cv.n)))
    perm = torch.tensor(first + [i for i in range(cv.n) if i not in first], device=dev)
    fvargs = (cv.grids[perm].reshape(-1), cv.gridsize[perm], cv.inv[perm], cv.fwd[perm],
              cv.cube_min[perm])
    focc, fbsz = cv.occ[:, perm].contiguous(), cv.bricksize[perm]
    log("[16] K1 and K2 on the calls of the 111-volume 1080p frame:")
    seen = {}
    for mode, args in ccalls:
        i = seen[mode] = seen.get(mode, -1) + 1
        label = f"city_xl_like 1080p frame, {('K1', 'K2')[mode == 'occluded']} call {i}"
        entry = time_traversal(label, mode, args, with_base=False)[0]
        entry["path"] = "city_xl_like 1080p frame"
        o_, d_, tl_, act_ = args[5:9]
        kept_rays = []

        def counting(*a, mode="nearest"):
            kept_rays.append(int(a[8].sum()))
            return traverse.traverse(*a, mode=mode)

        integrator.traverse = counting
        try:
            g = integrator._paged_traverse(cscene, o_, d_, tl_, act_, None, mode)
        finally:
            integrator.traverse = traverse.traverse
        k = traverse.traverse(*args, mode=mode)
        for f in k:
            check(torch.equal(k[f], g[f]), f"{label}: a launch a page differs in {f}")
        fargs = (*fvargs, o_, d_, tl_, act_, None, focc, fbsz)
        kf = traverse.traverse(*fargs, mode=mode)
        check(torch.equal(k["hit"], kf["hit"]), f"{label}: floor page first differs in hit")
        other_vol = 0
        if mode == "nearest":
            check(torch.equal(k["t"], kf["t"]), f"{label}: floor page first differs in t")
            # an exact tie can go to another volume in another order
            other_vol = int((torch.where(k["hit"], perm[kf["vol"].clamp(min=0).long()]
                                         .to(torch.int32), -2) != k["vol"]).sum())
        one, paged, paged2, one2, ffirst = (per_launch(f) for f in (
            lambda: traverse.traverse(*args, mode=mode),
            lambda: integrator._paged_traverse(cscene, o_, d_, tl_, act_, None, mode),
            lambda: integrator._paged_traverse(cscene, o_, d_, tl_, act_, None, mode),
            lambda: traverse.traverse(*args, mode=mode),
            lambda: traverse.traverse(*fargs, mode=mode)))
        log(f"      one launch {one[0]:.4f} / {one2[0]:.4f} ms ({one[1]:.1f} us host), a launch a "
            f"page {paged[0]:.4f} / {paged2[0]:.4f} ms ({paged[1]:.1f} us host), pages keep "
            f"{kept_rays} of {int(act_.sum())} active rays; one launch, floor page first "
            f"{ffirst[0]:.4f} ms, {other_vol} rays with another volume id ({smi})")
        entry.update(paged_ms=statistics.mean((paged[0], paged2[0])), paged_host_us=paged[1],
                     page_rays=kept_rays, floor_first_ms=ffirst[0])
        next(r for r in results if r["name"] == f"traverse_{mode}")["calls"].append(entry)
    # the same frame's calls without the reorder, kernel times only: what
    # the re-clustering buys K1 and K2
    ncalls = []
    with captured_traversals(ncalls):
        integrator.render_tiled(cscene, dataclasses.replace(ccfg, bounce_reorder="none"), key,
                                1, 1)
    torch.cuda.synchronize()
    for mode in ("nearest", "occluded"):
        ms_r = [e["ms"] for e in next(r for r in results if r["name"] == f"traverse_{mode}")
                ["calls"] if e["path"] == "city_xl_like 1080p frame"]
        ms_n = [per_launch(lambda: traverse.traverse(*a, mode=mode))[0]
                for m_, a in ncalls if m_ == mode]
        log(f"[16] {('K1', 'K2')[mode == 'occluded']} calls of the frame, ms: reorder auto "
            + " / ".join(f"{x:.4f}" for x in ms_r) + f" (sum {sum(ms_r):.4f}); reorder none "
            + " / ".join(f"{x:.4f}" for x in ms_n) + f" (sum {sum(ms_n):.4f}) ({smi})")
    del ncalls
    # what one reorder costs: the sort key, the stable sort and the gather,
    # on the rays of the frame's second K1 call
    o_, d_, _, act_ = [a for m_, a in ccalls if m_ == "nearest"][1][5:9]
    pk = torch.zeros((integrator._PK_ROWS, n), device=dev)
    pk[0:3], pk[3:6], pk[integrator._PK_ACTIVE] = o_.t(), d_.t(), act_.float()
    wlo, whi = integrator._world_bounds(cscene)
    wspan = torch.clamp(whi - wlo, min=1e-6)
    mkey = integrator._morton_key(pk, wlo, wspan)
    mperm = torch.sort(mkey, stable=True)[1]
    reorder_ms = {name: per_launch(f)[0] for name, f in (
        ("key", lambda: integrator._morton_key(pk, wlo, wspan)),
        ("stable sort", lambda: torch.sort(mkey, stable=True)),
        ("gather", lambda: pk.index_select(1, mperm)))}
    log(f"[16] one reorder of {n} rays ({int(act_.sum())} active): "
        + ", ".join(f"{k_} {v_:.3f} ms" for k_, v_ in reorder_ms.items()) + f" ({smi})")
    pmin_ms = per_launch(lambda: [entry_t(p_.inv, p_.cube_min, o_, d_).amin(0)
                                  for p_ in cv.pages], windows=3)[0]
    log(f"[16] the paged walk's entry pass over the 5 pages (plain torch): {pmin_ms:.3f} ms "
        f"a call ({smi})")
    del ccalls, fvargs, focc, pk

    # ---- 17. a 256x128 frame of that scene through the kernels vs the plain
    # versions: as the preset renders it (below "auto"'s ray count: no
    # reorder), held to the image gate; then with the reorder forced on.
    # There one ulp in a bounce origin (t within 1e-6) can move a ray across
    # a sort cell, and every lane between its two places then draws another
    # sample: such a pixel differs by Monte-Carlo noise, not by an error, so
    # that frame is held to at most 1% of pixels off by more than 1e-3 (the
    # path tolerance of the CPU tests against the JAX package)
    c2 = dataclasses.replace(ccfg, width=256, height=128)
    a = integrator.render_tiled(cscene, c2, key, 1, 1)
    c2r = dataclasses.replace(c2, bounce_reorder="always")
    ar = integrator.render_tiled(cscene, c2r, key, 1, 1)
    with plain_versions():
        b = integrator.render_tiled(cscene, c2, key, 1, 1)
        br = integrator.render_tiled(cscene, c2r, key, 1, 1)
    frac, dmax = pixels_off(a, b)
    rfrac = float(((ar - br).abs().amax(-1) > 1e-3).float().mean())
    check(rfrac <= 0.01, f"reordered frame: {rfrac:.4%} of pixels differ by more than 1e-3")
    check(float(((ar - a).abs().amax(-1) > 1e-3).float().mean()) > 0.05,
          "the reorder changed no samples")
    log(f"[17] 111 volumes 256x128 kernels vs plain: max diff {dmax:.3g}, "
        f"{frac:.4%} of pixels differ by more than 1e-3; reorder forced on: {rfrac:.4%}")
    del cscene, cv

    # ---- 18-21. the replay gradients and the thin-lens frame
    replay_paths = replay_phases(scene, cfg, key, smi, reset_counts, counts, time_traversal,
                                 measure, bwd_err, results)

    # ---- 22-24. .vox loading, the asset presets and the game, on stand-ins
    asset_paths = asset_phases(dev, key, smi, reset_counts, counts, time_traversal, results)

    # ---- 25-28. the live viewer, the sharded paths, the scaling bench and
    # the sharded frames of one global wavefront
    live_paths = live_dist_phases(dev, key, smi, reset_counts, counts)

    # ---- 29. the JAX package's render options, each beside the run without it
    t0 = time.perf_counter()
    option_paths = options_phase(dev, scene, cfg, params, plan, key, smi, reset_counts, counts,
                                 measure, results)
    log(f"[29] {time.perf_counter() - t0:.1f} s")

    # ---- 30. the JAX package's last switches: K1's variants, the gradient's
    # ablations, the rematerialised dense march
    t0 = time.perf_counter()
    switch_paths = switches_phase(dev, scene, cfg, params, plan, key, args1, smi, reset_counts,
                                  counts, report)
    log(f"[30] {time.perf_counter() - t0:.1f} s")

    # ---- results: launches per path, then summed over all of them
    paths = {"path 1080p frame": after_monu,
             "path media frame": {kk: fwd_counts[kk] - after_monu[kk] for kk in fwd_counts},
             "gradient": grad_counts, "whitted 512^2 frame": whitted_counts,
             "reproject 1080p frame 0": rp_counts, "reproject media, 2 frames": media_rp_counts,
             "probe": probe_counts, "city_xl_like 1080p frame": city_counts, **replay_paths,
             **asset_paths, **live_paths, **option_paths, **switch_paths}
    for pth, c in paths.items():
        log(f"[launches] {pth}: {c}")
    for r in results:
        r["launches"] = sum(c.get(r["name"], 0) for c in paths.values())
    # K1 and K2 keep everything in registers
    for f in ptx:
        if f["name"].startswith("traverse_kernel"):
            check(f.get("stack") == 0, f"ptxas: {f['name']} has a {f.get('stack')}-byte stack "
                  f"frame")
    log(json.dumps({"kernels": results}))
    log(f"gpu: {smi}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
