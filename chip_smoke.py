#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (voxtracer_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from voxtracer_torch/csrc, holds each kernel
against its plain PyTorch version at the shapes of the main path, renders
the 1080p 4-bounce path-traced forward frame of the asset-free monu-like
scene and the glass + smoke media scene through the port's entry point
(render_tiled), shows from the launch counters that the frame went
through every kernel, and compares a whole image rendered through the
kernels with one rendered through the plain versions.

Tolerances: hit, vol, cell and in_vol identical; t within rtol = atol =
1e-6; normals within 1e-5 (the kernel takes 1/sqrtf where the plain
version takes torch.rsqrt); lookup rows identical; whole images: at most
0.1% of pixels off by more than 1e-3.  Kernel and plain times are CUDA
event medians of 5 runs after one warm-up.

Phases print their results as they go.  Before the last line come one
JSON line with the per-kernel results and one line with the card's name
and power limit; the last line is {"ok": true, "device": {...}}.  Any
failed check raises, so the exit code is not 0.  Without a CUDA device
it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=5):
    """Median CUDA-event time of fn() in ms over `reps` runs after one
    warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from voxtracer_torch.core import mathx
    from voxtracer_torch.core.rng import fold_in, hash_uniform, make_key
    from voxtracer_torch.core.types import GLASS, SMOKE_LOW_DENSITY, SMOKE_PLAYER
    from voxtracer_torch.kernels import build, lookup, traverse
    from voxtracer_torch.kernels.dda import BIG, EXIT_GLASS, EXIT_SMOKE
    from voxtracer_torch.kernels.dda_occ import traverse_occ
    from voxtracer_torch.render import integrator
    from voxtracer_torch.render.camera import primary_rays
    from voxtracer_torch.scene.presets import media_path, monu_like_path

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
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log("    ptxas:", line.strip())

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
    ven = torch.ones(vols.n, dtype=torch.bool, device=dev)
    big = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    results = []

    def report(kname, source, replaces, err, ms, plain_ms):
        results.append(dict(name=kname, route="cuda", source=source,
                            replaces=replaces, launches=0, max_abs_err=err,
                            ms=ms, plain_ms=plain_ms))
        log(f"[3] {kname}: max_abs_err {err:.3g}; kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms ({smi})")

    def near(fn):
        return fn(*vargs, o, d, big, ones, ven, vols.occ, vols.bricksize, mode="nearest")

    k = near(traverse.traverse)
    p = near(traverse_occ)
    torch.cuda.synchronize()
    for f in ("hit", "vol", "cell"):
        check(torch.equal(k[f], p[f].to(k[f].dtype)), f"K1 {f} differs")
    check(torch.allclose(k["t"], p["t"], rtol=1e-6, atol=1e-6), "K1 t")
    nerr = max(max_err(k[c], p[c]) for c in ("nx", "ny", "nz"))
    check(nerr <= 1e-5, f"K1 normals {nerr}")
    log(f"    K1: {int(k['hit'].sum())} of {n} primary rays hit")
    report("traverse_nearest", "voxtracer_torch/csrc/traverse.cu",
           "voxtracer/kernels/pallas_dda.py:1048", max(nerr, max_err(k["t"], p["t"])),
           cuda_ms(lambda: near(traverse.traverse)), cuda_ms(lambda: near(traverse_occ)))

    # K2: the primary hits' shadow rays to the point light
    hit = k["hit"]
    nrm = torch.stack([k["nx"], k["ny"], k["nz"]], -1)
    ph = o + k["t"][:, None] * d
    so = mathx.offset_ray(ph, nrm).contiguous()
    to_l = scene.lights.point_pos[0] - so
    dst = torch.sqrt(mathx.dot3(to_l, to_l))
    sd = (to_l / dst[:, None]).contiguous()

    def occl(fn):
        return fn(*vargs, so, sd, dst, hit, ven, vols.occ, vols.bricksize, mode="occluded")

    k2, p2 = occl(traverse.traverse), occl(traverse_occ)
    check(torch.equal(k2["hit"], p2["hit"]), "K2 hit differs")
    log(f"    K2: {int(k2['hit'].sum())} of {int(hit.sum())} shadow rays occluded")
    report("traverse_occluded", "voxtracer_torch/csrc/traverse.cu",
           "voxtracer/kernels/pallas_dda.py:1048", 0.0,
           cuda_ms(lambda: occl(traverse.traverse)), cuda_ms(lambda: occl(traverse_occ)))

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

    def exit_p():
        return traverse.exit_march_plain(*mvargs, eo, md, emask, code, evol, mv.occ,
                                         mv.bricksize)

    k3, p3 = exit_k(), exit_p()
    for f in ("in_vol", "cell"):
        check(torch.equal(k3[f], p3[f].to(k3[f].dtype)), f"K3 {f} differs")
    check(torch.allclose(k3["t"], p3["t"], rtol=1e-6, atol=1e-6), "K3 t")
    nerr3 = max(max_err(k3[c], p3[c]) for c in ("nx", "ny", "nz"))
    check(nerr3 <= 1e-5, f"K3 normals {nerr3}")
    log(f"    K3: {int(glass.sum())} glass + {int(smoke.sum())} smoke rays, "
        f"{int(k3['in_vol'].sum())} left their medium inside the grid")
    report("exit_march", "voxtracer_torch/csrc/traverse.cu",
           "voxtracer/kernels/pallas_dda.py:903", max(nerr3, max_err(k3["t"], p3["t"])),
           cuda_ms(exit_k), cuda_ms(exit_p))

    # K4: the material rows of 2,073,600 rays, out-of-range indices included
    m = scene.materials
    mtab = torch.cat([m.albedo, m.roughness[:, None], m.emissive[:, None],
                      m.ior[:, None]], dim=1).contiguous()
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(-8, 264, (n,), generator=gen, device=dev, dtype=torch.int32)
    k4, p4 = lookup.lookup_rows(mtab, idx), lookup.lookup_rows_plain(mtab, idx)
    check(torch.equal(k4, p4), "K4 rows differ")
    report("lookup_rows", "voxtracer_torch/csrc/lookup.cu",
           "voxtracer/kernels/lookup.py:33", 0.0,
           cuda_ms(lambda: lookup.lookup_rows(mtab, idx)),
           cuda_ms(lambda: lookup.lookup_rows_plain(mtab, idx)))

    # ---- 4 + 5. the main path, counted: 1080p monu-like, then media
    for c in (traverse.launches, lookup.launches):
        for kk in c:
            c[kk] = 0
    img = integrator.render_tiled(scene, cfg, key, 1, 1)
    torch.cuda.synchronize()
    mean = float(img.mean())
    check(tuple(img.shape) == (1080, 1920, 3), f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "1080p image has non-finite values")
    check(0.02 < mean < 10.0, f"1080p image mean {mean}")
    after_monu = dict(traverse.launches, **lookup.launches)
    for kk in ("traverse_nearest", "traverse_occluded", "lookup_rows"):
        check(after_monu[kk] > 0, f"{kk} not launched by the 1080p frame")
    log(f"[4] 1080p path frame: mean {mean:.4f}; launches {after_monu}")

    mimg = integrator.render_tiled(mscene, mcfg, key, 1, 1)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(mimg).all()), "media image has non-finite values")
    counts = dict(traverse.launches, **lookup.launches)
    check(counts["exit_march"] > 0, "exit_march not launched by the media frame")
    log(f"[5] media 256x256 path frame: mean {float(mimg.mean()):.4f}; launches {counts}")
    for r in results:
        r["launches"] = counts[r["name"]]

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

    # ---- 6. a whole image through the kernels vs through the plain versions
    sscene, scfg = monu_like_path(256, 128, bounces=4)
    sscene = sscene.to(dev)
    a = integrator.render_tiled(sscene, scfg, key, 1, 1)

    swapped = dict(traverse=integrator.traverse, exit_march=integrator.exit_march,
                   lookup_rows=integrator.lookup_rows)
    integrator.traverse = traverse_occ
    integrator.exit_march = traverse.exit_march_plain
    integrator.lookup_rows = lookup.lookup_rows_plain
    try:
        b = integrator.render_tiled(sscene, scfg, key, 1, 1)
    finally:
        for attr, fn in swapped.items():
            setattr(integrator, attr, fn)
    diff = (a - b).abs().amax(-1)
    frac = float((diff > 1e-3).float().mean())
    check(frac <= 1e-3, f"{frac:.4%} of pixels differ by more than 1e-3")
    log(f"[6] 256x128 kernels vs plain: max diff {float(diff.max()):.3g}, "
        f"{frac:.4%} of pixels differ by more than 1e-3")

    # ---- 7. results
    log(json.dumps({"kernels": results}))
    log(f"gpu: {smi}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
