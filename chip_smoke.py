#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (voxtracer_torch) on one GPU.

    python3 chip_smoke.py

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
  plain version at B = 32, 256 and 1024 first.

The launch counters show that each path went through its kernels, and
whole images (path, whitted, reproject) and a whole gradient through the
kernels are compared with ones through the plain versions.  Beside each
kernel's time stand its bound, the larger of its bytes over 3.35 TB/s and
its 32-bit operations over 67 T/s (the H100's HBM and fp32 peaks; for
the walks of K1-K3 the operations are the plain walk's step counts on the
same rays times each step's operations counted from csrc/traverse.cu),
and the time of one PyTorch call that computes the same function, where
there is one.

Tolerances: hit, vol, cell and in_vol identical; t within rtol = atol =
1e-6; normals within 1e-5 (the kernel takes 1/sqrtf where the plain
version takes torch.rsqrt); lookup rows and probe results identical;
lookup backward per entry within 1e-5 * (sum of |ct| over that entry's
rows) + 1e-6 (both sides add with atomics, in no fixed order); forward
images (and the
reproject history): at most 0.1% of pixels off by more than 1e-3
(whitted's per-pixel scatter-add runs in no fixed order); gradients:
relative L2 <= 1e-4 on both parameters and relaxed images within 1e-5.
Kernel and plain times are CUDA-event medians of 5 runs after one warm-up
(3 for the probes' plain loops); step times are host clocks around
synchronised runs, 1 warm-up and 3 reps.

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
import statistics
import subprocess
import sys
import time


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
OPS_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
# 32-bit operations per unit of the walk of csrc/traverse.cu, counted from
# its source (each add, multiply, compare, select, logic op, load,
# conversion or division one), per unit of dda_occ.STEPS: the entry test
# of a (ray, volume) pair (object_ray + entry_t), a walk's set-up
# (object_ray and entry_t again, six setup_axis), an outer iteration
# (brick index, 64-byte row read, OR), a descent (three axes re-seeded), a
# fine cell step and a macro brick step
WALK_OPS = dict(entries=120, walks=240, rows=30, descends=54, cells=41, bricks=17)


def log(*a):
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


@contextlib.contextmanager
def plain_versions():
    """Swap the plain versions in for the kernels in every binding the
    port reaches them through: the integrator's (which every renderer,
    render/reproject.py included, uses), the relaxed march's traversal and
    the lookup module's own names (which its autograd Function calls)."""
    from voxtracer_torch.diff import volumetric
    from voxtracer_torch.kernels import lookup, traverse
    from voxtracer_torch.kernels.dda_occ import traverse_occ
    from voxtracer_torch.render import integrator

    swaps = [(integrator, "traverse", traverse_occ),
             (integrator, "exit_march", traverse.exit_march_plain),
             (integrator, "lookup_rows", lookup.lookup_rows_plain),
             (volumetric, "traverse", traverse_occ),
             (lookup, "lookup_rows", lookup.lookup_rows_plain),
             (lookup, "lookup_rows_bwd", lookup.lookup_rows_bwd_plain)]
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


def main() -> int:
    import torch

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
    from voxtracer_torch.kernels.dda import BIG, EXIT_GLASS, EXIT_SMOKE
    from voxtracer_torch.kernels.dda_occ import traverse_occ
    from voxtracer_torch.render import integrator, reproject
    from voxtracer_torch.render.camera import primary_rays
    from voxtracer_torch.scene.presets import glass_sphere_box, media_path, monu_like_path

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
        if "registers" in line or "spill" in line or "properties for" in line:
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

    def report(kname, source, replaces, err, ms, plain_ms, bnd, library_ms, phase=3):
        results.append(dict(name=kname, route="cuda", source=source,
                            replaces=replaces, launches=0, max_abs_err=err,
                            ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                            library_ms=library_ms))
        lib_txt = "none" if library_ms is None else f"{library_ms:.3f} ms"
        log(f"[{phase}] {kname}: max_abs_err {err:.3g}; kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}; bytes {bnd[2]:.4f} ms, "
            f"operations {bnd[3]:.4f} ms), library {lib_txt} ({smi})")

    def reset_counts():
        for c in (traverse.launches, lookup.launches, probes.launches):
            for kk in c:
                c[kk] = 0

    def counts():
        return dict(traverse.launches, **lookup.launches, **probes.launches)

    def near(fn):
        return fn(*vargs, o, d, big, ones, ven, vols.occ, vols.bricksize, mode="nearest")

    k = near(traverse.traverse)
    tally1 = {}
    p = near(functools.partial(traverse_occ, tally=tally1))
    torch.cuda.synchronize()
    for f in ("hit", "vol", "cell"):
        check(torch.equal(k[f], p[f].to(k[f].dtype)), f"K1 {f} differs")
    check(torch.allclose(k["t"], p["t"], rtol=1e-6, atol=1e-6), "K1 t")
    nerr = max(max_err(k[c], p[c]) for c in ("nx", "ny", "nz"))
    check(nerr <= 1e-5, f"K1 normals {nerr}")
    hits = int(k["hit"].sum())
    log(f"    K1: {hits} of {n} primary rays hit; plain walk steps {tally1}")
    # the occupancy plane it walks, and one grid cell per hit
    report("traverse_nearest", "voxtracer_torch/csrc/traverse.cu",
           "voxtracer/kernels/pallas_dda.py:1048", max(nerr, max_err(k["t"], p["t"])),
           cuda_ms(lambda: near(traverse.traverse)), cuda_ms(lambda: near(traverse_occ)),
           bound(nbytes(o, d, big, ones, ven, vols.occ[0], *k.values()) + 4 * hits,
                 walk_ops(tally1)), None)

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

    tally2 = {}
    k2, p2 = occl(traverse.traverse), occl(functools.partial(traverse_occ, tally=tally2))
    check(torch.equal(k2["hit"], p2["hit"]), "K2 hit differs")
    log(f"    K2: {int(k2['hit'].sum())} of {int(hit.sum())} shadow rays occluded; "
        f"plain walk steps {tally2}")
    report("traverse_occluded", "voxtracer_torch/csrc/traverse.cu",
           "voxtracer/kernels/pallas_dda.py:1048", 0.0,
           cuda_ms(lambda: occl(traverse.traverse)), cuda_ms(lambda: occl(traverse_occ)),
           bound(nbytes(so, sd, dst, hit, ven, vols.occ[0], k2["hit"]), walk_ops(tally2)),
           None)

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
    for f in ("in_vol", "cell"):
        check(torch.equal(k3[f], p3[f].to(k3[f].dtype)), f"K3 {f} differs")
    check(torch.allclose(k3["t"], p3["t"], rtol=1e-6, atol=1e-6), "K3 t")
    nerr3 = max(max_err(k3[c], p3[c]) for c in ("nx", "ny", "nz"))
    check(nerr3 <= 1e-5, f"K3 normals {nerr3}")
    left = int(k3["in_vol"].sum())
    log(f"    K3: {int(glass.sum())} glass + {int(smoke.sum())} smoke rays of {mn}, "
        f"{left} left their medium inside the grid; plain walk steps {tally3}")
    report("exit_march", "voxtracer_torch/csrc/traverse.cu",
           "voxtracer/kernels/pallas_dda.py:903", max(nerr3, max_err(k3["t"], p3["t"])),
           cuda_ms(exit_k), cuda_ms(exit_p),
           bound(nbytes(eo, md, emask, code, evol, mv.occ[1:], *k3.values()) + 4 * left,
                 walk_ops(tally3)), None)

    # K4: the material rows of 2,073,600 rays, out-of-range indices included
    m = scene.materials
    mtab = torch.cat([m.albedo, m.roughness[:, None], m.emissive[:, None],
                      m.ior[:, None]], dim=1).contiguous()
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(-8, 264, (n,), generator=gen, device=dev, dtype=torch.int32)
    k4, p4 = lookup.lookup_rows(mtab, idx), lookup.lookup_rows_plain(mtab, idx)
    check(torch.equal(k4, p4), "K4 rows differ")
    # library: the gather alone, ids pre-clamped; 3 operations per element
    # (clamp twice, load)
    cidx = idx.long().clamp(0, mtab.shape[0] - 1)
    report("lookup_rows", "voxtracer_torch/csrc/lookup.cu",
           "voxtracer/kernels/lookup.py:33", 0.0,
           cuda_ms(lambda: lookup.lookup_rows(mtab, idx)),
           cuda_ms(lambda: lookup.lookup_rows_plain(mtab, idx)),
           bound(nbytes(mtab, idx, k4), 3 * k4.numel()),
           cuda_ms(lambda: torch.index_select(mtab, 0, cidx)))

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
    for kk in ("traverse_nearest", "traverse_occluded", "lookup_rows"):
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

    def bwd_err(ct, idx, k):
        got = lookup.lookup_rows_bwd(ct, idx, k)
        want = lookup.lookup_rows_bwd_plain(ct, idx, k)
        err = (got - want).abs()
        bound = 1e-5 * lookup.lookup_rows_bwd_plain(ct.abs(), idx, k) + 1e-6
        check(bool((err <= bound).all()), f"K4 backward [{k}, {ct.shape[1]}] out of tolerance")
        check(float(want.abs().max()) > 0, "K4 backward: an all-zero cotangent sum")
        return float(err.max())

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
    err7 = max(bwd_err(ct3, idx_m, 256), bwd_err(ct3, idx_o, 256), bwd_err(ct1, idx_b, k_b))

    def bwd_bound(ct, idx, k):  # clamp twice and one add per element
        return bound(nbytes(ct, idx) + k * ct.shape[1] * 4, 3 * ct.numel())

    def index_add_ms(ct, idx, k):
        ci = idx.long().clamp(0, k - 1)
        return cuda_ms(lambda: ct.new_zeros((k, ct.shape[1])).index_add_(0, ci, ct))

    for what, ct_, idx_, k_ in (("albedo [256,3]", ct3, idx_m, 256),
                                ("brick sigma", ct1, idx_b, k_b)):
        bnd = bwd_bound(ct_, idx_, k_)
        log(f"    K4 backward, {what} x {idx_.shape[0]} rows: kernel "
            f"{cuda_ms(lambda: lookup.lookup_rows_bwd(ct_, idx_, k_)):.3f} ms, plain (f64 "
            f"index_add_) {cuda_ms(lambda: lookup.lookup_rows_bwd_plain(ct_, idx_, k_)):.3f} ms, "
            f"f32 index_add_ {index_add_ms(ct_, idx_, k_):.3f} ms, bound {bnd[0]:.4f} ms "
            f"({bnd[1]}) ({smi})")
    report("lookup_rows_bwd", "voxtracer_torch/csrc/lookup.cu",
           "voxtracer/diff/volumetric.py:95", err7,
           cuda_ms(lambda: lookup.lookup_rows_bwd(ct3, idx_m, 256)),
           cuda_ms(lambda: lookup.lookup_rows_bwd_plain(ct3, idx_m, 256)),
           bwd_bound(ct3, idx_m, 256), index_add_ms(ct3, idx_m, 256), phase=7)

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
    wscene, wcfg = glass_sphere_box(512, 512)
    wscene = wscene.to(dev)
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
    rng_ms = (cuda_ms(lambda: threefry_uniform(tk, (n, 2), dev))
              + cuda_ms(lambda: threefry_uniform(tk, (n, 3), dev))
              + cuda_ms(lambda: threefry_uniform(tk, (n,), dev))
              + 2 * cuda_ms(lambda: threefry_normal(tk, (n, 3), dev)))
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
    # at B = 256; then the entry point voxtracer_torch.probe, counted
    prng = np.random.default_rng(15)
    probe_src = dict(P1="scripts/probe_pallas.py:78", P3="scripts/probe_pallas.py:118",
                     P4="scripts/probe_pallas.py:162")

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
            it = probe.START_K[pid]
            got, want = kern(*args, it), plain(*args, it)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{pname} [B={b}] differs from its plain version")
            if b != 256:
                continue
            report(pname, "voxtracer_torch/csrc/probes.cu", probe_src[pid], 0.0,
                   cuda_ms(lambda: kern(*args, it)), cuda_ms(lambda: plain(*args, it), reps=3),
                   bound(nbytes(*args, got), probe.COUNTS[pid][2] * it * got.numel()), None,
                   phase=15)
    log(f"[15] lane_gather, chain_gather, alu_loop equal their plain versions at B = 32, "
        f"256, 1024 ({probe.START_K} iterations)")
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

    # ---- results: launches per path, then summed over all of them
    paths = {"path 1080p frame": after_monu,
             "path media frame": {kk: fwd_counts[kk] - after_monu[kk] for kk in fwd_counts},
             "gradient": grad_counts, "whitted 512^2 frame": whitted_counts,
             "reproject 1080p frame 0": rp_counts, "reproject media, 2 frames": media_rp_counts,
             "probe": probe_counts}
    for pth, c in paths.items():
        log(f"[launches] {pth}: {c}")
    for r in results:
        r["launches"] = sum(c[r["name"]] for c in paths.values())
    log(json.dumps({"kernels": results}))
    log(f"gpu: {smi}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
