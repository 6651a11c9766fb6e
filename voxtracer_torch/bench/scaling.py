"""Scaling of the ray-sharded render: rays/s at 1, 2 and 4 ranks
(counterpart of voxtracer/bench/scaling.py, the BASELINE scaling metric).

Each world size runs as that many fresh processes (``dist.multihost
.spawn``), each rank on a card in turn (``multihost.rank_device``): with
one card the ranks share it and time-slice it (gloo), with a card a rank
they run side by side (NCCL).  The scene is ``monu_path`` at gridsize 64
with one model and 4 bounces, as the JAX module's; its ``.vox`` file comes
from ``$VOX_ASSETS``.  Prints one JSON line a world size (devices,
seconds, rays_s, efficiency) and the card's name and power limit.  Not
the port bench: it writes no ``BENCHMARK.json``.

Run: python -m voxtracer_torch.bench.scaling [width height spp reps]
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def _rank(width, height, spp, reps, device):
    """One rank's share: build the scene, one warm-up frame, then `reps`
    timed frames of render_sharded -> seconds a frame (host clock, the
    image gathered and the device synchronised)."""
    import torch

    from voxtracer_torch.core.rng import fold_in, make_key
    from voxtracer_torch.dist.mesh import make_mesh, render_sharded
    from voxtracer_torch.scene.presets import monu_path

    mesh = make_mesh(device=device)
    scene, cfg = monu_path(width=width, height=height, gridsize=64, which=(1,), bounces=4)
    scene = scene.to(mesh.device)
    key = make_key(0)

    def frame(k):
        img = render_sharded(scene, cfg, k, spp, mesh)
        if img.is_cuda:
            torch.cuda.synchronize(img.device)
        return img

    frame(key)
    t0 = time.perf_counter()
    for i in range(reps):
        frame(fold_in(key, i))
    return (time.perf_counter() - t0) / reps


def measure(width=256, height=144, spp=1, reps=3, sizes=(1, 2, 4), device="cuda"):
    """rays/s of render_sharded at each world size in `sizes` -> a list of
    dicts (devices, seconds, rays_s, efficiency against 1 rank)."""
    from voxtracer_torch.dist.multihost import spawn

    results = []
    for n in sizes:
        dt = max(spawn(_rank, n, (width, height, spp, reps, device), device=device))
        rays = width * height * spp / dt
        eff = 1.0 if not results else rays / (results[0]["rays_s"] * n)
        results.append(dict(devices=n, seconds=dt, rays_s=rays, efficiency=eff))
        print(json.dumps(results[-1]), flush=True)
    return results


def main(argv=None):
    import torch

    if not torch.cuda.is_available():
        print("scaling: no CUDA device", file=sys.stderr)
        return 2
    args = [int(a) for a in (sys.argv[1:] if argv is None else argv)]
    out = measure(*args)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"gpu: {smi.stdout.strip()} ({torch.cuda.device_count()} card(s))")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
