"""Device meshes and ray-sharded rendering over torch.distributed
(counterpart of voxtracer/dist/mesh.py).

The reference's only parallelism is a scanline ``for_each(par)`` + AVX2
packets (renderer.cpp:1662-1673).  Here the pixel batch shards over the
ranks of a mesh's axis: each rank traces a contiguous slice of the
lanes, the scene is replicated, and the bands are gathered at the end;
pixels are disjoint, so most frames need no other collective.

A sharded frame is the JAX package's ``render_sharded``: the pixel count
is padded to a multiple of the rank count (``n_pad``; pad lanes trace
pixel (0, 0)), path rays take their pixel jitter and lens sample from
``jax.random.uniform`` streams (threefry, salts 100 and 101 folded into
the sample's key) rather than ``render``'s hash streams, and every stream
is indexed over the global lanes, as XLA's partitioner keeps its
counters global: a rank draws its own lanes of each global stream
(``core.rng.counters``).  So the image equals the one-rank image bit for
bit whenever H*W is a multiple of the rank count; otherwise a path frame
draws over the n_pad lanes, as the JAX package's does.

Some frames need more than the ranks' own lanes, since the JAX package
runs them on the one global wavefront; ``RankComm`` carries their
exchanges.  The path integrator's bounce reorder sorts the whole
wavefront: each reorder gathers every rank's packed state, every rank
sorts it as one process would and keeps its window, and the radiance
goes back to its pixel through the gathered first-lane ids
(``integrator._trace_path_reordered``).  The wavefront compaction
(``compact_chunks``) gathers the packed state each bounce and partitions
it the same way (``integrator._trace_path_compacted``); its chunks, and
those of ``reorder_compact_chunks`` (the last live lane from one gather
of each rank's), are global lane ranges, of which each rank traces its
share at the chunk's lanes.  The whitted branch queue draws
random light choices and area-light samples at a branch's slot in the
global queue: every row keeps its global queue position, and one sum of
an indicator of the children's keys a queue iteration places each child
(``integrator._exact_queue``).  A whitted frame whose draws do not depend
on the slot (every light summed, no area light) runs each rank's rays as
a queue of their own, with no exchange.  Either way the queue runs in its
exact order, whose pixels do not depend on how the rays are split, nor
on ``whitted_sort_batch``, which there reorders only the dispatch of a
rank's batch.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from voxtracer_torch.core.rng import fold_in, threefry_uniform
from voxtracer_torch.dist.multihost import rank_device


@dataclass
class Mesh:
    """A grid of ranks, one device each.  coords: this rank's coordinates;
    groups: the process group along each axis (the ranks that differ from
    this one in that coordinate alone), empty for a single process;
    backend: the process group's ("nccl" or "gloo"), None for a single
    process."""

    axis_names: tuple
    shape: tuple
    coords: tuple
    device: torch.device
    groups: dict = field(default_factory=dict)
    backend: str | None = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def index(self) -> int:
        """This rank's place in the row-major order of the mesh."""
        return int(np.ravel_multi_index(self.coords, self.shape))


def _world() -> tuple:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def build_mesh(shape: tuple, axis_names: tuple, device="cuda") -> Mesh:
    """A mesh of the given shape over every rank of the process group
    (rank r at the row-major coordinates of r); every rank must call it,
    in the same order, since it creates the axes' groups."""
    rank, world = _world()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the process group "
                         f"has {world}")
    coords = [tuple(int(c) for c in np.unravel_index(r, shape)) for r in range(world)]
    groups = {}
    if world > 1:
        for a, name in enumerate(axis_names):
            # the lines of the mesh along axis a: ranks equal in every
            # other coordinate
            lines = {}
            for r, c in enumerate(coords):
                lines.setdefault(c[:a] + c[a + 1:], []).append(r)
            for line in sorted(lines):
                g = dist.new_group(lines[line])
                if rank in lines[line]:
                    groups[name] = g
    return Mesh(axis_names=tuple(axis_names), shape=tuple(shape), coords=coords[rank],
                device=rank_device(rank, device), groups=groups,
                backend=dist.get_backend() if world > 1 else None)


def make_mesh(n_devices: int | None = None, axis: str = "rays", device="cuda") -> Mesh:
    """1-D mesh over the process group's ranks (n_devices, if given, must
    be their count)."""
    n = n_devices or _world()[1]
    return build_mesh((n,), (axis,), device)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def all_gather(mesh: Mesh, t: torch.Tensor, axis: str | None = None) -> list:
    """Every rank's t along `axis` (None: the mesh's first axis), in
    coordinate order; under gloo through host copies.  Not differentiable."""
    group = mesh.groups.get(axis or mesh.axis_names[0])
    if group is None:
        return [t.detach()]
    src = t.detach().contiguous()
    if mesh.backend == "gloo":
        src = src.cpu()
    got = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(got, src, group=group)
    return [g.to(t.device) for g in got]


def all_reduce_sum(mesh: Mesh, *tensors) -> list:
    """The sums of each tensor over every rank of the mesh (under gloo
    through host copies)."""
    if mesh.size == 1:
        return list(tensors)
    out = []
    for t in tensors:
        src = t.detach().contiguous()
        if mesh.backend == "gloo":
            src = src.cpu()
        src = src.clone()
        dist.all_reduce(src)
        out.append(src.to(t.device))
    return out


class RankComm:
    """The collectives of the ranks along a mesh's first axis that share one
    wavefront (the hook of ``integrator.trace_path`` and ``whitted_queue``;
    one rank: identities).  ``gather(t, what)``: every rank's t joined
    along its last axis, in rank order; ``sum(t, what)``: the elementwise
    sum over the ranks.  With a `log` list, each exchange appends (what,
    the bytes of its result on this rank, ms), the device synchronised
    around it."""

    def __init__(self, mesh: Mesh, log: list | None = None):
        self.mesh, self.log = mesh, log

    def _timed(self, what, fn, t):
        if self.log is None:
            return fn(t)
        sync = t.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = fn(t)
        if sync:
            torch.cuda.synchronize(t.device)
        self.log.append((what, out.numel() * out.element_size(),
                         (time.perf_counter() - t0) * 1e3))
        return out

    def gather(self, t: torch.Tensor, what: str) -> torch.Tensor:
        return self._timed(what, lambda x: torch.cat(all_gather(self.mesh, x), dim=-1), t)

    def sum(self, t: torch.Tensor, what: str) -> torch.Tensor:
        return self._timed(what, lambda x: all_reduce_sum(self.mesh, x)[0], t)


def _lane_pixels(cfg, first: int, m: int, n: int, dev):
    """Pixel corner coordinates of lanes [first, first + m) of the padded
    scanline order (pad lanes past n: pixel (0, 0))."""
    lane = torch.arange(first, first + m, dtype=torch.int64, device=dev)
    real = lane < n
    px = torch.where(real, lane % cfg.width, 0).to(torch.float32)
    py = torch.where(real, lane // cfg.width, 0).to(torch.float32)
    return px, py


def render_sharded(scene, cfg, key, spp: int, mesh: Mesh, stats: dict | None = None):
    """Data-parallel render: pixels sharded over the mesh's first axis ->
    the full [H, W, 3] radiance image, on every rank, on the scene's
    device (the JAX package's ``render_sharded``).  A path frame that
    compacts or reorders its bounces and a whitted frame whose light
    samples depend on the queue slot exchange what the one global
    wavefront needs (``RankComm``); every other frame exchanges only the
    image.  With a
    `stats` dict: "exchanges", the (what, bytes, ms) of each exchange of
    the frame's wavefronts, and in whitted mode "queue_iterations", a
    sample's queue iterations."""
    from voxtracer_torch.render.camera import primary_rays
    from voxtracer_torch.render.integrator import find_nearest_world, trace_path, whitted_queue
    from voxtracer_torch.render.sky import sample_sky

    n_dev = mesh.shape[0]
    h, w = cfg.height, cfg.width
    n = h * w
    n_pad = pad_to_multiple(n, n_dev)
    m = n_pad // n_dev
    lanes = (mesh.coords[0] * m, n_pad)
    dev = scene.device
    comm = RankComm(mesh, None if stats is None else stats.setdefault("exchanges", []))
    # whitted draws light samples at a branch's queue slot unless every
    # light is summed and none is an area light
    by_slot = not cfg.deterministic_lights or scene.lights.n_area > 0
    px, py = _lane_pixels(cfg, lanes[0], m, n, dev)
    deterministic = cfg.mode in ("primary", "whitted")
    acc = torch.zeros((m, 3), dtype=torch.float32, device=dev)
    for i in range(spp):
        k = fold_in(key, i)
        pxj, pyj, lens = px, py, None
        if not deterministic:
            u = threefry_uniform(fold_in(k, 100), (m, 2), dev, lanes)
            pxj = px + u[:, 0] * cfg.aa_strength
            pyj = py + u[:, 1] * cfg.aa_strength
            if cfg.use_dof:
                lens = threefry_uniform(fold_in(k, 101), (m, 2), dev, lanes)
        o, d = primary_rays(scene.camera, w, h, pxj, pyj, lens)
        o = o.contiguous()
        if cfg.mode == "primary":
            rec = find_nearest_world(scene, o, d, torch.ones(m, dtype=torch.bool, device=dev))
            sky = sample_sky(scene.sky, d, cfg.activate_sky, cfg.sky_fallback)
            val = torch.where(rec["hit"][:, None], scene.materials.albedo[rec["mat"].long()], sky)
        elif cfg.mode == "whitted":
            shared = dict(lanes=lanes, comm=comm) if by_slot else {}
            val, iters, _ = whitted_queue(scene, cfg, o, d, cfg.max_bounces, exact=True,
                                          **shared)
            if stats is not None:
                stats.setdefault("queue_iterations", []).append(iters)
        else:
            val = trace_path(scene, cfg, o, d, k, lanes=lanes, comm=comm)
        acc = acc + val
    flat = torch.cat(all_gather(mesh, acc / spp))
    return flat[:n].reshape(h, w, 3)
