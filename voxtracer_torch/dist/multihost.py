"""Process groups and cross-process rendering over torch.distributed
(counterpart of voxtracer/dist/multihost.py; the reference has no
distributed backend, its only parallelism is OS threads).

Each process is one rank and drives one device: ``cuda:(rank % cards)``,
or the CPU when the caller asks for it.  The backend follows one rule
(``backend_for``): NCCL when every rank has a card of its own, gloo when
ranks share a card (NCCL refuses two ranks on one device) or run on the
CPU.  Under gloo every rank still renders on its card through the
kernels; only the collectives go through host copies (gloo's CUDA
support covers broadcast and all_reduce alone), as JAX's
``process_allgather`` gathers on the host.

``host_tile_bounds`` gives each process a contiguous row band and
``gather_image`` assembles the bands **at each band's own row0**: the
JAX package concatenates them and cuts at the height, which loses rows
whenever the last band had to be moved up (height 10 over 3 processes:
bands [0,4), [4,8), [6,10); rows 8-9 lost).  ``spawn`` runs a function
on n fresh ranks of this host and returns what each rank returned.
"""

from __future__ import annotations

import os
import queue
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


def backend_for(world: int, device="cuda") -> str:
    """"nccl" when every one of `world` ranks has a card of its own,
    "gloo" otherwise (ranks sharing a card, CPU ranks)."""
    if torch.device(device).type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: int, device="cuda") -> torch.device:
    """The device rank `rank` drives: a card in turn, or the CPU."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init(coordinator: str | None = None, num_processes: int | None = None,
         process_id: int | None = None, device="cuda") -> dict:
    """Join the process group when running several processes; a no-op
    for a single one.  Reads torchrun's MASTER_ADDR / MASTER_PORT,
    WORLD_SIZE and RANK when the arguments are omitted.  coordinator:
    "host:port" (TCP) or an init-method URL ("file:///path": a FileStore,
    no port).  Prints the backend and the rule that chose it."""
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    num_processes = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    process_id = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    if num_processes > 1 and not dist.is_initialized():
        if coordinator is None:
            raise ValueError("several processes need a coordinator address")
        backend = backend_for(num_processes, device)
        dev = rank_device(process_id, device)
        if process_id == 0:
            cards = torch.cuda.device_count() if dev.type == "cuda" else 0
            print(f"torch.distributed: {num_processes} ranks on {cards or 'no'} card(s), "
                  f"{dev.type}: backend {backend} (NCCL when every rank has a card of its "
                  "own, else gloo with host-side collectives)", file=sys.stderr, flush=True)
        if backend == "nccl":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, world_size=num_processes, rank=process_id,
                                init_method=(coordinator if "://" in coordinator
                                             else f"tcp://{coordinator}"))
    count = dist.get_world_size() if dist.is_initialized() else 1
    return dict(process_index=dist.get_rank() if dist.is_initialized() else 0,
                process_count=count, local_devices=1, global_devices=count)


def global_mesh(axis: str = "rays", device="cuda"):
    """1-D mesh over every rank of every host."""
    from voxtracer_torch.dist.mesh import make_mesh

    return make_mesh(None, axis, device)


def _process():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_tile_bounds(height: int) -> tuple[int, int]:
    """Contiguous scanline band owned by this process: [row0, row1).  The
    bands are the JAX package's: ceil(height / processes) rows each, the
    last one moved up to end at the image's bottom."""
    pi, pc = _process()
    return tile_bounds(height, pi, pc)


def tile_bounds(height: int, index: int, count: int) -> tuple[int, int]:
    """Band [row0, row1) of process `index` of `count`."""
    rows = -(-height // count)
    row0 = min(index * rows, max(height - rows, 0))
    return row0, min(row0 + rows, height)


def assemble_bands(bands, height: int) -> np.ndarray:
    """The image from every process's band, each placed at its own row0
    (``tile_bounds``); rows that two bands share are equal in both."""
    bands = [np.asarray(b) for b in bands]
    out = np.empty((height,) + bands[0].shape[1:], bands[0].dtype)
    for i, b in enumerate(bands):
        row0, row1 = tile_bounds(height, i, len(bands))
        out[row0:row1] = b[:row1 - row0]
    return out


def gather_image(local_band, height: int) -> np.ndarray:
    """The full image on every process from the per-process bands (host
    copies, all_gather); a single process returns its band."""
    band = torch.as_tensor(local_band).detach().cpu()
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return band.numpy()
    got = [torch.empty_like(band) for _ in range(dist.get_world_size())]
    dist.all_gather(got, band.contiguous())
    return assemble_bands([g.numpy() for g in got], height)


# ------------------------------------------------------------------ spawning

def _rank_main(rank, world, method, device, fn, args, results):
    try:
        init(method, world, rank, device=device)
        results.put((rank, True, fn(*args)))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, args=(), device="cuda", timeout: float = 900.0) -> list:
    """Run fn(*args) on `world` fresh processes joined in one process
    group (a FileStore in a temporary directory: no port) -> what each
    rank returned, by rank.  fn must be importable by name (spawned
    processes start from a fresh import) and its result picklable.  A
    rank that raises, dies or runs past `timeout` seconds ends every rank
    and fails the run."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, method, device, fn, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + timeout
        try:
            while len(out) < world:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:  # check that the ranks are alive
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world} ranks: no result after {timeout} s")
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        raise RuntimeError(f"rank(s) {dead} died: exit codes "
                                           f"{[procs[r].exitcode for r in dead]}")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
                if p.exitcode != 0:
                    raise RuntimeError(f"a rank exited with {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world)]
