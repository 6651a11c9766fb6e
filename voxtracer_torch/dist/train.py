"""Sharded differentiable-rendering train step over torch.distributed
(counterpart of voxtracer/dist/train.py).

Layout, as the JAX package's:
  * 'data' axis: the image's rows shard over the data coordinate;
  * 'model' axis: the density grids shard spatially (x slabs) over the
    model coordinate, the tensor-parallel analogue for worlds larger than
    one device; the albedo table is small and replicated.

A step all-gathers the density slabs of the rank's model group (outside
autograd), renders its rows with ``render_diff(row0=, rows=)``, takes
the gradient of its rows' squared-error sum over H*W*3 on the full
tensors, sums it over every rank (all_reduce) and keeps its own slab;
then ``diff/train.py``'s Adam step.  A data band is split again over the
band's model ranks, so no row is rendered twice and the sum over the
ranks is exactly the gradient of the image MSE.  Needs only all_gather
and all_reduce.
"""

from __future__ import annotations

import torch

from voxtracer_torch.diff import train
from voxtracer_torch.diff.volumetric import DiffParams, params_from_scene, render_diff
from voxtracer_torch.dist.mesh import Mesh, all_gather, all_reduce_sum, build_mesh


def make_mesh_2d(n_devices: int | None = None, device="cuda") -> Mesh:
    """('data', 'model') mesh over the process group's ranks: model 2 when
    the count is even and above 1."""
    import torch.distributed as dist

    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    model = 2 if n % 2 == 0 and n > 1 else 1
    return build_mesh((n // model, model), ("data", "model"), device)


def _slab(mesh: Mesh, g: int):
    """This rank's x range [lo, hi) of a density axis of size g."""
    model = mesh.shape[1]
    if g % model:
        raise ValueError(f"density size {g} does not split over {model} model ranks")
    s = g // model
    return mesh.coords[1] * s, (mesh.coords[1] + 1) * s


def shard_params(params: DiffParams, mesh: Mesh) -> DiffParams:
    """This rank's parameters: the x slab [V, G / model, G, G] of the
    density logits at its model coordinate, and the whole albedo table."""
    lo, hi = _slab(mesh, params.density_logits.shape[1])
    return DiffParams(density_logits=params.density_logits[:, lo:hi].clone(),
                      albedo_table=params.albedo_table.clone())


def _rows(mesh: Mesh, height: int) -> tuple:
    """This rank's rows [row0, row1): the band of its data coordinate,
    split again over the band's model ranks (row-major rank order)."""
    r, n = mesh.index, mesh.size
    return r * height // n, (r + 1) * height // n


def value_and_grad(params: DiffParams, scene, cfg, target, mesh: Mesh, n_steps: int = 64):
    """The image MSE of render_diff and its gradient -> (loss, DiffParams of
    this rank's gradients: its density slab's and the albedo table's)."""
    dens = torch.cat(all_gather(mesh, params.density_logits, "model"), dim=1).requires_grad_()
    alb = params.albedo_table.detach().requires_grad_()
    row0, row1 = _rows(mesh, cfg.height)
    if row1 > row0:
        img = render_diff(DiffParams(density_logits=dens, albedo_table=alb), scene, cfg, n_steps,
                          row0=row0, rows=row1 - row0)
        loss = ((img - target[row0:row1]) ** 2).sum() / float(cfg.height * cfg.width * 3)
        gd, ga = torch.autograd.grad(loss, [dens, alb])
    else:
        loss, gd, ga = dens.new_zeros(()), torch.zeros_like(dens), torch.zeros_like(alb)
    loss, gd, ga = all_reduce_sum(mesh, loss.detach(), gd, ga)
    lo, hi = _slab(mesh, gd.shape[1])
    return loss, DiffParams(density_logits=gd[:, lo:hi], albedo_table=ga)


def make_train_step(cfg, mesh: Mesh, n_steps: int = 64, lr: float = 1e-2):
    """Returns (step, init): ``diff.train.make_train_step`` on this rank's
    sharded params, its gradient ``value_and_grad`` over the mesh."""
    return train.make_train_step(cfg, n_steps, lr, _grad_fn(cfg, mesh, n_steps))


def _grad_fn(cfg, mesh: Mesh, n_steps: int):
    return lambda params, scene, target: value_and_grad(params, scene, cfg, target, mesh,
                                                        n_steps)


def train_demo(scene, cfg, target, mesh: Mesh, iters: int = 1, n_steps: int = 64,
               lr: float = 1e-2):
    """`iters` sharded steps from params_from_scene (``diff.train.train_demo``
    on this rank's shard) -> (this rank's params, the last step's loss)."""
    return train.train_demo(scene, cfg, target, iters, n_steps, lr,
                            params=shard_params(params_from_scene(scene), mesh),
                            grad_fn=_grad_fn(cfg, mesh, n_steps))
