"""Gradient steps of the relaxed march on one device (counterpart of
voxtracer/dist/train.py without the mesh, and of the fused train step that
bench.py times).

* ``make_train_step`` / ``train_demo``: Adam (optax's defaults: b1 0.9,
  b2 0.999, eps 1e-8) on the image MSE of ``render_diff``.
* ``prepare_bins``: the loop-invariant precompute of a binned gradient:
  for each row band, the active rays split by span length
  (``span_cells_bins``), compacted with their sky, target rows and
  occupied spans.
* ``binned_grads``: the sum of the per-bin gradients of
  ``mse_loss_active``, which equals the gradient of the full image MSE.
* ``fused_step``: one path-traced forward frame plus ``binned_grads``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from voxtracer_torch.config import RenderConfig
from voxtracer_torch.core.types import Scene
from voxtracer_torch.diff.volumetric import (DiffParams, max_aabb_crossings,
                                             mse_loss, mse_loss_active,
                                             params_from_scene, span_cells_bins,
                                             spans_for_rays, trainable)
from voxtracer_torch.render.camera import primary_rays
from voxtracer_torch.render.integrator import render_tiled
from voxtracer_torch.render.sky import sample_sky
from voxtracer_torch.utils.profiling import span

F32 = torch.float32


@dataclass
class Bin:
    """One span-length bin of one row band, compacted."""

    steps: int        # core march steps
    clamp: bool       # run the transmittance-clamp traversal
    n_active: int     # rays of the bin; rows past it are padding
    o: torch.Tensor   # [N, 3] rays, N = n_active padded to a multiple of 1024
    d: torch.Tensor
    bg: torch.Tensor  # [N, 3] sky along d
    target: torch.Tensor  # [N, 3] target rows
    spans: tuple      # occupied-brick spans ([V, N], [V, N])


@dataclass
class BinPlan:
    bins: list
    denom: float      # element count of one band: the MSE's denominator
    k: int            # pair compaction
    span_steps: int
    importance: int = 0  # importance probes on the bins that clamp (the long spans)


def prepare_bins(scene: Scene, cfg: RenderConfig, target, bin_steps=(2, 10),
                 edges=(4.0,), tiles: int = 2, span_steps: int = 1, k=None,
                 importance: int = 0) -> BinPlan:
    """The precompute of ``binned_grads`` for target [H, W, 3]: `tiles`
    row bands, each split into span bins by ``edges``; bin b marches
    bin_steps[b] core steps and skips the clamp when b == 0 (its spans are
    a few cells).  k defaults to the exact pair compaction.  importance:
    the importance probes of the bins b > 0, as scripts/bench_bwd_imp.py
    applies them (0: uniform nodes)."""
    dev = scene.device
    w, h = cfg.width, cfg.height
    rows = -(-h // tiles)
    if k is None:
        k = min(max_aabb_crossings(scene, cfg), scene.volumes.n)
    target = torch.as_tensor(target, dtype=F32).to(dev)
    bins = []
    for band in range(tiles):
        r0 = min(band * rows, h - rows)
        x = torch.arange(w, dtype=F32, device=dev)
        y = torch.arange(rows, dtype=F32, device=dev) + float(r0)
        py, px = torch.meshgrid(y, x, indexing="ij")
        o, d = primary_rays(scene.camera, w, h, px.reshape(-1), py.reshape(-1))
        t_flat = target[r0:r0 + rows].reshape(-1, 3)
        for bi, perm, _, na in span_cells_bins(scene, cfg, row0=r0, rows=rows, edges=edges):
            nap = min(-(-na // 1024) * 1024, o.shape[0])
            sel = torch.from_numpy(perm[:nap]).to(dev).long()
            oc, dc = o[sel].contiguous(), d[sel].contiguous()
            bins.append(Bin(steps=bin_steps[bi], clamp=bi > 0, n_active=na, o=oc, d=dc,
                            bg=sample_sky(scene.sky, dc, cfg.activate_sky, cfg.sky_fallback),
                            target=t_flat[sel], spans=spans_for_rays(scene, oc, dc)))
    return BinPlan(bins=bins, denom=float(rows * w * 3), k=k, span_steps=span_steps,
                   importance=importance)


def binned_grads(params: DiffParams, scene: Scene, plan: BinPlan):
    """(loss, DiffParams of gradients): the sums over the plan's bins of
    ``mse_loss_active`` and its gradient, one bin's graph at a time."""
    with span("vt.train.grad"):
        leaves = trainable(params)
        total = torch.zeros((), dtype=F32, device=scene.device)
        for b in plan.bins:
            with span("vt.grad.march"):
                loss = mse_loss_active(leaves, scene, b.o, b.d, b.bg, b.target, plan.denom,
                                       b.steps, k=plan.k, span_steps=plan.span_steps,
                                       clamp=b.clamp, n_active=b.n_active, spans=b.spans,
                                       importance=plan.importance if b.clamp else 0)
            with span("vt.grad.backward"):
                loss.backward()
            total = total + loss.detach()
        return total, DiffParams(density_logits=leaves.density_logits.grad,
                                 albedo_table=leaves.albedo_table.grad)


def fused_step(params: DiffParams, scene: Scene, cfg: RenderConfig, key, plan: BinPlan,
               tiles: int = 1):
    """One path-traced forward frame (1 spp) and the binned gradient:
    returns (the frame's mean radiance, DiffParams of gradients)."""
    with torch.no_grad(), span("vt.train.fwd"):
        img_mean = render_tiled(scene, cfg, key, 1, tiles).mean()
    _, grads = binned_grads(params, scene, plan)
    return img_mean, grads


def make_train_step(cfg: RenderConfig, n_steps: int = 64, lr: float = 1e-2, grad_fn=None,
                    **march):
    """Returns (step, init).  ``init(params)`` makes the params' tensors
    trainable leaves and returns the optimizer; ``step(params, opt, scene,
    target)`` -> (params, opt, loss) updates params in place by one Adam
    step on the gradient of grad_fn(params, scene, target) -> (loss,
    DiffParams of gradients), by default the backward of the MSE of
    render_diff(params, scene, cfg, n_steps, **march); the leaves' .grad
    keep the step's gradient."""

    def init(params: DiffParams):
        leaves = [params.density_logits.requires_grad_(), params.albedo_table.requires_grad_()]
        return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def step(params: DiffParams, opt, scene: Scene, target):
        opt.zero_grad(set_to_none=True)
        if grad_fn is None:
            loss = mse_loss(params, scene, cfg, target, n_steps, **march)
            loss.backward()
        else:
            loss, grads = grad_fn(params, scene, target)
            params.density_logits.grad = grads.density_logits
            params.albedo_table.grad = grads.albedo_table
        with span("vt.train.adam"):
            opt.step()
        return params, opt, loss.detach()

    return step, init


def train_demo(scene: Scene, cfg: RenderConfig, target, iters: int = 1, n_steps: int = 64,
               lr: float = 1e-2, params: DiffParams | None = None, grad_fn=None, **march):
    """`iters` steps (``make_train_step``) from `params`, by default
    params_from_scene -> (params, last loss)."""
    if params is None:
        params = params_from_scene(scene)
    target = torch.as_tensor(target, dtype=F32).to(scene.device)
    step, init = make_train_step(cfg, n_steps, lr, grad_fn, **march)
    opt = init(params)
    loss = None
    for _ in range(iters):
        params, opt, loss = step(params, opt, scene, target)
    return params, float(loss)
