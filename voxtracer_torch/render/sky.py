"""Equirect sky dome sampling (Renderer::SampleSky, renderer.cpp:2308-2326;
counterpart of voxtracer/render/sky.py), with the reference's fast
atan2/acos approximations and its flat-index clamp quirk: the reference
clamps only the low end; the JAX package adds the high-end clamp that
keeps the gather in bounds, and so does this port."""

from __future__ import annotations

import torch

from voxtracer_torch.core import mathx
from voxtracer_torch.core.types import Sky


def sample_sky(sky: Sky, d, active_sky: bool, fallback):
    """d: [N, 3] unit directions -> [N, 3] radiance."""
    if not active_sky:
        return torch.tensor(fallback, dtype=torch.float32,
                            device=d.device).expand(d.shape)
    h, w = sky.pixels.shape[:2]
    u = (w * mathx.atan2_fast(d[..., 2], d[..., 0]) * mathx.INV_2PI
         - 0.5).to(torch.int32)
    v = (h * mathx.acos_fast(d[..., 1]) * mathx.INV_PI - 0.5).to(torch.int32)
    idx = torch.clamp(u + v * w, 0, h * w - 1)
    return sky.contribution * sky.pixels.reshape(-1, 3)[idx.long()]
