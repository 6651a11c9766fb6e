"""Tonemap + display conversion (renderer.cpp:2222-2240, RGBF32_to_RGB8
precomp.h:372-388; counterpart of voxtracer/render/tonemap.py)."""

from __future__ import annotations

import torch

from voxtracer_torch.core.mathx import reinhard_jodie


def tonemap(color):
    return reinhard_jodie(color)


def to_rgb8(color):
    c = torch.clamp(tonemap(color), 0.0, 1.0)
    return (c * 255.0 + 0.5).to(torch.uint8)
