"""Render configuration: the fields the forward path-traced frame reads
(counterpart of voxtracer/config.py)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RenderConfig:
    width: int = 256
    height: int = 212
    # "primary" (flat albedo at the first hit) or "path" (full stochastic
    # light transport, renderer.cpp:1076-1328)
    mode: str = "path"
    max_bounces: int = 14
    aa_strength: float = 1.0  # renderer.h:183 antiAliasingStrength
    activate_sky: bool = True
    sky_fallback: tuple = (0.392, 0.584, 0.829)  # renderer.cpp:2312
    # "tile": rays are generated in 8x128-pixel tiles so neighbouring
    # threads trace neighbouring pixels; "scanline": row-major.  Tile order
    # falls back to scanline when width % 128 != 0.
    ray_order: str = "tile"
