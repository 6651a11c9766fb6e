"""Procedural HDR sky dome (counterpart of voxtracer/io/hdr.py's
``procedural_sky``; the .hdr reader comes with the rest of ``io/``)."""

from __future__ import annotations

import numpy as np


def procedural_sky(width: int = 512, height: int = 256, sun_dir=(0.4, 0.6, 0.5),
                   sun_intensity: float = 40.0, seed: int = 0) -> np.ndarray:
    """Deterministic equirect HDR dome: horizon-to-zenith gradient + sun,
    float32 [height, width, 3]."""
    v = (np.arange(height, dtype=np.float32) + 0.5) / height  # 0 = up
    u = (np.arange(width, dtype=np.float32) + 0.5) / width
    theta = v * np.pi  # polar from +Y
    phi = u * 2.0 * np.pi - np.pi
    st = np.sin(theta)[:, None]
    dirs = np.stack(
        [
            np.broadcast_to(np.cos(phi)[None, :] * st, (height, width)),
            np.broadcast_to(np.cos(theta)[:, None], (height, width)),
            np.broadcast_to(np.sin(phi)[None, :] * st, (height, width)),
        ],
        axis=-1,
    )
    zenith = np.array([0.35, 0.55, 0.95], np.float32)
    horizon = np.array([0.85, 0.85, 0.95], np.float32)
    ground = np.array([0.25, 0.22, 0.20], np.float32)
    y = dirs[..., 1:2]
    sky = np.where(y >= 0, horizon + (zenith - horizon) * y, ground * (1.0 + 0.5 * y))
    sun = np.asarray(sun_dir, np.float32)
    sun = sun / np.linalg.norm(sun)
    cosang = (dirs * sun).sum(-1, keepdims=True)
    sky = sky + sun_intensity * np.maximum(cosang - 0.9995, 0.0) * 2000.0
    sky = sky + 0.6 * np.maximum(cosang, 0.0) ** 32
    return sky.astype(np.float32)
