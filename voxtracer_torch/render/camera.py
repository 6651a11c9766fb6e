"""Frustum-corner pinhole camera (template/camera.h; counterpart of
voxtracer/render/camera.py).  Directions are returned normalized, as the
reference Ray constructor does (scene.cpp:85-97).  The thin-lens
depth-of-field sample is not ported yet."""

from __future__ import annotations

import numpy as np
import torch

from voxtracer_torch.core.mathx import normalize
from voxtracer_torch.core.types import Camera


def make_camera(
    pos=(0.0, 0.0, -2.0),
    target=(0.0, 0.0, -1.0),
    aspect: float = 256.0 / 212.0,
    focal_distance: float = 1.0,
    defocus_jitter: float = 0.0,
) -> Camera:
    """Basis and corners as HandleInput's final recompute (camera.h:163-178)."""
    pos = np.asarray(pos, np.float32)
    target = np.asarray(target, np.float32)
    ahead = target - pos
    ahead = ahead / np.linalg.norm(ahead)
    tmp_up = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(tmp_up, ahead)
    right = right / np.linalg.norm(right)
    up = np.cross(ahead, right)
    up = up / np.linalg.norm(up)
    right = np.cross(up, ahead)
    right = right / np.linalg.norm(right)
    top_left = pos + 2 * ahead - aspect * right + up
    top_right = pos + 2 * ahead + aspect * right + up
    bottom_left = pos + 2 * ahead - aspect * right - up

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    return Camera(pos=t(pos), top_left=t(top_left), top_right=t(top_right),
                  bottom_left=t(bottom_left), right=t(right), up=t(up),
                  ahead=t(ahead), focal_distance=t(focal_distance),
                  defocus_jitter=t(defocus_jitter))


def primary_rays(cam: Camera, width: int, height: int, px, py):
    """Pinhole primary rays (GetPrimaryRayNoDOF, camera.h:103-110).

    px, py: [N] float pixel coordinates, AA jitter included.
    Returns (origins [N, 3], unit directions [N, 3])."""
    u = px * (1.0 / width)
    v = py * (1.0 / height)
    p = (cam.top_left
         + u[..., None] * (cam.top_right - cam.top_left)
         + v[..., None] * (cam.bottom_left - cam.top_left))
    origin = cam.pos.expand(p.shape)
    return origin, normalize(p - cam.pos)
