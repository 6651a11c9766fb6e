"""Frustum-corner pinhole camera (template/camera.h; counterpart of
voxtracer/render/camera.py).  Directions are returned normalized, as the
reference Ray constructor does (scene.cpp:85-97).  With lens samples
the rays take the thin-lens depth of field (GetPrimaryRay,
camera.h:68-101)."""

from __future__ import annotations

import numpy as np
import torch

from vtbench.reference.core.mathx import normalize
from vtbench.reference.core.sampling import point_in_circle
from vtbench.reference.core.types import Camera


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


def primary_rays(cam: Camera, width: int, height: int, px, py, lens_u=None):
    """Primary rays: pinhole (GetPrimaryRayNoDOF, camera.h:103-110) or,
    with lens samples, thin lens (GetPrimaryRay, camera.h:68-101): the
    origin moves on a disk of radius defocus_jitter / width in the camera
    plane and the ray aims at the pinhole ray's point at focal_distance.

    px, py: [N] float pixel coordinates, AA jitter included; lens_u: [N, 2]
    uniforms or None.  Returns (origins [N, 3], unit directions [N, 3])."""
    u = px * (1.0 / width)
    v = py * (1.0 / height)
    p = (cam.top_left
         + u[..., None] * (cam.top_right - cam.top_left)
         + v[..., None] * (cam.bottom_left - cam.top_left))
    if lens_u is None:
        return cam.pos.expand(p.shape), normalize(p - cam.pos)
    jitter = point_in_circle(lens_u) * cam.defocus_jitter / width
    focal = cam.pos + cam.focal_distance * normalize(p - cam.pos)
    origin = cam.pos + jitter[..., 0:1] * cam.right + jitter[..., 1:2] * cam.up
    return origin, normalize(focal - origin)


def auto_focus_distance(cam: Camera, width: int, height: int, trace_center_t) -> float:
    """Autofocus: the reference traces the centre pixel each Tick and sets
    focalDistance to min(hit t, 1e4) (renderer.cpp:1987-1991);
    `trace_center_t` comes from the renderer."""
    return float(min(trace_center_t, 1e4))


def primary_rays_np(cam: Camera, width: int, height: int, px, py):
    """``primary_rays`` in numpy on the host, written as the JAX package's
    ``primary_rays(..., lens_u=None, xp=np)`` so the two agree bit for
    bit: the host-side bin and compaction permutations are built on it.
    px, py: [N] float32 numpy arrays."""
    pos, tl, tr, bl = (getattr(cam, f).cpu().numpy()
                       for f in ("pos", "top_left", "top_right", "bottom_left"))
    u = px * (1.0 / width)
    v = py * (1.0 / height)
    p = tl + u[..., None] * (tr - tl) + v[..., None] * (bl - tl)
    origin = np.broadcast_to(pos, p.shape)
    direction = p - pos
    return origin, direction / np.sqrt((direction * direction).sum(axis=-1, keepdims=True))
