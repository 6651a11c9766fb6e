"""Fly-camera input handling (counterpart of voxtracer/render/flycam.py;
reference: template/camera.h:113-181).

The reference's ``Camera::HandleInput`` runs on the host every frame: keys
move ``camPos``/``camTarget``, the basis is rebuilt, and the frustum
corners are recomputed; any change resets the accumulator.  That is
host-side scalar work, so this module is float32 numpy, operation for
operation as the JAX package's, so both give the same poses bit for bit;
the device only sees the finished ``Camera`` (corners and basis).

Key map (terminal-friendly):
  w/s       move along ahead / back          (camera.h:168-169)
  a/d       strafe left / right              (camera.h:166-167)
  q/e       move up / down along `up`        (camera.h:170-171)
  arrows    pitch (up/down, clamped at |ahead.y| <= stopAngle = 0.9,
            camera.h:126-159) and yaw (left/right, camera.h:161-162)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from voxtracer_torch.core.types import Camera

STOP_ANGLE = 0.9  # camera.h:188
BASE_SPEED = 0.0075  # per ms of frame time (camera.h:116)


def _norm(v):
    return v / np.linalg.norm(v)


@dataclasses.dataclass
class FlyState:
    """Host-side mutable camera pose: position + look target."""

    pos: np.ndarray
    target: np.ndarray

    @classmethod
    def from_camera(cls, cam: Camera) -> "FlyState":
        pos = np.asarray(cam.pos.cpu().numpy(), np.float32).copy()
        ahead = np.asarray(cam.ahead.cpu().numpy(), np.float32)
        return cls(pos=pos, target=pos + ahead)


def handle_input(state: FlyState, keys: set, dt_ms: float,
                 slow: bool = False) -> bool:
    """Apply one frame of key input in place; returns True if the camera
    changed (the caller must reset the accumulator, renderer.cpp:343)."""
    speed = BASE_SPEED * dt_ms * (0.5 if slow else 1.0)
    tmp_up = np.array([0.0, 1.0, 0.0], np.float32)

    ahead = _norm(state.target - state.pos)
    right = _norm(np.cross(tmp_up, ahead))
    up = _norm(np.cross(ahead, right))
    changed = False

    if "up" in keys:
        if ahead[1] < STOP_ANGLE:
            state.target = state.target + speed * up
            changed = True
    if "down" in keys:
        if ahead[1] > -STOP_ANGLE:
            state.target = state.target - speed * up
            changed = True
    if "left" in keys:
        state.target = state.target - speed * right
        changed = True
    if "right" in keys:
        state.target = state.target + speed * right
        changed = True

    ahead = _norm(state.target - state.pos)
    right = _norm(np.cross(tmp_up, ahead))
    up = _norm(np.cross(ahead, right))
    if "a" in keys:
        state.pos = state.pos - speed * right
        changed = True
    if "d" in keys:
        state.pos = state.pos + speed * right
        changed = True
    if "w" in keys:
        state.pos = state.pos + speed * ahead
        changed = True
    if "s" in keys:
        state.pos = state.pos - speed * ahead
        changed = True
    if "q" in keys:
        state.pos = state.pos + speed * up
        changed = True
    if "e" in keys:
        state.pos = state.pos - speed * up
        changed = True

    state.target = state.pos + ahead
    return changed


def to_camera(state: FlyState, aspect: float, prev: Camera) -> Camera:
    """Rebuild the frustum-corner Camera from the fly pose (final
    recompute, camera.h:172-178) on the device of `prev`; the DOF scalars
    carry over."""
    tmp_up = np.array([0.0, 1.0, 0.0], np.float32)
    ahead = _norm(state.target - state.pos)
    right = _norm(np.cross(tmp_up, ahead))
    up = _norm(np.cross(ahead, right))
    right = _norm(np.cross(up, ahead))
    pos = state.pos.astype(np.float32)
    dev = prev.pos.device

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return Camera(
        pos=t(pos),
        top_left=t(pos + 2 * ahead - aspect * right + up),
        top_right=t(pos + 2 * ahead + aspect * right + up),
        bottom_left=t(pos + 2 * ahead - aspect * right - up),
        right=t(right),
        up=t(up),
        ahead=t(ahead),
        focal_distance=prev.focal_distance,
        defocus_jitter=prev.defocus_jitter,
    )
