"""Rolling-cube player character (counterpart of voxtracer/game/player.py;
reference: src/Game/PlayerCharacter.{h,cpp}).

The player is voxel volume 0.  A move picks a cardinal direction, probes
``direction - up`` against the world (FindNearestPlayer skips volume 0 and
smoke, renderer.cpp:1020-1071) and on a hit puts the volume on the hit
face, oriented by a quaternion from the face normal.  Host-side numpy,
equal to the JAX package's; the probe ray runs through the integrator's
``find_nearest_world``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from voxtracer_torch.core.transforms import quat_axis_angle, quat_mul, quat_to_mat4

EPSILON = 1e-5

_DIRS = {
    "w": (0.0, np.array([EPSILON, EPSILON, -1.0], np.float32)),
    "d": (90.0, np.array([-1.0, EPSILON, EPSILON], np.float32)),
    "s": (180.0, np.array([EPSILON, EPSILON, 1.0], np.float32)),
    "a": (270.0, np.array([1.0, EPSILON, EPSILON], np.float32)),
}


def _model_offset(normal: np.ndarray) -> np.ndarray:
    """GetModelOffset (PlayerCharacter.cpp:95-116): spread the dominant
    axis value onto the other two axes, sign-flipped for negative faces."""
    index = -1
    for i in range(3):
        if int(normal[i]) != 0:
            index = i
    result = np.zeros(3, np.float32)
    for i in range(3):
        if i != index:
            result[i] = normal[index]
    if normal[index] < 0:
        result *= -1
    return result


@dataclass
class PlayerState:
    up: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], np.float32))
    direction: np.ndarray = field(default_factory=lambda: np.array([0, 0, -1], np.float32))
    origin: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    distance: float = 3.0
    angle: float = 0.0
    rotation: np.ndarray = field(default_factory=lambda: np.array([1.0, 0, 0, 0]))
    # checkpoint snapshot (SetPrevios, PlayerCharacter.cpp:119-126)
    prev_up: np.ndarray | None = None
    prev_origin: np.ndarray | None = None
    prev_position: np.ndarray | None = None
    prev_rotation: np.ndarray | None = None


class PlayerCharacter:
    """Pose controller for volume 0; returns updated VolumeSpec transforms."""

    def __init__(self):
        self.s = PlayerState()

    def probe_ray(self):
        """GetRay (PlayerCharacter.cpp:11-18): direction - up, length 3."""
        d = self.s.direction - self.s.up
        d = d / np.linalg.norm(d)
        return self.s.origin.copy(), d.astype(np.float32), self.s.distance

    def update_input(self, keydir: str | None) -> bool:
        """UpdateInput (PlayerCharacter.cpp:53-90): pick direction/facing."""
        if keydir not in _DIRS:
            return False
        self.s.angle, self.s.direction = _DIRS[keydir]
        self.s.direction = self.s.direction.copy()
        self._set_rotation()
        return True

    def _set_rotation(self):
        """SetRotation (PlayerCharacter.cpp:26-51)."""
        s = self.s
        world_up = np.array([0.0, 1.0, 0.0])
        axis = np.cross(world_up, s.up)
        dotp = float(np.clip(np.dot(world_up, s.up), -1.0, 1.0))
        angle_off = float(np.arccos(dotp))
        if s.up[1] < -0.90:
            axis = np.array([0.0, 0.0, -1.0])
            angle_off = np.pi
        if np.linalg.norm(axis) < 1e-8:
            axis = np.array([0.0, 0.0, 1.0])
        q_up = quat_axis_angle(axis, angle_off)
        rotated = _rotate_vec(q_up, s.direction)
        s.direction = (rotated / np.linalg.norm(rotated)).astype(np.float32)
        q_face = quat_axis_angle(s.up if np.linalg.norm(s.up) > 0 else world_up,
                                 np.deg2rad(s.angle))
        q = quat_mul(q_face, q_up)
        s.rotation = q / np.linalg.norm(q)

    def snapshot(self, volume_position):
        s = self.s
        s.prev_up = s.up.copy()
        s.prev_origin = s.origin.copy()
        s.prev_position = np.asarray(volume_position, np.float32).copy()
        s.prev_rotation = s.rotation.copy()

    def move(self, position, up):
        """MovePlayer (PlayerCharacter.cpp:128-158) -> (volume_position,
        rot_mat4) for the player VolumeSpec."""
        s = self.s
        s.up = np.asarray(up, np.float32)
        self._set_rotation()
        s.origin = np.asarray(position, np.float32) + s.up * 0.5
        not_upside = np.zeros(3, np.float32)
        if not (s.up[1] > 0.9 or s.up[0] > 0.9 or s.up[2] > 0.9):
            not_upside = s.up.copy()
        not_upside = not_upside - _model_offset(s.up) * 0.375
        vol_pos = np.asarray(position, np.float32) + not_upside
        return vol_pos, quat_to_mat4(s.rotation)

    def revert(self):
        """RevertMovePlayer (PlayerCharacter.cpp:161-171) -> (volume_position,
        rot_mat4) from the checkpoint snapshot."""
        s = self.s
        s.up = s.prev_up.copy()
        s.origin = s.prev_origin.copy()
        return s.prev_position.copy(), quat_to_mat4(s.prev_rotation)


def _rotate_vec(q, v):
    w, x, y, z = q
    u = np.array([x, y, z])
    return (2.0 * np.dot(u, v) * u
            + (w * w - np.dot(u, u)) * np.asarray(v)
            + 2.0 * w * np.cross(u, v))
