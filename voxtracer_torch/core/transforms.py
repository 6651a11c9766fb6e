"""Host-side 4x4 transform builders (NumPy; scene construction only).

Counterpart of voxtracer/core/transforms.py, kept arithmetic-for-arithmetic
equal so both packages build the same ``inv``/``fwd`` matrices.
Conventions follow the reference template math (row-major, translation in
the last column, column-vector application; template/tmpl8math.h:2592ff).
"""

from __future__ import annotations

import numpy as np


def translate(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m


def scale(s) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    s = np.broadcast_to(np.asarray(s, np.float32), (3,))
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def quat_axis_angle(axis, angle_rad: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    half = angle_rad * 0.5
    return np.array([np.cos(half), *(axis * np.sin(half))], dtype=np.float64)


def quat_mul(a, b) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def quat_to_mat4(q) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float32,
    )
    return m


def euler_to_mat4(rotation_xyz) -> np.ndarray:
    """X, then Y, then Z axis-angle quats composed as the reference does
    (scene.cpp:388-399: q = qZ * (qY * qX))."""
    rx, ry, rz = np.asarray(rotation_xyz, np.float64)
    q = quat_axis_angle([1, 0, 0], rx)
    q = quat_mul(quat_axis_angle([0, 1, 0], ry), q)
    q = quat_mul(quat_axis_angle([0, 0, 1], rz), q)
    return quat_to_mat4(q)


def volume_transforms(position, scl, rotation_xyz=(0.0, 0.0, 0.0), rot_mat4=None):
    """(fwd, inv) for one voxel volume, Scene::SetTransform
    (scene.cpp:373-405) with both of its load-bearing quirks: the pivot is
    ``center + position`` (world position doubled), and the inverse is
    built from the swapped rot/scale order."""
    position = np.asarray(position, np.float32)
    center = position + 0.5  # cube is [position, position+1] (scene.cpp:213-217)
    t_pivot = translate(center + position)
    t_back = translate(-center)
    s = scale(scl)
    r = euler_to_mat4(rotation_xyz) if rot_mat4 is None else np.asarray(rot_mat4, np.float32)
    fwd = t_pivot @ s @ r @ t_back
    inv = np.linalg.inv(t_pivot @ r @ s @ t_back).astype(np.float32)
    return fwd.astype(np.float32), inv
