"""Radiance .hdr (RGBE) reading and writing and the procedural HDR sky
dome (counterpart of voxtracer/io/hdr.py), in numpy.

The reference loads ``assets/sky_19.hdr`` through stb_image
(renderer.cpp:691), a file absent from its repository; the presets use
``procedural_sky`` instead, and nothing on the render path reads a .hdr
file.  ``load_hdr`` reads user-provided files (run-length encoded or
flat scanlines), ``save_hdr`` writes flat RGBE.
"""

from __future__ import annotations

import numpy as np


def load_hdr(path: str) -> np.ndarray:
    """Radiance RGBE file -> [H, W, 3] floats, (rgb + 0.5) * 2^(e - 136)
    and 0 where e is 0.  Only the standard "-Y h +X w" orientation is
    read."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance .hdr file")
    # the header ends at a blank line; the next line is the resolution
    end = data.index(b"\n\n")
    res_end = data.index(b"\n", end + 2)
    res = data[end + 2:res_end].split()
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported orientation {res}")
    h, w = int(res[1]), int(res[3])
    buf = data[res_end + 1:]
    img = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        # a new-style run-length encoded scanline: 2 2 and the width
        if 8 <= w < 32768 and buf[pos] == 2 and buf[pos + 1] == 2:
            pos += 4
            row = np.zeros((4, w), np.uint8)
            for ch in range(4):
                x = 0
                while x < w:
                    count = buf[pos]
                    pos += 1
                    if count > 128:  # a run of one value
                        row[ch, x:x + count - 128] = buf[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal values
                        row[ch, x:x + count] = np.frombuffer(buf, np.uint8, count, pos)
                        pos += count
                        x += count
            img[y] = row.T
        else:  # flat RGBE pixels
            img[y] = np.frombuffer(buf, np.uint8, w * 4, pos).reshape(w, 4)
            pos += w * 4
    rgbe = img.astype(np.float32)
    scale = np.ldexp(1.0, img[..., 3].astype(np.int32) - 136)  # 128 + 8 mantissa bits
    return (rgbe[..., :3] + 0.5) * scale[..., None] * (img[..., 3] != 0)[..., None]


def save_hdr(path: str, img: np.ndarray) -> None:
    """Write [H, W, 3] floats as flat (not run-length encoded) RGBE."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    maxc = img.max(axis=-1)
    valid = maxc > 1e-32
    exp = np.zeros((h, w), np.int32)
    mant = np.zeros((h, w), np.float32)
    m, e = np.frexp(np.where(valid, maxc, 1.0))
    exp[valid] = e[valid]
    mant[valid] = m[valid]
    scale = np.where(valid, mant * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(valid, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


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
