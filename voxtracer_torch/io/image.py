"""PNG writer and reader in pure Python + zlib (counterpart of
voxtracer/io/image.py)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, img) -> None:
    """img: uint8 [H, W, 3] or [H, W] grayscale (numpy or CPU tensor)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    h, w, _ = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        block = tag + data
        return struct.pack(">I", len(data)) + block + struct.pack(">I", zlib.crc32(block))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for the writer's output (8-bit RGB, filters 0
    and 2) -> uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, w = 8, 0
    idat = b""
    while pos < len(data):
        (ln,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, _, depth, ctype = struct.unpack_from(">IIBB", body)
            if (depth, ctype) != (8, 2):
                raise ValueError(f"{path}: only 8-bit RGB is read")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    rows = []
    prev = np.zeros(w * 3, np.uint8)
    for y in range(len(raw) // stride):
        ftype = raw[y * stride]
        row = np.frombuffer(raw, np.uint8, w * 3, y * stride + 1).copy()
        if ftype == 2:  # up
            row = (row.astype(np.int32) + prev).astype(np.uint8)
        elif ftype != 0:
            raise ValueError(f"{path}: unsupported PNG filter {ftype}")
        rows.append(row)
        prev = row
    return np.stack(rows).reshape(-1, w, 3)
