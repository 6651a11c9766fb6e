"""MagicaVoxel ``.vox`` parser in numpy (counterpart of voxtracer/io/vox.py;
reference: scene.cpp:449-683 + lib/ogt_vox.h).

A file becomes a dense color-index grid and a 256-entry RGBA palette, both
numpy, equal bit for bit to the JAX package's parser on the same bytes.
Only SIZE/XYZI (models), RGBA (palette) and IMAP (display-order remap) are
read; scene-graph chunks (nTRN/nGRP/nSHP/LAYR/MATL/rCAM/rOBJ/NOTE) are
skipped, as the reference only reads ``models[0]`` and the palette
(scene.cpp:474-475).  The ogt_vox quirks are kept: the IMAP remap
``v -> (1 + inverse_imap[v]) & 0xFF`` with the palette reordered as
``palette[(imap[i] + 255) & 0xFF]`` (ogt_vox.h:2004-2037), then the
palette rolled by one so ``palette[color_index]`` is a direct lookup, with
slot 0 transparent (ogt_vox.h:2040-2047).

``load_vox`` reads a file with the C++ parser of native/voxio.cpp when
that library builds (``voxtracer_torch.native``), else with
``parse_vox``; ``load_vox_with_parser`` also says which of the two ran.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class VoxModel:
    """One parsed model: grid uint8 [size_x, size_y, size_z] (0 = empty,
    else a palette/material index; MagicaVoxel's z is up, remapped to the
    renderer's y-up at scene build) and palette float32 [256, 4] RGBA in
    [0, 1] (palette[0] transparent)."""

    grid: np.ndarray
    palette: np.ndarray

    @property
    def size(self) -> tuple[int, int, int]:
        return tuple(self.grid.shape)  # type: ignore[return-value]


def _iter_chunks(data: bytes, offset: int, end: int):
    """Yield (chunk_id, content, children offset, children size) for a flat
    run of sibling chunks."""
    while offset + 12 <= end:
        cid = data[offset:offset + 4]
        content_size, children_size = struct.unpack_from("<ii", data, offset + 4)
        content_start = offset + 12
        yield (cid, data[content_start:content_start + content_size],
               content_start + content_size, children_size)
        offset = content_start + content_size + children_size


def parse_vox(data: bytes) -> list[VoxModel]:
    """Parse .vox bytes into a list of models (all sharing one palette)."""
    if data[:4] != b"VOX ":
        raise ValueError("not a MagicaVoxel file (missing 'VOX ' magic)")

    sizes: list[tuple[int, int, int]] = []
    voxels: list[np.ndarray] = []
    palette_raw: np.ndarray | None = None
    imap: np.ndarray | None = None

    def walk(offset: int, end: int) -> None:
        nonlocal palette_raw, imap
        for cid, content, child_off, child_size in _iter_chunks(data, offset, end):
            if cid == b"MAIN":
                walk(child_off, child_off + child_size)
            elif cid == b"SIZE":
                sizes.append(struct.unpack("<iii", content[:12]))
            elif cid == b"XYZI":
                (n,) = struct.unpack_from("<i", content, 0)
                voxels.append(
                    np.frombuffer(content, dtype=np.uint8, count=4 * n, offset=4).reshape(n, 4))
            elif cid == b"RGBA":
                palette_raw = np.frombuffer(content, dtype=np.uint8,
                                            count=256 * 4).reshape(256, 4)
            elif cid == b"IMAP":
                imap = np.frombuffer(content, dtype=np.uint8, count=256)
            # every other chunk is metadata the renderer never reads

    walk(8, len(data))

    if palette_raw is None:
        # a file without an RGBA chunk: a grey ramp (ogt_vox ships the
        # editor's default palette instead, which is not replicated)
        ramp = np.linspace(0, 255, 256, dtype=np.uint8)
        palette_raw = np.stack([ramp, ramp, ramp, np.full(256, 255, np.uint8)], axis=1)
    palette = palette_raw.astype(np.uint8).copy()

    remap: np.ndarray | None = None
    if imap is not None:
        # ogt_vox.h:2004-2037: indices rewritten to display order
        inverse = np.zeros(256, dtype=np.uint8)
        inverse[imap] = np.arange(256, dtype=np.uint8)
        remap = ((1 + inverse.astype(np.int32)) & 0xFF).astype(np.uint8)
        palette = palette[(imap.astype(np.int32) + 255) & 0xFF]

    # ogt_vox.h:2040-2047: rolled so voxel indices index directly
    palette = np.roll(palette, 1, axis=0)
    palette[0, 3] = 0
    palette_f = palette.astype(np.float32) / 255.0

    models: list[VoxModel] = []
    for (sx, sy, sz), xyzi in zip(sizes, voxels):
        grid = np.zeros((sx, sy, sz), dtype=np.uint8)
        if xyzi.size:
            x, y, z, ci = xyzi[:, 0], xyzi[:, 1], xyzi[:, 2], xyzi[:, 3]
            keep = (x < sx) & (y < sy) & (z < sz)  # out-of-range voxels dropped
            grid[x[keep], y[keep], z[keep]] = ci[keep]
        if remap is not None:
            grid = remap[grid]
        models.append(VoxModel(grid=grid, palette=palette_f))
    return models


def load_vox_with_parser(path: str, prefer_native: bool = True) -> tuple[VoxModel, str]:
    """The first model of a .vox file (the reference reads models[0] only)
    and the parser that read it: "native" (native/voxio.cpp, bit-identical
    to ``parse_vox``) when prefer_native and the library builds and takes
    the file, else "numpy"."""
    with open(path, "rb") as f:
        data = f.read()
    if prefer_native:
        from voxtracer_torch import native

        out = native.parse_vox_native(data)
        if out is not None:
            return VoxModel(grid=out[0], palette=out[1]), "native"
    return parse_vox(data)[0], "numpy"


def load_vox(path: str, prefer_native: bool = True) -> VoxModel:
    """The first model of a .vox file (``load_vox_with_parser``'s model)."""
    return load_vox_with_parser(path, prefer_native)[0]
