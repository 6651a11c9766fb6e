"""ctypes binding of the native IO runtime, native/voxio.cpp (counterpart
of voxtracer/native/__init__.py): the .vox parser, the uniform-brick
builder and the PNG writer, all host code.

The library is built from native/voxio.cpp by g++ (flags as
native/build.sh) into ``<repo>/build/voxtracer_torch/`` under a name keyed
by a hash of the source and the flags, on first use in a process.  Each
build writes a file of its own (the process id in its name) and renames
it into place, so processes that build at once do not race.  Where g++ or
zlib is missing the build fails and every function here returns None (or
False): each caller has a numpy version, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
SOURCE = REPO / "native" / "voxio.cpp"
BUILD_DIR = REPO / "build" / "voxtracer_torch"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_libs: dict = {}  # library path -> CDLL, or None where the build failed


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvoxio_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile native/voxio.cpp unless the library for this source exists;
    raises on a failed build."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lz"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load():
    """The loaded library, built on first use; None where it cannot be."""
    path = library_path()
    if path in _libs:
        return _libs[path]
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.SubprocessError):
        lib = None  # no g++, no zlib, or a failed compile: the numpy versions run
    if lib is not None:
        lib.vox_dims.restype = ctypes.c_int
        lib.vox_dims.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                 ctypes.POINTER(ctypes.c_int32)]
        lib.vox_fill.restype = ctypes.c_int
        lib.vox_fill.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                 ctypes.c_void_p]
        lib.vox_build_bricks.restype = None
        lib.vox_build_bricks.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
                                         ctypes.c_int32, ctypes.c_uint8]
        lib.png_write.restype = ctypes.c_int
        lib.png_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32,
                                  ctypes.c_int32]
    _libs[path] = lib
    return lib


def available() -> bool:
    return _load() is not None


def parse_vox_native(data: bytes):
    """(grid uint8 [sx, sy, sz], palette float32 [256, 4]) of the first
    model, or None where the library is missing or refuses the bytes."""
    lib = _load()
    if lib is None:
        return None
    dims = (ctypes.c_int32 * 3)()
    if lib.vox_dims(data, len(data), dims) != 0:
        return None
    grid = np.zeros((dims[0], dims[1], dims[2]), np.uint8)
    palette = np.zeros((256, 4), np.float32)
    if lib.vox_fill(data, len(data), grid.ctypes.data_as(ctypes.c_void_p),
                    palette.ctypes.data_as(ctypes.c_void_p)) != 0:
        return None
    return grid, palette


def build_bricks_native(grid: np.ndarray, gridsize: int):
    """The uniform-brick macro grid [m, m, m] int32 of grid[:g, :g, :g]
    (scene/instances.build_bricks), or None without the library."""
    lib = _load()
    if lib is None:
        return None
    g = np.ascontiguousarray(grid[:gridsize, :gridsize, :gridsize], np.uint8)
    m = max(1, -(-gridsize // 8))
    out = np.zeros((m, m, m), np.int32)
    lib.vox_build_bricks(g.ctypes.data_as(ctypes.c_void_p), gridsize,
                         out.ctypes.data_as(ctypes.c_void_p), m, 255)
    return out


def write_png_native(path: str, rgb: np.ndarray) -> bool:
    """Write uint8 [H, W, 3] as PNG; False without the library."""
    lib = _load()
    if lib is None:
        return False
    img = np.ascontiguousarray(rgb, np.uint8)
    h, w = img.shape[:2]
    return lib.png_write(str(path).encode(), img.ctypes.data_as(ctypes.c_void_p), w, h) == 0
