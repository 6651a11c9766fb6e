"""Build and load the CUDA kernels of ``voxtracer_torch/csrc``.

Each ``*.cu`` source compiles with its own nvcc, all started together,
and the objects link into one shared library with a plain C interface,
loaded with ctypes.  The library goes to
``<repo>/build/voxtracer_torch/`` under a name keyed by a hash of the
sources and flags, so an edit rebuilds; the first kernel call in a process
builds it.  ptxas' register and spill report is kept beside it as
``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "voxtracer_torch"
# no --use_fast_math: IEEE division and square root; --fmad=false: no
# multiply-add contraction (the kernels match their plain versions bit
# for bit in hit/vol/cell only under these rules)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvoxtracer_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    failed = [p.returncode for p in procs if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        failed = [link.returncode] if link.returncode != 0 else []
    for obj in objs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n" + "".join(logs))
    os.replace(tmp, out)
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "vt_traverse": [_I, _I] + [_P] * 10 + [_I] * 5 + [_P, _P],
    "vt_exit_march": [_P] * 10 + [_I] * 5 + [_P, _P],
    "vt_launch_floor": [_I, _P],
    "vt_lookup_init": [_I],
    "vt_lookup_rows": [_P, _I, _I, _P, ctypes.c_longlong, _P, _I, _P],
    "vt_lookup_rows_bwd": [_P, ctypes.c_longlong, _I, _P, _I, _P, _P, _I, _P],
    "vt_probe_short_chain": [_I, ctypes.c_longlong],
    "vt_lane_gather": [_P, _P, _I, _I, _P, _P],
    "vt_chain_gather": [_P, _P, _I, _I, _P, _P],
    "vt_alu_loop": [_P, _P, ctypes.c_longlong, _I, _P, _P],
    "vt_rng": [_I, _I, _P] + [ctypes.c_uint] * 3 + [ctypes.c_ulonglong] * 2 + [_P]
              + [ctypes.c_uint] * 4 + [_P],
    "vt_bounce": [_I, _P, _P],
}


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {status}")
