"""ctypes binding to the native C++ scanner, ``native/sqscan.cpp``: the
host-side (CPU, OpenMP) renderer and BMP writer.

Counterpart of ``sqtpu/data/native.py``. The library and the ``sqscan``
CLI are built from the repo's ``native/sqscan.cpp`` with its Makefile's
flags (``-O3 -fopenmp -fPIC -Wall -std=c++17``; no ``-ffast-math``, whose
start-up code would set flush-to-zero for the whole process) into
``sqtpu_torch/build/`` (not tracked by git), under a name that carries the
hash of the source and the flags. Nothing is written under ``native/``,
and nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

from sqtpu_torch.ops import quaternion as quat

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(PKG_DIR), "native", "sqscan.cpp")
BUILD_DIR = os.path.join(PKG_DIR, "build")
CXX_FLAGS = ("-O3", "-fopenmp", "-fPIC", "-Wall", "-std=c++17")
BUILD_TIMEOUT_S = 300

_lib = None


def _built(kind: str) -> str:
    """Build the library (``kind="lib"``) or the CLI (``"cli"``) unless it
    exists for this source; returns its path. A toolchain without OpenMP
    (no ``libgomp.spec``, as on the H100 host) builds both without
    ``-fopenmp``: they render the same images on one core."""
    extra = ("-shared",) if kind == "lib" else ("-DSQSCAN_MAIN",)
    digest = hashlib.sha256(" ".join(CXX_FLAGS + extra).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    tag = digest.hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libsqscan_{tag}.so" if kind == "lib"
                       else f"sqscan_{tag}")
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"

    def run(flags):
        return subprocess.run([cxx, *flags, *extra, "-o", tmp, SOURCE],
                              capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)

    res = run(CXX_FLAGS)
    if res.returncode != 0 and "libgomp.spec" in res.stderr:
        res = run(tuple(f for f in CXX_FLAGS if f != "-fopenmp")
                  + ("-Wno-unknown-pragmas",))
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} failed for sqscan.cpp "
                           f"(exit {res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def library_path() -> str:
    return _built("lib")


def cli_path() -> str:
    """The ``sqscan`` CLI (the reference scanner's 18-argument contract)."""
    return _built("cli")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(library_path())
        lib.sq_render_depth.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.sq_render_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.sq_write_bmp.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int]
        lib.sq_write_bmp.restype = ctypes.c_int
        _lib = lib
    return _lib


def _to_world(params12: np.ndarray) -> np.ndarray:
    """Normalized 12-vectors [a, e, t, q] -> world-unit 17-vectors
    [a·255, e, t·255, R row-major], in float64."""
    p = np.asarray(params12, dtype=np.float64)
    q = p[..., 8:12]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    R = quat.to_matrix(torch.from_numpy(q)).numpy()
    return np.concatenate(
        [p[..., 0:3] * 255.0, p[..., 3:5], p[..., 5:8] * 255.0,
         R.reshape(p.shape[:-1] + (9,))], axis=-1)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def render_depth_native(params12: np.ndarray, size: int = 256,
                        n_sweep: int | None = None,
                        n_bisect: int = 30) -> np.ndarray:
    """One (size, size) uint8 depth map of a normalized 12-vector."""
    lib = _load()
    world = np.ascontiguousarray(_to_world(params12), dtype=np.float64)
    out = np.empty((size, size), dtype=np.uint8)
    lib.sq_render_depth(_ptr(world, ctypes.c_double),
                        _ptr(out, ctypes.c_uint8), size, n_sweep or size,
                        n_bisect)
    return out


def render_batch_native(params12: np.ndarray, size: int = 256,
                        n_sweep: int = 64, n_bisect: int = 20) -> np.ndarray:
    """(N, size, size) uint8 depth maps, rendered OpenMP-parallel."""
    lib = _load()
    world = np.ascontiguousarray(_to_world(params12), dtype=np.float64)
    out = np.empty((world.shape[0], size, size), dtype=np.uint8)
    lib.sq_render_batch(_ptr(world, ctypes.c_double),
                        _ptr(out, ctypes.c_uint8), world.shape[0], size,
                        n_sweep, n_bisect)
    return out


def write_bmp_native(path: str, img: np.ndarray) -> None:
    """Write (H, W) uint8 as the scanner's 24-bit BMP through the C++
    writer."""
    lib = _load()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape
    if lib.sq_write_bmp(path.encode(), _ptr(img, ctypes.c_uint8), w, h) != 0:
        raise OSError(f"sq_write_bmp failed for {path}")
