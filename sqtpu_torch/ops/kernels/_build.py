"""Build a CUDA source of this package into a shared library with ``nvcc``
and load it with ``ctypes``.

Each source under ``sqtpu_torch/csrc/`` exposes a plain ``extern "C"``
interface, so no PyTorch header is compiled and a build takes seconds.
The library lands in ``sqtpu_torch/build/`` (not tracked by git) under a
name that carries the hash of the source, the headers it includes and the
flags, so a changed source or header is rebuilt and an unchanged one is
loaded as it is. Nothing here runs at import: the first call that needs a
kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

NVCC_TIMEOUT_S = 300  # one file builds in seconds; a hang must not outlive a run

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, dict] = {}   # name -> {"seconds", "built", "ptxas"}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin;"
            " the CUDA kernels of sqtpu_torch are built at first use")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list[str]:
    """``csrc/<name>.cu`` and every file under ``csrc/`` it includes with
    ``#include "..."``, directly or through another header, in the order
    first reached."""
    order, todo = [], [name + ".cu"]
    while todo:
        rel = todo.pop(0)
        if rel in order:
            continue
        order.append(rel)
        with open(os.path.join(CSRC_DIR, rel), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return [os.path.join(CSRC_DIR, rel) for rel in order]


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` is built for the current
    source, the headers it includes and the flags: an edit to any of them
    gives another path, so a stale library is never loaded."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless the library for this source
    exists; returns the library's path."""
    out = library_path(name)
    if os.path.exists(out):
        build_log.setdefault(name, {"seconds": 0.0, "built": False,
                                    "ptxas": ""})
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=NVCC_TIMEOUT_S)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    build_log[name] = {"seconds": time.perf_counter() - t0, "built": True,
                       "ptxas": res.stderr.strip()}
    return out


def build_all(names) -> None:
    """Build several sources at once: one ``nvcc`` process each, all
    started together. Raises the first build's error."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        for future in [pool.submit(build, name) for name in names]:
            future.result()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build(name))
    return _loaded[name]
