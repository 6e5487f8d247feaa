"""The boundary to the CUDA kernels of this package: build each source
with ``nvcc``, load and type its C entries with ``ctypes``, launch them on
the current stream and count the launches.

Each source under ``sqtpu_torch/csrc/`` exposes a plain ``extern "C"``
interface (:data:`ENTRIES`), so no PyTorch header is compiled and a build
takes seconds. The library lands in ``sqtpu_torch/build/`` (not tracked by
git) under a name that carries the hash of the source, the headers it
includes, the flags and any extra defines, so a changed source or header
is rebuilt and an unchanged one is loaded as it is. Nothing here runs at
import: the first call that needs a kernel builds it.

* :func:`library` builds (or takes another checkout's build) and loads a
  library, typed from :data:`ENTRIES`.
* :func:`launch` calls one of its entries on the device's current stream
  and raises on a non-zero code.
* :data:`launches` counts each kernel's launches by id; the wrappers add
  one (:func:`count`) where they launch and nowhere else.
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

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

NVCC_TIMEOUT_S = 300  # one file builds in seconds; a hang must not outlive a run

# The C entries of each library, name -> "return:arguments" with "p" a
# device pointer or stream, "i" int, "d" double and "s" const char*.
ENTRIES = {
    "hardrender": {"sqtpu_hardrender": "i:ppiiiiip",
                   "sqtpu_error_string": "s:i"},
    "implicit": {"sqtpu_implicit_blocks": "i:ii",
                 "sqtpu_implicit_fwd": "i:pppppiiiddp",
                 "sqtpu_implicit_bwd": "i:pppppppiiiddp",
                 "sqtpu_error_string": "s:i"},
    "explicit": {"sqtpu_explicit_blocks": "i:i",
                 "sqtpu_explicit_fused_blocks": "i:i",
                 "sqtpu_explicit_fwd": "i:ppppiidp",
                 "sqtpu_explicit_fused": "i:ppppppiidp",
                 "sqtpu_error_string": "s:i"},
    "voxel_iou": {"sqtpu_voxel_iou": "i:ppppiiiiip",
                  "sqtpu_error_string": "s:i"},
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "d": ctypes.c_double,
           "s": ctypes.c_char_p}

# Launches of each kernel since the last reset_launches(), by the ids of
# ``sqtpu_torch.ops.kernels.launch_counts``.
KERNELS = ("K3", "K1", "K2", "K4", "K5", "K6", "K6_bwd", "K7")
launches = dict.fromkeys(KERNELS, 0)

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


def source_files(name: str, root: str | None = None) -> list[str]:
    """``<root>/<name>.cu`` (root: this package's ``csrc/``) and every file
    under ``root`` it includes with ``#include "..."``, directly or through
    another header, in the order first reached."""
    root = root or CSRC_DIR
    order, todo = [], [name + ".cu"]
    while todo:
        rel = todo.pop(0)
        if rel in order:
            continue
        order.append(rel)
        with open(os.path.join(root, rel), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return [os.path.join(root, rel) for rel in order]


def library_path(name: str, defines=(), root: str | None = None) -> str:
    """Where the library of ``<root>/<name>.cu`` is built for the current
    source, the headers it includes, the flags and ``defines``: an edit to
    any of them gives another path, so a stale library is never loaded."""
    digest = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    for path in source_files(name, root):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(name: str, defines=(), root: str | None = None) -> str:
    """Compile ``<root>/<name>.cu`` (root: this package's ``csrc/``) with
    ``defines`` unless the library for these sources exists; returns
    ptxas's log, kept beside the library. This package's own builds are
    also recorded in :data:`build_log`."""
    out = library_path(name, defines, root)
    log = {"seconds": 0.0, "built": False, "ptxas": ""}
    if os.path.exists(out):
        if os.path.exists(f"{out}.log"):
            with open(f"{out}.log") as f:
                log["ptxas"] = f.read()
    else:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, *defines, "-o", tmp,
               os.path.join(root or CSRC_DIR, name + ".cu")]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=NVCC_TIMEOUT_S)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {res.returncode}):\n{res.stderr}")
        log = {"seconds": time.perf_counter() - t0, "built": True,
               "ptxas": res.stderr.strip()}
        with open(f"{out}.log", "w") as f:  # before the library appears
            f.write(log["ptxas"])
        os.replace(tmp, out)  # atomic: a loader never sees half a file
    if not defines and root is None:
        build_log.setdefault(name, log)
    return log["ptxas"]


def build_all(names) -> None:
    """Build several sources at once: one ``nvcc`` process each, all
    started together. Raises the first build's error."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        for future in [pool.submit(build, name) for name in names]:
            future.result()


def library(name: str, path: str | None = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed, or the
    library at ``path`` built from another checkout's or with other
    defines; its C entries typed from ``ENTRIES[name]``."""
    key = path or name
    if key not in _loaded:
        if path is None:
            build(name)
            path = library_path(name)
        lib = ctypes.CDLL(path)
        for entry, sig in ENTRIES[name].items():
            ret, args = sig.split(":")
            fn = getattr(lib, entry)
            fn.restype = _CTYPES[ret]
            fn.argtypes = [_CTYPES[c] for c in args]
        _loaded[key] = lib
    return _loaded[key]


def launch(lib: ctypes.CDLL, entry: str, device: torch.device, *args,
           what: str) -> None:
    """Call ``entry`` of ``lib`` with ``args`` and the current stream of
    ``device``; raises unless the kernel launched."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.sqtpu_error_string(err).decode())


def count(kernel: str) -> None:
    """One more launch of ``kernel`` (an id of :data:`KERNELS`)."""
    launches[kernel] += 1


def reset_launches() -> None:
    for kernel in KERNELS:
        launches[kernel] = 0
