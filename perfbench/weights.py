"""The weights a cell starts from, made by the benchmark and handed alike
to the program and to the reference, keyed by the port's ``state_dict``
names (:func:`perfbench.reference.model.spec`).

* ``flax_init``: flax's initial distribution drawn on the device from the
  seed: every kernel lecun_normal (a unit normal truncated at ±2,
  scaled to standard deviation sqrt(1 / fan_in)), biases 0, BatchNorm
  scale 1, bias 0, running mean 0 and variance 1. All kernels come from
  one draw of a generator on the device, cut in the spec's order.
* ``npz:<path>``: a flax weights file of the repository (conv kernels
  HWIO, dense kernels (in, out)), whose sha256 the configuration states.
"""

from __future__ import annotations

import hashlib
import math
import os

import numpy as np
import torch

from perfbench.reference import model

# the standard deviation of a unit normal truncated at ±2
_TRUNC_STD = 0.87962566103423978


def flax_init(seed: int, device: torch.device) -> dict:
    rows = model.spec()
    kernels = [r for r in rows if r[3] == "kernel"]
    total = sum(math.prod(shape) for _, shape, _, _ in kernels)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, at = {}, 0
    for key, shape, fan_in, kind in rows:
        if kind == "kernel":
            n = math.prod(shape)
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            out[key] = (flat[at:at + n] * std).reshape(shape)
            at += n
        else:
            fill = torch.ones if kind == "ones" else torch.zeros
            out[key] = fill(shape, dtype=torch.float32, device=device)
    return out


def _flax_key(key: str) -> str:
    *path, leaf = key.split(".")
    if leaf == "running_mean":
        return "/".join(["batch_stats", *path, "mean"])
    if leaf == "running_var":
        return "/".join(["batch_stats", *path, "var"])
    if leaf == "weight":
        leaf = "kernel" if not path[-1].startswith(("bn", "downsample_bn")) \
            else "scale"
    return "/".join(["params", *path, leaf])


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def load_npz(path: str, digest: str, device: torch.device) -> dict:
    """The flax file at ``path`` (checked against ``digest``) by the
    spec's keys, float32 on ``device``."""
    if sha256(path) != digest:
        raise RuntimeError(f"{path} is not the file this configuration "
                           f"names (sha256 {digest})")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    out = {}
    for key, shape, _, _ in model.spec():
        arr = np.asarray(flat.pop(_flax_key(key)), dtype=np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)      # HWIO -> OIHW
        elif arr.ndim == 2:
            arr = arr.T                          # (in, out) -> (out, in)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{key}: {arr.shape} in the file, {shape} in "
                             "the model")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    if flat:
        raise KeyError(f"weights with no place in the model: {sorted(flat)}")
    return out


def make(source: str, seed: int, device: torch.device, root: str,
         digest: str = "") -> dict:
    """The weights a configuration's ``weights`` entry names."""
    if source == "flax_init":
        return flax_init(seed, device)
    if source.startswith("npz:"):
        return load_npz(os.path.join(root, source[4:]), digest, device)
    raise ValueError(f"unknown weights source {source!r}")
