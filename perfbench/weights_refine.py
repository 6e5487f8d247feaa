"""The corrector's weights (``IterativeSQ``), keyed by the port's
``state_dict`` names (:func:`perfbench.reference.refiner.spec`).

* ``npz:<path>``: a flax weights file of the repository whose sha256 the
  configuration states: ``params|batch_stats/{base,refine}/…`` mapped to
  ``base.…`` and ``refine.…``, conv kernels HWIO -> OIHW, dense kernels
  (in, out) -> (out, in), float32 on the device. A key of the file with
  no place in the spec, or a key of the spec with none in the file,
  raises.

:func:`random` draws seeded random weights for the tests: flax's initial
distribution (:func:`perfbench.weights.flax_init`'s rule) for every
kernel, the delta head included, whose published init is zero (that
would make every pass an identity), BatchNorm at its identity.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from perfbench.reference import refiner
from perfbench.weights import _TRUNC_STD, _flax_key, sha256


def load_npz(path: str, digest: str, device: torch.device) -> dict:
    if sha256(path) != digest:
        raise RuntimeError(f"{path} is not the file this configuration "
                           f"names (sha256 {digest})")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    out = {}
    for key, shape, _, _ in refiner.spec():
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


def random(seed: int, device: torch.device) -> dict:
    """Every kernel drawn as flax draws a kernel (lecun_normal), from one
    generator on ``device`` in the spec's order; biases 0, BatchNorm
    scale 1, bias 0, mean 0, variance 1."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for key, shape, fan_in, kind in refiner.spec():
        if kind == "kernel":
            t = torch.empty(shape, dtype=torch.float32, device=device)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
            out[key] = t * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)
        else:
            fill = torch.ones if kind == "ones" else torch.zeros
            out[key] = fill(shape, dtype=torch.float32, device=device)
    return out


def make(source: str, seed: int, device: torch.device, root: str,
         digest: str = "") -> dict:
    """The weights a corrector configuration's ``weights`` entry names."""
    if source.startswith("npz:"):
        return load_npz(os.path.join(root, source[4:]), digest, device)
    raise ValueError(f"unknown weights source {source!r}")
