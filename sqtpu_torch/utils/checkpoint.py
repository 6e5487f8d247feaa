"""Weights carried across from the JAX package's portable ``.npz`` files.

``sqtpu.utils.checkpoint.save_weights_npz`` writes a model's variables as
flat arrays named ``params/<module path>/<leaf>`` and
``batch_stats/<module path>/<leaf>`` (float16 params, float32 statistics).
:func:`state_dict_from_flax` maps them onto a port model's ``state_dict``:
fp32, conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in),
BatchNorm scale/mean/var -> weight/running_mean/running_var. Any key that
is missing or left over raises.
"""

from __future__ import annotations

import numpy as np
import torch

_LEAF = {("params", "kernel"): "weight", ("params", "bias"): "bias",
         ("params", "scale"): "weight",
         ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}


def _convert(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 4:          # conv kernel HWIO -> OIHW
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 2:          # dense kernel (in, out) -> (out, in)
        return arr.T
    return arr


def state_dict_from_flax(flat: dict, template: dict) -> dict:
    """Flat flax arrays -> a ``state_dict`` for the model whose own
    ``state_dict()`` is ``template``. Raises ``KeyError`` on any key that
    is missing or left over and ``ValueError`` on a shape mismatch."""
    out, leftover = {}, []
    for key, arr in flat.items():
        collection, *path, leaf = key.split("/")
        name = _LEAF.get((collection, leaf))
        tkey = ".".join(path + [name]) if name else None
        if tkey is None or tkey not in template:
            leftover.append(key)
            continue
        t = template[tkey]
        value = torch.tensor(_convert(arr))  # a copy: arr may be read-only
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} after "
                             f"conversion, model expects {tuple(t.shape)}")
        out[tkey] = value.to(t.dtype)
    if leftover:
        raise KeyError(f"weights with no place in the model: {leftover}")
    for tkey, t in template.items():
        if tkey.endswith("num_batches_tracked") and tkey not in out:
            out[tkey] = torch.zeros_like(t)  # flax keeps no such counter
    missing = [k for k in template if k not in out]
    if missing:
        raise KeyError(f"model weights missing from the file: {missing}")
    return out


def load_weights_npz(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a ``save_weights_npz`` artifact into ``model`` in place."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    model.load_state_dict(state_dict_from_flax(flat, model.state_dict()))
    return model
