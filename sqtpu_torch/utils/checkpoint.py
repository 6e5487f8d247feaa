"""Checkpoints of the port, and weights carried to and from the JAX
package's portable ``.npz`` files.

Counterpart of ``sqtpu/utils/checkpoint.py``.

* :func:`save_checkpoint` / :func:`load_checkpoint`: the port's own full
  train state (model, optimizer, scheduler, history, epoch) with
  ``torch.save`` at ``<path>.pt``, beside the same ``<path>.meta.json``
  sidecar as the JAX package's (epoch, history, the run's config). The
  JAX package's Orbax directories are not read. :func:`load_config`
  rebuilds the run's config from the sidecar, so a checkpoint is restored
  with the recipe that wrote it, not with a default one.
* ``sqtpu.utils.checkpoint.save_weights_npz`` writes a model's variables as
  flat arrays named ``params/<module path>/<leaf>`` and
  ``batch_stats/<module path>/<leaf>`` (float16 params, float32
  statistics). :func:`state_dict_from_flax` maps them onto a port model's
  ``state_dict``: fp32, conv kernels HWIO -> OIHW, dense kernels (in, out)
  -> (out, in), BatchNorm scale/mean/var -> weight/running_mean/
  running_var; any key that is missing or left over raises.
  :func:`save_weights_npz` is the way back, so ``sqtpu.evaluate`` can load
  weights the port trained.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

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


def _flax_name(key: str, ndim: int):
    """A port ``state_dict`` key -> its flat flax name, or None for a
    buffer flax does not keep."""
    *path, leaf = key.split(".")
    if leaf == "num_batches_tracked":
        return None
    if leaf == "running_mean":
        return "/".join(["batch_stats", *path, "mean"])
    if leaf == "running_var":
        return "/".join(["batch_stats", *path, "var"])
    if leaf == "weight":
        leaf = "kernel" if ndim > 1 else "scale"   # conv/dense vs BatchNorm
    return "/".join(["params", *path, leaf])


def flax_from_state_dict(state_dict: dict) -> dict:
    """The reverse of :func:`state_dict_from_flax`: a port ``state_dict``
    -> flat flax arrays (float32, conv kernels OIHW -> HWIO, dense kernels
    (out, in) -> (in, out))."""
    flat = {}
    for key, value in state_dict.items():
        arr = value.detach().to("cpu", torch.float32).numpy()
        name = _flax_name(key, arr.ndim)
        if name is None:
            continue
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        elif arr.ndim == 2:
            arr = arr.T
        flat[name] = np.ascontiguousarray(arr)
    return flat


def save_weights_npz(path: str, model: torch.nn.Module,
                     dtype=np.float16) -> None:
    """Write ``model``'s variables as the JAX package's flat compressed
    npz (``sqtpu.utils.checkpoint.save_weights_npz``): params cast to
    ``dtype``, BatchNorm statistics kept in float32."""
    flat = flax_from_state_dict(model.state_dict())
    cast = {k: (v if k.startswith("batch_stats/") else v.astype(dtype))
            for k, v in flat.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez_compressed(os.path.abspath(path), **cast)


def _json_safe(x):
    """Non-finite floats -> None, containers recursively, anything else
    JSON does not take -> its repr: the sidecar is strict JSON."""
    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, dict):
        return {str(k): _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if x is None or isinstance(x, (str, int, bool)):
        return x
    return repr(x)


def _from_json(x):
    return float("nan") if x is None else x


def save_checkpoint(path: str, state, history: dict, epoch: int,
                    config=None, scheduler=None) -> None:
    """Write the full train state to ``<path>.pt`` (atomically replaced)
    and the sidecar ``<path>.meta.json`` (epoch, history, config)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict(),
               "scheduler": (scheduler.state_dict()
                             if scheduler is not None else None),
               "history": history, "epoch": int(epoch)}
    tmp = f"{path}.pt.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path + ".pt")
    meta = {"epoch": int(epoch), "history": _json_safe(history)}
    if config is not None:
        if dataclasses.is_dataclass(config):
            config = dataclasses.asdict(config)
        meta["config"] = _json_safe(dict(config))
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, allow_nan=False)


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(os.path.abspath(path) + ".pt")


def load_model_state(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load only the model weights of a :func:`save_checkpoint` file."""
    payload = torch.load(os.path.abspath(path) + ".pt", map_location="cpu",
                         weights_only=True)
    model.load_state_dict(payload["model"])
    return model


def load_checkpoint(path: str, state, scheduler=None):
    """Restore ``state`` (model and optimizer, in place) and ``scheduler``
    from :func:`save_checkpoint`; returns ``(history, epoch)``."""
    path = os.path.abspath(path)
    device = next(state.model.parameters()).device
    payload = torch.load(path + ".pt", map_location=device,
                         weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    if scheduler is not None and payload["scheduler"] is not None:
        scheduler.load_state_dict(payload["scheduler"])
    return payload["history"], payload["epoch"]


def load_config(path: str, cls):
    """The config a checkpoint was written with, from its sidecar, as an
    instance of ``cls``; fields the sidecar lacks keep their defaults."""
    with open(os.path.abspath(path) + ".meta.json") as f:
        saved = json.load(f).get("config", {})
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: _from_json(v) for k, v in saved.items() if k in names})
