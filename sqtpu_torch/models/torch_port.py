"""torchvision ResNet-18 weights in and out of the port's ResNetSQ
encoder.

Counterpart of ``sqtpu/models/torch_port.py``. The reference trains from
torchvision's ImageNet resnet18 and collapses conv1 to one channel by
summing its RGB kernel (``torch/models.py:184``, quirk Q14).
:func:`load_torchvision_resnet18` does the same with any torchvision
``resnet18`` state_dict (``fc.*`` is ignored: the reference replaces the
fc); :func:`export_torchvision_resnet18` writes the encoder back in that
layout, conv1 single-channel, so export -> load round-trips exactly. The
port's encoder is OIHW like torchvision's, so only the names change:
``layer1_0.downsample_conv`` <-> ``layer1.0.downsample.0`` and so on.
A file is read from disk only (``.npz``, or ``.pt``/``.pth`` through
``torch.load(weights_only=True)``); nothing is downloaded.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn


def load_state_dict_file(path: str) -> dict:
    """A resnet18 state_dict from ``.npz`` (numpy arrays under the torch
    keys) or ``.pt``/``.pth``, as numpy arrays."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}


def _torchvision_name(key: str) -> str:
    """A key of the port's ``ResNet18`` state_dict -> torchvision's."""
    key = re.sub(r"^layer(\d+)_(\d+)\.", r"layer\1.\2.", key)
    return (key.replace("downsample_conv.", "downsample.0.")
            .replace("downsample_bn.", "downsample.1."))


def export_torchvision_resnet18(model: nn.Module) -> dict:
    """``model.encoder`` as a torchvision-resnet18-layout state_dict of
    float32 numpy arrays (weights, biases and running statistics; no
    ``num_batches_tracked``, which the JAX package's export has not)."""
    return {_torchvision_name(k): v.detach().to("cpu", torch.float32).numpy()
            for k, v in model.encoder.state_dict().items()
            if not k.endswith("num_batches_tracked")}


@torch.no_grad()
def load_torchvision_resnet18(model: nn.Module,
                              state_dict: dict) -> nn.Module:
    """Replace ``model.encoder``'s weights and BatchNorm statistics with a
    torchvision resnet18 state_dict (tensors or arrays), conv1's RGB
    kernel summed to one channel; in place, returns ``model``. A missing
    key raises ``KeyError``; keys the encoder has no place for (``fc.*``,
    ``num_batches_tracked``) are ignored."""
    target = model.encoder.state_dict()
    new = {}
    for key, t in target.items():
        if key.endswith("num_batches_tracked"):
            new[key] = t
            continue
        w = np.asarray(state_dict[_torchvision_name(key)])
        if key == "conv1.weight":
            w = w.sum(axis=1, keepdims=True)   # RGB -> 1 channel
        new[key] = torch.from_numpy(np.asarray(w, np.float32)).to(t)
    model.encoder.load_state_dict(new)
    return model
