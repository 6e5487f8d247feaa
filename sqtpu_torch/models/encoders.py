"""The 13-block convolutional encoder and the MLP neck of the 2019 models
and ``GenericNetSQ``, in PyTorch.

Counterpart of ``sqtpu/models/encoders.py``. Public inputs are NCHW
here (the nets convert their NHWC input). Two layout facts carry the
flax weights over unchanged:

* padding is XLA's ``'SAME'``: the output is ceil(n / stride), and the
  padding that needs is split low = total // 2, high = the rest, so a
  stride-2 3x3 on an even input pads (0, 1), the 7x7 stem on 256 pads
  (2, 3) and a stride-1 3x3 pads (1, 1). torch's ``padding='same'``
  refuses stride 2, and a symmetric pad is another network;
* a flatten is NHWC's: (B, C, H, W) is permuted to (B, H, W, C) before
  it is flattened, as the flax Dense that follows was trained on.

Submodule names follow flax's (``Conv_0``..``Conv_12``,
``BatchNorm_0``..``BatchNorm_12``, ``Dense_0``, ``Dense_1``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sqtpu_torch.models.resnet import Conv2d, Linear, _bn, checkpointed

WIDTHS = (32, 32, 32, 32, 64, 64, 64, 128, 128, 128, 256, 256, 256)
STRIDED = (0, 3, 6, 9, 12)


def same_pads(n: int, kernel: int, stride: int) -> tuple:
    """XLA's 'SAME' (low, high) padding of one axis of size ``n``."""
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """``jax.nn.leaky_relu``: its derivative at exactly 0 is 1, where
    torch's is the slope; a depth map's empty background gives exact
    zeros."""
    return torch.where(x >= 0, x, x * slope)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H·W·C) in NHWC order, as flax flattens."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class ConvEncoder(nn.Module):
    """13 blocks of Conv (bias) + BatchNorm + activation, stride 2 on
    blocks 0, 3, 6, 9 and 12, a 7x7 stem: (B, 1, 256, 256) -> (B, 256,
    8, 8). ``activation`` is ``"leaky_relu"`` (slope 0.01, the torch
    generation) or ``"relu"`` (the Keras one); ``dtype`` as in
    :mod:`sqtpu_torch.models.resnet`."""

    def __init__(self, activation: str = "leaky_relu",
                 widths: Sequence[int] = WIDTHS, dtype=None):
        super().__init__()
        if activation not in ("leaky_relu", "relu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        cin = 1
        for i, w in enumerate(widths):
            k, s = (7 if i == 0 else 3), (2 if i in STRIDED else 1)
            # stride 1: 'SAME' is the symmetric (k - 1) / 2 on any size;
            # stride 2 pads in _block, from the input's size
            self.add_module(f"Conv_{i}", Conv2d(
                cin, w, k, s, padding=(k - 1) // 2 if s == 1 else 0,
                bias=True, dtype=dtype))
            self.add_module(f"BatchNorm_{i}", _bn(w))
            cin = w
        self.n_blocks = len(widths)
        self.out_features = cin

    def _block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, f"Conv_{i}")
        k, s = conv.kernel_size[0], conv.stride[0]
        if s != 1:
            (top, bottom), (left, right) = (same_pads(x.shape[2], k, s),
                                            same_pads(x.shape[3], k, s))
            x = F.pad(x, (left, right, top, bottom))
        x = getattr(self, f"BatchNorm_{i}")(conv(x))
        if self.activation == "relu":
            return F.relu(x)
        return leaky_relu(x)

    def _stage(self, lo: int, hi: int):
        def run(x):
            for i in range(lo, hi):
                x = self._block(i, x)
            return x
        return run

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """``x``: NCHW. ``remat`` recomputes each stage (the blocks from
        one stride-2 block to the next) in the backward."""
        bounds = [i for i in STRIDED if i < self.n_blocks] + [self.n_blocks]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            fn = self._stage(lo, hi)
            x = checkpointed(fn, self, x) if remat else fn(x)
        return x


class MLPNeck(nn.Module):
    """Flatten (NHWC order) + 2 x (Dense + LeakyReLU 0.01)."""

    def __init__(self, in_features: int, features: int = 256, dtype=None):
        super().__init__()
        self.Dense_0 = Linear(in_features, features, dtype=dtype)
        self.Dense_1 = Linear(features, features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.Dense_0(flatten_nhwc(x)))
        return leaky_relu(self.Dense_1(x))
