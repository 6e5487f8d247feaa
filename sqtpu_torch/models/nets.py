"""The rotation-only ``GenericNetSQ`` and the 2019 Keras regressors, in
PyTorch.

Counterpart of ``sqtpu/models/nets.py``. Each takes (B, H, W, 1) or
(B, H, W) depth images (NHWC, as the JAX models), runs the 13-block
:class:`ConvEncoder` and flattens its (B, 256, H/32, W/32) output in
NHWC order into a dense layer sized for ``image_size`` (flax infers that
width from the first input; here it is fixed at construction):

* :class:`GenericNetSQ`: leaky-ReLU encoder -> :class:`MLPNeck` ->
  unit quaternion, 4 outputs;
* :class:`KerasIsoNet`: ReLU encoder -> Dense(8), the isometric-view
  size, shape and position;
* :class:`KerasRotNet`: ReLU encoder -> Dense(12), raw;
* :class:`KerasRotNetFixed`: the same with sigmoid blocks, a unit
  quaternion and the neutral start (see its docstring).

``dtype`` is flax's, as in :mod:`sqtpu_torch.models.resnet`: the Keras
nets' output layer computes in it too, so their output has that dtype;
``GenericNetSQ``'s rotation head computes in float32. ``forward(x,
remat=True)`` recomputes the encoder's stages in the backward.
"""

from __future__ import annotations

import torch
from torch import nn

from sqtpu_torch.models.encoders import ConvEncoder, MLPNeck, flatten_nhwc
from sqtpu_torch.models.heads import RotationHead, _safe_normalize
from sqtpu_torch.models.resnet import Linear, init_like_flax


def _nchw(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 3:
        x = x[..., None]
    return x.permute(0, 3, 1, 2)


def _flat_features(encoder: ConvEncoder, image_size: int) -> int:
    cells = image_size
    for _ in range(5):      # five stride-2 'SAME' stages: ceil(n / 2) each
        cells = -(-cells // 2)
    return encoder.out_features * cells * cells


class GenericNetSQ(nn.Module):
    """Leaky-ReLU encoder -> MLP(fcn, fcn) -> unit quaternion (B, 4): the
    reference's rotation-only model."""

    def __init__(self, fcn: int = 256, dtype=None, image_size: int = 256):
        super().__init__()
        self.encoder = ConvEncoder("leaky_relu", dtype=dtype)
        self.neck = MLPNeck(_flat_features(self.encoder, image_size), fcn,
                            dtype=dtype)
        self.head_rotation = RotationHead(fcn)
        init_like_flax(self)

    def forward(self, x, remat: bool = False):
        return self.head_rotation(self.neck(self.encoder(_nchw(x), remat)))


class KerasIsoNet(nn.Module):
    """ReLU encoder -> Flatten -> Dense(8): the 2019 isometry regressor,
    trained with the plain MSE on the 8 normalized parameters."""

    def __init__(self, outputs: int = 8, dtype=None, image_size: int = 256):
        super().__init__()
        self.encoder = ConvEncoder("relu", dtype=dtype)
        self.out = Linear(_flat_features(self.encoder, image_size), outputs,
                          dtype=dtype)
        init_like_flax(self)

    def forward(self, x, remat: bool = False):
        return self.out(flatten_nhwc(self.encoder(_nchw(x), remat)))


class KerasRotNet(KerasIsoNet):
    """ReLU encoder -> Flatten -> Dense(12), raw: the 2019 rotation
    regressor with the Flatten its reference forgot (quirk Q8)."""

    def __init__(self, outputs: int = 12, dtype=None, image_size: int = 256):
        super().__init__(outputs, dtype, image_size)


class _NeutralDense(Linear):
    """Dense whose start is neutral: flax's ``variance_scaling(0.01,
    "fan_in", "truncated_normal")`` kernel and a bias of (0, …, 0, 1)."""

    kernel_scale = 0.01

    @staticmethod
    def flax_bias(bias: torch.Tensor) -> None:
        bias[-1] = 1.0          # the identity quaternion (xyzw)


class KerasRotNetFixed(nn.Module):
    """The 2019 rotation architecture with bounded outputs: ReLU encoder
    -> Flatten -> Dense(12) -> sigmoid on size, shape and position, the
    quaternion normalized (safe at 0). The output layer starts neutral
    (:class:`_NeutralDense`): sigmoid(≈0) = 0.5 mid-range blocks and the
    identity quaternion. A default-initialized Dense(12) under the ×100
    explicit-loss gradients saturates the sigmoids in the first epoch
    (the JAX package's ``runs/krf_train.log``: IoU exactly 0 for 90
    epochs). Train with ``--loss explicit --grad-clip 1.0``."""

    def __init__(self, outputs: int = 12, dtype=None, image_size: int = 256):
        super().__init__()
        self.encoder = ConvEncoder("relu", dtype=dtype)
        self.out = _NeutralDense(_flat_features(self.encoder, image_size),
                                 outputs, dtype=dtype)
        init_like_flax(self)

    def forward(self, x, remat: bool = False):
        raw = self.out(flatten_nhwc(self.encoder(_nchw(x), remat)))
        return torch.cat([torch.sigmoid(raw[..., :8]),
                          _safe_normalize(raw[..., 8:12])], dim=-1)
