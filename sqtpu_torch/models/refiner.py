"""The render-and-compare corrector ``refine_sq`` in PyTorch.

Counterpart of ``sqtpu/models/refiner.py``. :class:`IterativeSQ` is a
ResNetSQ base prediction followed by ``n_refine`` passes of one shared
:class:`RefineBlock`: render the current estimate with the hard
ray-caster (K3 on the card), encode the input image beside the rendering,
and regress an additive update of size, shape and position and a small
world-frame rotation (:func:`apply_delta`). The delta head starts at
zero, so the corrector is an exact identity at init.

The rendering is of the detached estimate and carries no gradient: the
corrector learns from the loss on its output, and the base receives
gradients only through :func:`apply_delta`'s additive chain. The one
:class:`RefineBlock` instance is called ``n_refine`` times, so in training
its BatchNorm statistics move once per call, each move seeing the one
before, as in flax; ``remat`` recomputes both encoders in the backward
with their statistics left alone. ``dtype`` is flax's, as in
:mod:`sqtpu_torch.models.resnet` (the delta head computes in it too).

The forward marks its phases as spans (:mod:`sqtpu_torch.utils.profiling`):
``refine.base`` around the base, and for each pass ``refine.render``
around the in-loop render and ``refine.pass`` around the block and
:func:`apply_delta`; their calls count the passes and the renders.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sqtpu_torch.models.resnet import (
    Linear, ResNet18, ResNetSQ, init_like_flax,
)
from sqtpu_torch.ops import geometry, kernels
from sqtpu_torch.ops import quaternion as quat
from sqtpu_torch.utils.checkpoint import load_weights_npz
from sqtpu_torch.utils.profiling import span


def apply_delta(p: torch.Tensor, delta: torch.Tensor,
                scale: float = 0.2) -> torch.Tensor:
    """One update of (B, 12) params by ``delta`` (B, 11) = [da(3), de(2),
    dt(3), dv(3)], scaled: additive in a, e, t (clipped to the valid
    box), multiplicative on the quaternion through dq = normalize([dv, 1])
    on the left. A zero delta leaves a valid estimate as it is."""
    d = delta * scale
    da, de, dt, dv = d[..., 0:3], d[..., 3:5], d[..., 5:8], d[..., 8:11]
    a = geometry.clip(p[..., 0:3] + da, geometry.A_MIN, geometry.A_MAX)
    e = geometry.clip(p[..., 3:5] + de, geometry.E_MIN, geometry.E_MAX)
    t = geometry.clip(p[..., 5:8] + dt, geometry.T_MIN, geometry.T_MAX)
    dq = quat.normalize(torch.cat([dv, torch.ones_like(dv[..., :1])], -1))
    q = quat.normalize(quat.multiply(dq, p[..., 8:12]))
    return torch.cat([a, e, t, q], dim=-1)


class RefineBlock(nn.Module):
    """One corrector pass: (input image ‖ rendering) and the current
    params -> an 11-vector delta. ResNet18 on the two channels, then
    [features, p] -> Dense(fcn) -> Dense(fcn) -> Dense(11, zeros)."""

    def __init__(self, fcn: int = 256, dtype=None):
        super().__init__()
        self.encoder = ResNet18(in_channels=2, dtype=dtype)
        self.fc1 = Linear(self.encoder.out_features + 12, fcn, dtype=dtype)
        self.fc2 = Linear(fcn, fcn, dtype=dtype)
        self.delta = Linear(fcn, 11, dtype=dtype)
        init_like_flax(self)
        with torch.no_grad():
            self.delta.weight.zero_()
            self.delta.bias.zero_()

    def forward(self, img2: torch.Tensor, p: torch.Tensor,
                remat: bool = False) -> torch.Tensor:
        """``img2``: (B, H, W, 2) NHWC; ``p``: (B, 12)."""
        feats = self.encoder(img2.permute(0, 3, 1, 2), remat)
        h = torch.cat([feats, p.to(feats.dtype)], dim=-1)
        h = F.leaky_relu(self.fc1(h), 0.01)
        h = F.leaky_relu(self.fc2(h), 0.01)
        return self.delta(h)


class IterativeSQ(nn.Module):
    """ResNetSQ base + ``n_refine`` shared render-and-compare corrector
    passes; returns the same ``(size, shape, position, quaternion)`` tuple
    as ResNetSQ. The in-loop renders are unquantized at ``n_sweep`` slabs
    and 24 bisections, at the input's size."""

    def __init__(self, n_refine: int = 2, fcn: int = 256,
                 delta_scale: float = 0.2, n_sweep: int = 48, dtype=None):
        super().__init__()
        self.n_refine, self.delta_scale = n_refine, delta_scale
        self.n_sweep = n_sweep
        self.base = ResNetSQ(fcn, dtype=dtype)
        self.refine = RefineBlock(fcn, dtype=dtype)

    def forward(self, x: torch.Tensor, remat: bool = False):
        """``x``: (B, H, W, 1) or (B, H, W) depth images in [0, 1];
        ``remat`` recomputes both encoders in the backward."""
        if x.ndim == 3:
            x = x[..., None]
        with span("refine.base"):
            p = torch.cat(self.base(x, remat), dim=-1)
        s = x.shape[1]
        for _ in range(self.n_refine):
            with span("refine.render"):
                rendered = kernels.render_hard_auto(
                    p.detach().float(), s, n_sweep=self.n_sweep,
                    n_bisect=24, quantize=False)
            with span("refine.pass"):
                img2 = torch.cat([x, rendered[..., None].to(x.dtype)],
                                 dim=-1)
                p = apply_delta(p, self.refine(img2, p, remat),
                                self.delta_scale)
        return p[..., 0:3], p[..., 3:5], p[..., 5:8], p[..., 8:12]


def warm_start_base(model: IterativeSQ, npz_path: str) -> IterativeSQ:
    """Load a ``resnet_sq`` weights file (flat ``params/...`` and
    ``batch_stats/...`` keys with no ``base/`` prefix) into ``model.base``
    only; the corrector keeps its identity init. In place; returns
    ``model``."""
    load_weights_npz(npz_path, model.base)
    return model
