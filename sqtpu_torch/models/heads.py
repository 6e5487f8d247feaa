"""Output heads for superquadric parameter regression.

Counterpart of ``sqtpu/models/heads.py:19-70``: Size, Shape and Position
are Linear -> sigmoid; Rotation is Linear -> unit quaternion. Submodule
names follow the flax names (``Dense_0``) so weights map one to one.
"""

from __future__ import annotations

import torch
from torch import nn


class _Head(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features)


class SizeHead(_Head):
    def __init__(self, in_features: int, features: int = 3):
        super().__init__(in_features, features)

    def forward(self, x):
        return torch.sigmoid(self.Dense_0(x))


class ShapeHead(_Head):
    def __init__(self, in_features: int, features: int = 2):
        super().__init__(in_features, features)

    def forward(self, x):
        return torch.sigmoid(self.Dense_0(x))


class PositionHead(_Head):
    def __init__(self, in_features: int, features: int = 3):
        super().__init__(in_features, features)

    def forward(self, x):
        return torch.sigmoid(self.Dense_0(x))


class RotationHead(_Head):
    """Linear -> unit quaternion. The sum of squares is clamped at 1e-6
    before the reciprocal square root, so a zero logit vector gives a
    finite value and gradient (identical to q/‖q‖ for ‖q‖ > 1e-3)."""

    def __init__(self, in_features: int, features: int = 4):
        super().__init__(in_features, features)

    def forward(self, x):
        q = self.Dense_0(x)
        sumsq = torch.sum(q * q, dim=-1, keepdim=True)
        return q * torch.rsqrt(torch.clamp(sumsq, min=1e-6))
