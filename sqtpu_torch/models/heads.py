"""Output heads for superquadric parameter regression.

Counterpart of ``sqtpu/models/heads.py``: Size, Shape and Position are
Linear -> sigmoid; Rotation is Linear -> unit quaternion; Block is a raw
Linear; Rotation6D is Linear -> the 6D rotation representation -> unit
quaternion. Submodule names follow the flax names (``Dense_0``) so
weights map one to one. A head computes in its parameters' dtype: a
bfloat16 input is promoted to float32, as flax's ``Dense`` with no
``dtype`` promotes it.
"""

from __future__ import annotations

import torch
from torch import nn

from sqtpu_torch.ops import quaternion as quat


class _Head(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features)

    def _trunk(self, x):
        w = self.Dense_0.weight
        return self.Dense_0(x.to(torch.promote_types(x.dtype, w.dtype)))


class SizeHead(_Head):
    def __init__(self, in_features: int, features: int = 3):
        super().__init__(in_features, features)

    def forward(self, x):
        return torch.sigmoid(self._trunk(x))


class ShapeHead(_Head):
    def __init__(self, in_features: int, features: int = 2):
        super().__init__(in_features, features)

    def forward(self, x):
        return torch.sigmoid(self._trunk(x))


class PositionHead(_Head):
    def __init__(self, in_features: int, features: int = 3):
        super().__init__(in_features, features)

    def forward(self, x):
        return torch.sigmoid(self._trunk(x))


class RotationHead(_Head):
    """Linear -> unit quaternion. The sum of squares is clamped at 1e-6
    before the reciprocal square root, so a zero logit vector gives a
    finite value and gradient (identical to q/‖q‖ for ‖q‖ > 1e-3)."""

    def __init__(self, in_features: int, features: int = 4):
        super().__init__(in_features, features)

    def forward(self, x):
        return _safe_normalize(self._trunk(x))


class BlockHead(_Head):
    """The reference's unused 8-parameter head: a raw Linear."""

    def __init__(self, in_features: int, features: int = 8):
        super().__init__(in_features, features)

    def forward(self, x):
        return self._trunk(x)


def _safe_normalize(v: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """v · rsqrt(max(Σv², eps)): v/‖v‖ where ‖v‖² > eps, with a finite
    value and gradient at v = 0."""
    sumsq = torch.sum(v * v, dim=-1, keepdim=True)
    return v * torch.rsqrt(torch.clamp(sumsq, min=eps))


class Rotation6DHead(_Head):
    """Linear -> two raw 3-vectors (offset by (1,0,0) and (0,1,0), so zero
    logits give the identity) -> Gram-Schmidt -> the rotation matrix with
    those columns -> unit quaternion (:func:`quaternion.from_matrix`).
    The continuous rotation representation of Zhou et al. (CVPR 2019)."""

    def __init__(self, in_features: int, features: int = 6):
        super().__init__(in_features, features)

    def forward(self, x):
        raw = self._trunk(x)
        a1, a2 = torch.split(raw + raw.new_tensor([1, 0, 0, 0, 1, 0]), 3,
                             dim=-1)
        b1 = _safe_normalize(a1)
        b2 = _safe_normalize(a2 - torch.sum(b1 * a2, -1, keepdim=True) * b1)
        b3 = torch.linalg.cross(b1, b2, dim=-1)
        return quat.from_matrix(torch.stack([b1, b2, b3], dim=-1))
