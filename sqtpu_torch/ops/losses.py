"""The superquadric's gauge group, in PyTorch.

Counterpart of the gauge part of ``sqtpu/ops/losses.py`` (:166-270). The
losses themselves belong to the training slices.
"""

from __future__ import annotations

import torch

from sqtpu_torch.ops import geometry
from sqtpu_torch.ops import quaternion as quat

# xyzw quaternions of the identity and the 180° turns about each principal
# axis: the exact D2 symmetry group of a superquadric.
SQ_FLIP_QUATS = (
    (0.0, 0.0, 0.0, 1.0),
    (1.0, 0.0, 0.0, 0.0),
    (0.0, 1.0, 0.0, 0.0),
    (0.0, 0.0, 1.0, 0.0),
)

_SQ2 = 0.7071067811865476

# The other four elements of the D4 gauge group: a body quarter-turn about
# z (or a 180° turn about a diagonal) together with the swap a1 <-> a2.
SQ_GAUGE_QUATS_SWAP = (
    (0.0, 0.0, _SQ2, _SQ2),    # Rz(+90)
    (0.0, 0.0, -_SQ2, _SQ2),   # Rz(-90)
    (_SQ2, _SQ2, 0.0, 0.0),    # 180° about (1,1,0)/√2
    (_SQ2, -_SQ2, 0.0, 0.0),   # 180° about (1,-1,0)/√2
)


def _right_multiply(q: torch.Tensor, g) -> torch.Tensor:
    return quat.multiply(q, q.new_tensor(g).expand_as(q))


def _flip_orbit(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (4, ..., 4): the D2 orbit q·f."""
    return torch.stack([_right_multiply(q, f) for f in SQ_FLIP_QUATS])


def _swap_sizes(a: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1], a[..., 0], a[..., 2]], dim=-1)


def param_gauge_orbit(p: torch.Tensor) -> torch.Tensor:
    """(..., 12) -> (8, ..., 12): every equivalent decomposition of the
    same superquadric. Elements 0-3 are the D2 flips; 4-7 compose a
    z quarter-turn with the a1 <-> a2 swap."""
    a, e, t, q = geometry.split_params(p)
    a_sw = _swap_sizes(a)

    def variant(g, a_v):
        return torch.cat([a_v, e, t, _right_multiply(q, g)], dim=-1)

    return torch.stack([variant(g, a) for g in SQ_FLIP_QUATS]
                       + [variant(g, a_sw) for g in SQ_GAUGE_QUATS_SWAP])


def canonicalize_gauge(p: torch.Tensor) -> torch.Tensor:
    """Re-express params in the canonical gauge a1 >= a2: where a1 < a2,
    swap the two sizes and right-multiply q by Rz(+90°)."""
    a, e, t, q = geometry.split_params(p)
    swap = (a[..., 0] < a[..., 1])[..., None]
    q_sw = _right_multiply(q, SQ_GAUGE_QUATS_SWAP[0])
    return torch.cat([torch.where(swap, _swap_sizes(a), a), e, t,
                      torch.where(swap, q_sw, q)], dim=-1)
