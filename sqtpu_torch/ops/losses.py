"""Losses and the superquadric's gauge group, in PyTorch.

Counterpart of ``sqtpu/ops/losses.py``: the implicit (self-supervised)
depth loss (:38-43, :87-106) and the gauge part (:166-270). The other
losses belong to later slices (ROADMAP.md Slices B and D).
"""

from __future__ import annotations

import torch

from sqtpu_torch.ops import geometry
from sqtpu_torch.ops import quaternion as quat
from sqtpu_torch.ops.image import nearest_resize
from sqtpu_torch.ops.render import render_depth_soft_batch

def _as_bhw(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W) or (B, 1, H, W) images -> (B, H, W)."""
    if img.ndim == 4:
        return img[:, 0]
    return img


def implicit_loss(true_img: torch.Tensor, pred_p: torch.Tensor,
                  render_size: int = 64, tau: float = 1.5,
                  sharpness: float = 260.0,
                  reduce: bool = True) -> torch.Tensor:
    """MAE between the soft depth render of ``pred_p`` and the input image,
    nearest-downsampled to the render size (self-supervised: labels never
    enter). The plain PyTorch version of the kernels K1 and K2
    (``sqtpu_torch/csrc/implicit.cu``); its gradient is torch autograd's.
    """
    img = _as_bhw(true_img).to(pred_p.dtype)
    img_small = nearest_resize(img, (render_size, render_size))
    depth = render_depth_soft_batch(pred_p, render_size, tau, sharpness)
    per_sample = torch.mean(torch.abs(img_small - depth), dim=(1, 2))
    return torch.mean(per_sample) if reduce else per_sample


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
