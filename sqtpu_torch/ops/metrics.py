"""Evaluation metrics: voxel IoU, the IoU tuple and rotation errors.

Counterpart of ``sqtpu/ops/metrics.py`` (:25-138). The IoU applies no
parameter clamp and no zero guard, as in the reference. On CPU tensors
the counts come from plain torch occupancy grids; CUDA tensors go to the
voxel IoU kernel K7 (:mod:`sqtpu_torch.ops.kernels.voxel_iou`), which
launches or raises and gives the same counts with no grid in memory.
``iou_full`` is a span, and so are the occupancy grids or the K7 launch
(``metrics.voxels``; :mod:`sqtpu_torch.utils.profiling`).
"""

from __future__ import annotations

import math

import torch

from sqtpu_torch.ops import geometry
from sqtpu_torch.ops import quaternion as quat
from sqtpu_torch.ops.kernels import voxel_iou
from sqtpu_torch.ops.losses import _flip_orbit, param_gauge_orbit
from sqtpu_torch.utils.profiling import span

# Samples whose voxel grids are built at once: bounds the working set to
# a few (chunk, N, N, N) fp32 grids (0.5 GB each at N = 128).
_IOU_CHUNK = 16
# iou_full's three pairs of its five fields (full_fields): rot-isolated,
# full, gauge-aligned rot-isolated.
FULL_PAIRS = ((0, 1), (0, 2), (3, 4))


def _binary_voxels(p: torch.Tensor, render_size: int) -> torch.Tensor:
    """(B, N, N, N) occupancies F^(e1) <= 1, no clamp, no guard; the span
    ``metrics.voxels``."""
    with span("metrics.voxels"):
        ax = geometry.make_axis(render_size, "iou", dtype=p.dtype,
                                device=p.device)
        return geometry.field_grid(ax, ax, ax, p, guard=False) <= 1.0


def _k7_counts(fields, pairs, render_size: int) -> torch.Tensor:
    """K7's (B, P, 2) counts; the span ``metrics.voxels``."""
    with span("metrics.voxels"):
        return voxel_iou.voxel_iou_cuda(fields, pairs, render_size)


def iou_counts(true_p: torch.Tensor, pred_p: torch.Tensor,
               render_size: int = 64):
    """Per-sample voxel counts of the intersection and the union, (B,)
    int64 each: plain grids on the CPU, K7 on the card."""
    if true_p.device.type == "cpu":
        return plain_iou_counts(true_p, pred_p, render_size)
    counts = _k7_counts((true_p, pred_p), ((0, 1),), render_size)
    return counts[:, 0, 0], counts[:, 0, 1]


def plain_iou_counts(true_p: torch.Tensor, pred_p: torch.Tensor,
                     render_size: int = 64):
    """:func:`iou_counts` from plain occupancy grids on any device: the
    CPU's path, and K7's yardstick on the card."""
    inter, union = [], []
    for lo in range(0, true_p.shape[0], _IOU_CHUNK):
        a = _binary_voxels(true_p[lo:lo + _IOU_CHUNK], render_size)
        b = _binary_voxels(pred_p[lo:lo + _IOU_CHUNK], render_size)
        inter.append((a & b).sum(dim=(1, 2, 3)))
        union.append((a | b).sum(dim=(1, 2, 3)))
    return torch.cat(inter), torch.cat(union)


def iou(true_p: torch.Tensor, pred_p: torch.Tensor, render_size: int = 64,
        reduce: bool = True) -> torch.Tensor:
    """Voxel IoU. ``reduce`` pools intersection and union over the batch;
    otherwise per-sample IoUs (B,)."""
    inter, union = iou_counts(true_p, pred_p, render_size)
    if reduce:
        return inter.sum().to(true_p.dtype) / union.sum().to(true_p.dtype)
    return inter.to(true_p.dtype) / union.to(true_p.dtype)


def angle_error(q_true: torch.Tensor, q_pred: torch.Tensor) -> torch.Tensor:
    """Rotation angle between two unit quaternions, radians in [0, π]."""
    dq = quat.multiply(q_true, quat.conjugate(q_pred))
    ang = torch.abs(quat.to_magnitude(dq))
    return torch.minimum(ang, 2.0 * math.pi - ang)


def angle_error_sym(q_true: torch.Tensor,
                    q_pred: torch.Tensor) -> torch.Tensor:
    """Rotation angle modulo the D2 symmetry: min over {q_true·f}."""
    orbit = _flip_orbit(q_true)  # (4, ..., 4)
    return angle_error(orbit, q_pred[None].expand_as(orbit)).amin(dim=0)


def gauge_align(true_p: torch.Tensor, pred_p: torch.Tensor):
    """Per sample, the D4-gauge representative of the true decomposition
    closest to the prediction (size MSE + antipodal quaternion distance).
    Returns ``(aligned_true, swapped)``; ``swapped`` flags a1 <-> a2."""
    orbit = param_gauge_orbit(true_p)                       # (8, B, 12)
    block = torch.mean((pred_p[None, ..., :3] - orbit[..., :3]) ** 2,
                       dim=-1)
    dots = torch.sum(orbit[..., 8:12] * pred_p[None, ..., 8:12], dim=-1)
    gi = torch.argmin(block + (1.0 - dots ** 2), dim=0)    # (B,)
    idx = gi[None, ..., None].expand((1,) + orbit.shape[1:])
    aligned = torch.gather(orbit, 0, idx)[0]
    return aligned, gi >= 4


def angle_error_gauge(true_p: torch.Tensor,
                      pred_p: torch.Tensor) -> torch.Tensor:
    """Rotation angle against the gauge-aligned true decomposition."""
    aligned, _ = gauge_align(true_p, pred_p)
    return angle_error(aligned[..., 8:12], pred_p[..., 8:12])


def full_fields(true_p: torch.Tensor, pred_p: torch.Tensor):
    """``iou_full``'s five parameter sets (true, rot_only, pred, aligned,
    rot_only_g), whose pairs :data:`FULL_PAIRS` it scores, and the gauge
    swap flags."""
    a_t, e_t, t_t, _ = geometry.split_params(true_p)
    q_p = pred_p[..., 8:12]
    rot_only = torch.cat([a_t, e_t, t_t, q_p], dim=-1)
    aligned, swapped = gauge_align(true_p, pred_p)
    rot_only_g = torch.cat([aligned[..., :8], q_p], dim=-1)
    return (true_p, rot_only, pred_p, aligned, rot_only_g), swapped


def iou_full(true_p: torch.Tensor, pred_p: torch.Tensor,
             render_size: int = 64) -> torch.Tensor:
    """(B, 7) per sample: [rot-isolated IoU, full IoU, angle, sym-angle,
    gauge-angle, gauge rot-IoU, gauge-swapped flag]; see the JAX
    package's ``iou_full`` for what each column isolates. The span
    ``metrics.iou_full``; its occupancy grids, or on the card its one K7
    launch for the three IoUs, ``metrics.voxels``."""
    with span("metrics.iou_full"):
        fields, swapped = full_fields(true_p, pred_p)
        if true_p.device.type == "cpu":
            iou_rot, iou_all, iou_rot_g = (
                iou(fields[f], fields[g], render_size, reduce=False)
                for f, g in FULL_PAIRS)
        else:   # one K7 launch, the truth's field evaluated once
            counts = _k7_counts(fields, FULL_PAIRS, render_size)
            ious = counts[..., 0].to(true_p.dtype) / counts[..., 1].to(
                true_p.dtype)
            iou_rot, iou_all, iou_rot_g = ious.unbind(-1)
        q_t, q_p = true_p[..., 8:12], pred_p[..., 8:12]
        ang = angle_error(q_t, q_p)
        ang_sym = angle_error_sym(q_t, q_p)
        ang_gauge = angle_error(fields[3][..., 8:12], q_p)
        return torch.stack([iou_rot, iou_all, ang, ang_sym, ang_gauge,
                            iou_rot_g, swapped.to(true_p.dtype)], dim=-1)


def param_mae(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    """Per-parameter MAE over the batch, shape (12,)."""
    return torch.mean(torch.abs(pred - true), dim=0)
