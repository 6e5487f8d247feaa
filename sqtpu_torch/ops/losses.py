"""Losses and the superquadric's gauge group, in PyTorch.

Counterpart of ``sqtpu/ops/losses.py``: the explicit occupancy-grid MSE
(:49-79), the implicit (self-supervised) depth loss (:38-43, :87-106), the
least-squares Solina-Bajcsy energy (:114-148), the quaternion and
gauge-aware supervised losses (:155-318), the plain parameter MSE and MAE
(:325-345) and the 2019 Keras losses (:351-414). Gradients are torch
autograd's; these are the plain versions the kernels K1/K2 and K4/K5 are
held against.
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


def occupancy_explicit(p: torch.Tensor, render_size: int,
                       sharp: float = 5.0) -> torch.Tensor:
    """sigmoid(sharp·(1 − F)) of a (B, 12) batch on the (N+1)³ explicit
    lattice (coordinates k/N, the zero nudged to 1e-4), params clamped:
    (B, N+1, N+1, N+1). The reference fixes sharp at 5."""
    ax = geometry.make_axis(render_size, "explicit", dtype=p.dtype,
                            device=p.device)
    f = geometry.field_grid(ax, ax, ax, geometry.clamp_params(p), guard=True)
    return torch.sigmoid(sharp * (1.0 - f))


def explicit_loss(true_p: torch.Tensor, pred_p: torch.Tensor,
                  render_size: int = 32, reduce: bool = True,
                  sharp: float = 5.0) -> torch.Tensor:
    """Occupancy-grid MSE ×100 over the (N+1)³ lattice (the reference's
    ×100 gradient scale is kept). The plain PyTorch version of the kernels
    K4 and K5 (``sqtpu_torch/csrc/explicit.cu``), differentiable in both
    arguments."""
    occ_t = occupancy_explicit(true_p, render_size, sharp)
    occ_p = occupancy_explicit(pred_p, render_size, sharp)
    per_sample = torch.mean((occ_t - occ_p) ** 2, dim=(1, 2, 3)) * 100.0
    return torch.mean(per_sample) if reduce else per_sample


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


def lattice_points(small: torch.Tensor) -> torch.Tensor:
    """(..., N, N) depth maps -> (..., N², 3) points: pixel (row, col)
    lifts to (col/N, 1 − row/N, depth), the reference's (y, 1−x, z)
    (``classes.py:358-369``)."""
    n = small.shape[-1]
    ax = torch.arange(n, dtype=small.dtype, device=small.device) / n
    cols = ax[None, :].expand(n, n)
    rows = (1.0 - ax)[:, None].expand(n, n)
    return torch.stack([cols.expand_as(small), rows.expand_as(small),
                        small], dim=-1).reshape(small.shape[:-2] + (-1, 3))


def least_squares_loss(true_img: torch.Tensor, pred_p: torch.Tensor,
                       render_size: int = 64,
                       reduce: bool = True) -> torch.Tensor:
    """Σ over the depth image's points of (√(a1a2a3)·(F^e1 − 1))²: every
    pixel of the image resized to ``render_size`` is a point, masked to
    the nonzero ones (the reference's ragged point list, static
    shapes)."""
    img = _as_bhw(true_img).to(pred_p.dtype)
    small = nearest_resize(img, (render_size, render_size))
    pts = lattice_points(small)                               # (B, N², 3)
    mask = (small > 0).reshape(small.shape[0], -1)
    pp = geometry.clamp_params(pred_p)
    f = geometry.field_points(pts, pp, guard=True)
    a = pp[..., geometry.SIZE_SLICE]
    scale = torch.sqrt(a[..., 0] * a[..., 1] * a[..., 2])[..., None]
    per_sample = torch.sum((scale * (f - 1.0)) ** 2 * mask, dim=-1)
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

# The whole D4 gauge group, the flips first.
SQ_GAUGE_QUATS = SQ_FLIP_QUATS + SQ_GAUGE_QUATS_SWAP

_gauge_tables: dict = {}


def gauge_table(q: torch.Tensor) -> torch.Tensor:
    """(8, 4) :data:`SQ_GAUGE_QUATS` in ``q``'s dtype on its device,
    converted as ``q.new_tensor`` converts them, made once for each
    device and dtype: a copy from pageable host memory at every call
    would hold the host until the card's queue drains. Made outside
    inference mode, so that a training step may save it for backward
    after an evaluation made it."""
    key = (q.device, q.dtype)
    if key not in _gauge_tables:
        with torch.inference_mode(False):
            _gauge_tables[key] = torch.tensor(SQ_GAUGE_QUATS, dtype=q.dtype,
                                              device=q.device)
    return _gauge_tables[key]


def _right_multiply(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """q·g for a row ``g`` of :func:`gauge_table`."""
    return quat.multiply(q, g.expand_as(q))


def _flip_orbit(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (4, ..., 4): the D2 orbit q·f."""
    flips = gauge_table(q)[:len(SQ_FLIP_QUATS)]
    return torch.stack([_right_multiply(q, f) for f in flips])


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

    n_flips = len(SQ_FLIP_QUATS)
    return torch.stack([variant(g, a if k < n_flips else a_sw)
                        for k, g in enumerate(gauge_table(q))])


def quaternion_loss(q_pred: torch.Tensor, q_true: torch.Tensor,
                    reduce: bool = True) -> torch.Tensor:
    """θ = 1 − 2·|0.5 − ⟨q̂, q⟩²|, the reference's antipodal-symmetric
    quaternion distance."""
    dot = torch.sum(q_true * q_pred, dim=-1)
    theta = 1.0 - 2.0 * torch.abs(0.5 - dot ** 2)
    return torch.mean(theta) if reduce else theta


def quaternion_loss_sym(q_pred: torch.Tensor, q_true: torch.Tensor,
                        reduce: bool = True) -> torch.Tensor:
    """min over the D2 orbit q·f of 1 − ⟨q̂, q·f⟩²: the rotation target is
    defined only up to the superquadric's 180° principal-axis flips."""
    dots = torch.sum(_flip_orbit(q_true) * q_pred[None], dim=-1)
    theta = torch.min(1.0 - dots ** 2, dim=0).values
    return torch.mean(theta) if reduce else theta


def param_gauge_loss(pred: torch.Tensor, labels: torch.Tensor,
                     reduce: bool = True) -> torch.Tensor:
    """min over the 8-element D4 gauge orbit of the labels of the
    size/shape/position MSE plus the antipodal quaternion distance."""
    orbit = param_gauge_orbit(labels[..., :12])           # (8, ..., 12)
    block = torch.mean((pred[None, ..., :8] - orbit[..., :8]) ** 2, dim=-1)
    dots = torch.sum(orbit[..., 8:12] * pred[None, ..., 8:12], dim=-1)
    per = torch.min(block + (1.0 - dots ** 2), dim=0).values
    return torch.mean(per) if reduce else per


def rotation_moment_loss(q_pred: torch.Tensor, p_true: torch.Tensor,
                         reduce: bool = True) -> torch.Tensor:
    """Squared distance of the normalized second-moment orientation
    matrices R·diag(σ²)·Rᵀ of the predicted and the true rotation, with σ²
    from the true shape's analytic inertia: invariant under the D2 flips,
    and blind to rotations the shape cannot show."""
    q_t = geometry.split_params(p_true).q
    inert = geometry.inertia(p_true)                        # (..., 3)
    vs = torch.sum(inert, -1, keepdim=True) / 2.0 - inert    # V·σ² per axis
    u = vs / torch.sum(vs, -1, keepdim=True)

    def second_moment(q):
        rot = quat.to_matrix(q)
        return torch.einsum("...ik,...k,...jk->...ij", rot, u, rot)

    d = second_moment(q_pred) - second_moment(q_t)
    per = torch.sum(d * d, dim=(-2, -1))
    return torch.mean(per) if reduce else per


def param_mse(pred: torch.Tensor, true: torch.Tensor, reduce: bool = True,
              col_weight: torch.Tensor | None = None) -> torch.Tensor:
    """Label-space MSE; ``reduce=False`` gives the per-sample mean over the
    parameter axis, ``col_weight`` (broadcast to the last axis) re-weights
    the parameter columns."""
    sq = (pred - true) ** 2
    if col_weight is not None:
        sq = sq * col_weight
    per = torch.mean(sq, dim=-1)
    return torch.mean(per) if reduce else per


def canonicalize_gauge(p: torch.Tensor) -> torch.Tensor:
    """Re-express params in the canonical gauge a1 >= a2: where a1 < a2,
    swap the two sizes and right-multiply q by Rz(+90°)."""
    a, e, t, q = geometry.split_params(p)
    swap = (a[..., 0] < a[..., 1])[..., None]
    q_sw = _right_multiply(q, gauge_table(q)[len(SQ_FLIP_QUATS)])  # Rz(+90)
    return torch.cat([torch.where(swap, _swap_sizes(a), a), e, t,
                      torch.where(swap, q_sw, q)], dim=-1)


def param_mae(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - true))


# ---------------------------------------------------------------------------
# The 2019 TF "chamfer" loss (an occupancy-field MSE in world units)
# ---------------------------------------------------------------------------

def torch_to_keras_norm(p: torch.Tensor) -> torch.Tensor:
    """A torch-convention 12-vector (a/255, e, t/255, q) in the Keras
    convention ((a − 25)/50, e, t/255, q; quirk Q10): only the sizes
    change, a_k = (255·a_t − 25)/50."""
    return torch.cat([p[..., 0:3] * 5.1 - 0.5, p[..., 3:]], dim=-1)


def _keras_field(p: torch.Tensor, size: int = 64) -> torch.Tensor:
    """The 2019 TF inside-outside variant of a (B, 12) batch on the
    world-unit grid arange(−size/2, size/2)³: (B, size, size, size).
    Params map a -> 12.5a + 6.25, t -> 64t − 32; the rotation is not
    conjugated and t is rotated by q; |x|^(2/e) powers and no final ^e1.
    E = (A + B)^(e2/e1) is taken in log space with the exponent capped at
    80, so it stays finite (≤ exp(80)) where the direct power overflows
    float32 and poisons the gradient with inf·0."""
    ax = torch.arange(-(size // 2), size // 2, dtype=p.dtype, device=p.device)
    a, e, t, q = geometry.split_params(p)
    a = a * 12.5 + 6.25
    t = t * 64.0 - 32.0
    rot = quat.to_matrix(q)
    tr = quat.rotate(t, q)
    X, Y, Z = ax[:, None, None], ax[None, :, None], ax[None, None, :]

    def s(v):  # a per-sample scalar, broadcast over the grid
        return v[:, None, None, None]

    def coord(i):
        return (s(rot[:, i, 0]) * X + s(rot[:, i, 1]) * Y
                + s(rot[:, i, 2]) * Z - s(tr[:, i])) / s(a[:, i])

    x, y, z = coord(0), coord(1), coord(2)
    A = torch.abs(x) ** (2.0 / s(e[:, 1]))
    B = torch.abs(y) ** (2.0 / s(e[:, 1]))
    C = torch.abs(z) ** (2.0 / s(e[:, 0]))
    log_d = torch.log(torch.clamp(A + B, min=1e-30))
    E = torch.exp(torch.clamp((s(e[:, 1]) / s(e[:, 0])) * log_d, max=80.0))
    return E + C


def keras_occupancy_mse(true_p: torch.Tensor, pred_p: torch.Tensor,
                        size: int = 64, clip: float = 0.0) -> torch.Tensor:
    """The 2019 ``chamfer_loss`` (an occupancy-field MSE despite its name,
    quirk Q9), batched. ``clip > 0`` caps both fields at that value first:
    uncapped, the float32 field's square overflows at e = 0.1; the cap
    keeps the signal around the surface band F = 1. 0 is the reference's
    uncapped loss."""
    f_t = _keras_field(true_p, size)
    f_p = _keras_field(pred_p, size)
    if clip > 0:
        f_t = torch.clamp(f_t, max=clip)
        f_p = torch.clamp(f_p, max=clip)
    return torch.mean((f_t - f_p) ** 2)


def keras_quaternion_loss(q_true: torch.Tensor,
                          q_pred: torch.Tensor) -> torch.Tensor:
    """Euclidean quaternion distance, per sample."""
    return torch.sqrt(torch.sum((q_true - q_pred) ** 2, dim=-1))
