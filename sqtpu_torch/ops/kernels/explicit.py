"""The explicit loss's fused value and gradient, and its loss alone, as
hand-written CUDA kernels.

Counterpart of ``sqtpu/ops/kernels/explicit.py``: K4 replaces the Pallas
TPU kernel ``_fused_kernel`` (launched by ``_fused_call``), K5 replaces
``_fwd_kernel`` (launched by ``_fwd_call``). Their source is
``sqtpu_torch/csrc/explicit.cu``, which shares the field and its gradient
chain with the implicit-loss kernels (``csrc/sq_field.cuh``); it is built
with ``nvcc`` at first use and called through ``ctypes``.

Per sample, both kernels sweep the (N+1)³ explicit lattice (coordinates
k/N, index 0 nudged to 1e-4) plane by plane over the sample's z window and
sum (occ_t − occ_p)² with occ = sigmoid(sharp·(1 − F)). Under
differentiation K4 returns, from the same sweep, the gradient of that sum
with respect to pred's 17 frame scalars; the backward only scales it by
the upstream cotangent. Where nothing is differentiated (validation,
evaluation), K5 computes the sum alone. The true side gets no gradient:
labels are constants in every consumer, as the JAX kernel's contract says
(use :func:`sqtpu_torch.ops.losses.explicit_loss` for d/d true).

The torch side is the JAX wrapper's, step for step: the clamp, R(q*) and
R(q*)·t of both sides (``sq_field.frame_params``, shared with the implicit
wrapper) stay in torch autograd around a ``torch.autograd.Function``; the
window (:func:`z_window_indices`) is the union of both clamped shapes'
z-support boxes ± ``z_margin`` and carries no gradient; the per-sample sums
are scaled by 100/(N+1)³. The JAX wrapper cuts the batch into chunks of
256 and tiles several samples per program, limits of the TPU's memories;
the CUDA kernels take the whole batch in one launch. The JAX wrapper sends
N < 8 to XLA; the CUDA kernels take every N ≥ 2 or raise.

Beside the kernels, :func:`emulate_fwd` and :func:`emulate_fused` are a
torch emulation of their own algorithm, the analogue of Pallas interpret
mode: one sweep for both, as the kernels share one body, with the
per-sample reciprocals, the body coordinates linear in z and the
exact-zero cull (``csrc/explicit.cu``); K4's adds the 11 running sums a
column of the gradient. It is built from the helpers shared with the
implicit loss's emulation (``sq_field.py``, the counterpart of
``csrc/sq_field.cuh``). The tests hold it against the JAX kernels in
interpret mode and against autograd of the plain loss; on the card the
kernels are held against it. The main path never calls it.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from sqtpu_torch.ops import geometry
from sqtpu_torch.ops import losses
from sqtpu_torch.ops.kernels import _build, sq_field
from sqtpu_torch.ops.kernels.sq_field import (
    N_PAR, PAR_STRIDE, SEP_SUMS, _body_origin, _box_planes, _field_terms_lin,
    _occupancy, _recip, _Recip, _sep_finish, _sep_grad_step, _sweep_setup,
    _zval, box_half_width, check_operands, cull_sound, frame_params,
)

SHARP = 5.0      # the reference's occupancy sharpness
Z_MARGIN = 0.08  # window margin at SHARP, normalized z units


# ---------------------------------------------------------------------------
# The wrapper's torch side (sqtpu/ops/kernels/explicit.py:290-363)
# ---------------------------------------------------------------------------

def default_margin(sharp: float) -> float:
    """The window margin for this sharpness: the skipped tails decay like
    exp(−sharp·(F − 1)), so a sharper occupancy needs less."""
    return max(Z_MARGIN * SHARP / sharp, 0.02)


def z_window_indices(true_p: torch.Tensor, pred_p: torch.Tensor, n: int,
                     margin: float = Z_MARGIN):
    """Per-sample lattice window [j_lo, j_hi] on the explicit axis (z_j =
    j/N) covering the union of both clamped superquadrics' z-support boxes
    ± ``margin``, as float32 indices with no gradient."""
    return sq_field.z_window([true_p.to(torch.float32),
                              pred_p.to(torch.float32)], n, margin)


def pack_params(true_p: torch.Tensor, pred_p: torch.Tensor, n: int,
                z_window: bool = True, z_margin: float = Z_MARGIN):
    """(B, 12) true and predicted params -> the kernels' two (B, 24) rows:
    the frame scalars of each, with pred's window (or the full sweep
    [0, N]) in slots 17-18. The true row carries no gradient; pred's is
    differentiable in the frame scalars."""
    par_t = frame_params(true_p.detach()).contiguous()
    window = (z_window_indices(true_p, pred_p, n, z_margin) if z_window
              else None)
    return par_t, sq_field.pack_row(pred_p, n, window)


# ---------------------------------------------------------------------------
# The emulation of the kernels' algorithm (the analogue of interpret mode)
# ---------------------------------------------------------------------------

class _Columns(NamedTuple):
    X: torch.Tensor       # (B, (N+1)²) column coordinates
    Y: torch.Tensor
    inv: float
    kt: _Recip
    kp: _Recip
    origin_t: list        # u, v, w at z = 0, each (B, (N+1)²)
    origin_p: list
    j0: torch.Tensor      # (B, (N+1)²) the planes each column sweeps
    j1: torch.Tensor


def _columns(par_t: torch.Tensor, par_p: torch.Tensor, n: int,
             sharp: float, cull: bool) -> _Columns:
    """The kernels' per-sample constants, per-column body origins and
    planes: the sample's window [j_lo, j_hi], cut by the exact-zero cull to
    the hull of both shapes' boxes where the rows prove it sound. The
    explicit lattice is the implicit one with N+1 points a side (spacing
    1/N)."""
    sw = _sweep_setup(par_p, n + 1, n + 1)
    kt, kp = _recip(par_t), _recip(par_p)
    ot = _body_origin(par_t, kt, sw.X, sw.Y)
    op = _body_origin(par_p, kp, sw.X, sw.Y)
    j0, j1 = sw.lo.expand_as(sw.X), sw.hi.expand_as(sw.X)
    if cull:
        bb = box_half_width(sharp, par_p.dtype).to(par_p.device)
        jt0, jt1 = _box_planes(kt, ot, bb, n)
        jp0, jp1 = _box_planes(kp, op, bb, n)
        on = ((cull_sound(par_t) & cull_sound(par_p))[:, None]
              & (0.0 < sharp < math.inf))
        j0 = torch.where(on, torch.maximum(j0, torch.minimum(jt0, jp0)), j0)
        j1 = torch.where(on, torch.minimum(j1, torch.maximum(jt1, jp1)), j1)
    return _Columns(sw.X, sw.Y, sw.inv, kt, kp, ot, op, j0, j1)


def _sweep(par_t: torch.Tensor, par_p: torch.Tensor, n: int, sharp: float,
           cull: bool, grad: bool):
    """The kernels' one body: the (B,) sums of (occ_t − occ_p)² over each
    column's planes and, with ``grad``, the (B, 24) gradient of each sum
    with respect to pred's frame scalars (slots 17-23 zero)."""
    col = _columns(par_t, par_p, n, sharp, cull)
    kt, kp = col.kt, col.kp
    total = torch.zeros_like(col.X)
    acc = {k: torch.zeros_like(col.X) for k in SEP_SUMS}
    lo = int(col.j0.min()) if col.j0.numel() else 0
    for j in range(lo, int(col.j1.max()) + 1):
        active = (col.j0 <= j) & (j <= col.j1)
        z = _zval(j, col.inv, par_p)
        occ_t = _occupancy(_field_terms_lin(
            kt, *[o + c * z for o, c in zip(col.origin_t, kt.c)])["F"],
            sharp)
        T = _field_terms_lin(kp, *[o + c * z for o, c in zip(col.origin_p,
                                                             kp.c)])
        occ_p = _occupancy(T["F"], sharp)
        d = occ_t - occ_p
        total = total + torch.where(active, d * d, 0.0)
        if grad:
            gF = 2.0 * d * sharp * occ_p * (1.0 - occ_p)
            _sep_grad_step(acc, T, gF, kp, z, active)
    sums = total.sum(dim=-1)
    if not grad:
        return sums
    dpar = torch.zeros_like(par_p)
    dpar[:, :N_PAR] = torch.stack(
        [t.sum(dim=-1) for t in _sep_finish(acc, kp, col.X, col.Y)], dim=-1)
    return sums, dpar


def emulate_fwd(par_t: torch.Tensor, par_p: torch.Tensor, n: int,
                sharp: float, cull: bool = True) -> torch.Tensor:
    """K5's algorithm in torch: two (B, 24) rows -> the (B,) sums of
    (occ_t − occ_p)² over each sample's window, in the rows' dtype; the
    sums of :func:`emulate_fused`, bit for bit. ``cull=False`` sweeps each
    sample's whole window with the same arithmetic."""
    return _sweep(par_t, par_p, n, sharp, cull, grad=False)


def emulate_fused(par_t: torch.Tensor, par_p: torch.Tensor, n: int,
                  sharp: float, cull: bool = True):
    """K4's algorithm in torch: -> the (B,) sums and the (B, 24) gradient
    of each sum with respect to pred's frame scalars (slots 17-23 zero).
    ``cull=False`` sweeps each sample's whole window with the same
    arithmetic (the cull skips only points that add exactly 0)."""
    return _sweep(par_t, par_p, n, sharp, cull, grad=True)


def cull_points(par_t: torch.Tensor, par_p: torch.Tensor, n: int,
                sharp: float) -> int:
    """Lattice points K4 and K5 evaluate after the exact-zero cull: Σ over
    the columns of the planes each sweeps (counted by the emulation)."""
    col = _columns(par_t, par_p, n, sharp, True)
    return int((col.j1 - col.j0 + 1).clamp(min=0).sum())


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def cuda_fwd(par_t: torch.Tensor, par_p: torch.Tensor, n: int,
             sharp: float) -> torch.Tensor:
    """K5 on the card: same contract as :func:`emulate_fwd`."""
    sums = _launch_fwd(par_t, par_p, n, sharp)
    _build.count("K5")
    return sums


def cuda_fused(par_t: torch.Tensor, par_p: torch.Tensor, n: int,
               sharp: float):
    """K4 on the card: same contract as :func:`emulate_fused`."""
    out = _launch_fused(par_t, par_p, n, sharp)
    _build.count("K4")
    return out


def _launch_fwd(par_t: torch.Tensor, par_p: torch.Tensor, n: int,
                sharp: float, lib: ctypes.CDLL | None = None):
    """K5 of ``lib`` (default: this package's) on the card."""
    check_operands(n, n, {"pred params": par_p, "true params": par_t})
    lib = _build.library("explicit") if lib is None else lib
    b = par_p.shape[0]
    blocks = lib.sqtpu_explicit_blocks(n)
    partial = torch.empty((b, blocks), dtype=torch.float32,
                          device=par_p.device)
    sums = torch.empty((b,), dtype=torch.float32, device=par_p.device)
    _build.launch(lib, "sqtpu_explicit_fwd", par_p.device, par_t.data_ptr(),
                  par_p.data_ptr(), partial.data_ptr(), sums.data_ptr(), b,
                  n, float(sharp), what="explicit loss (K5)")
    return sums


def _launch_fused(par_t: torch.Tensor, par_p: torch.Tensor, n: int,
                  sharp: float, lib: ctypes.CDLL | None = None):
    """K4 of ``lib`` (default: this package's) on the card."""
    check_operands(n, n, {"pred params": par_p, "true params": par_t})
    lib = _build.library("explicit") if lib is None else lib
    b = par_p.shape[0]
    blocks = lib.sqtpu_explicit_fused_blocks(n)
    dev = par_p.device
    partial_sum = torch.empty((b, blocks), dtype=torch.float32, device=dev)
    partial_grad = torch.empty((b, blocks, N_PAR), dtype=torch.float32,
                               device=dev)
    sums = torch.empty((b,), dtype=torch.float32, device=dev)
    dpar = torch.empty((b, PAR_STRIDE), dtype=torch.float32, device=dev)
    _build.launch(lib, "sqtpu_explicit_fused", dev, par_t.data_ptr(),
                  par_p.data_ptr(), partial_sum.data_ptr(),
                  partial_grad.data_ptr(), sums.data_ptr(), dpar.data_ptr(),
                  b, n, float(sharp),
                  what="explicit loss value and gradient (K4)")
    return sums, dpar


class _Impl(NamedTuple):
    fwd: object
    fused: object


CUDA = _Impl(cuda_fwd, cuda_fused)
EMULATION = _Impl(emulate_fwd, emulate_fused)


class _ExplicitCore(torch.autograd.Function):
    """Per-sample sums with the gradient from the same sweep: the
    ``custom_vjp`` ``_core`` of the JAX package (:268-287), differentiated
    path. The true row gets no gradient."""

    @staticmethod
    def forward(ctx, par_t, par_p, n, sharp, impl):
        sums, dpar = impl.fused(par_t, par_p, n, sharp)
        ctx.save_for_backward(dpar)
        return sums

    @staticmethod
    def backward(ctx, g):
        (dpar,) = ctx.saved_tensors
        return None, g[:, None] * dpar, None, None, None


def _check_inputs(true_p: torch.Tensor, pred_p: torch.Tensor, n: int) -> None:
    if pred_p.ndim != 2 or pred_p.shape[-1] != geometry.N_PARAMS \
            or true_p.shape != pred_p.shape:
        raise ValueError(f"true and pred params must both be (B, 12), got "
                         f"{tuple(true_p.shape)} and {tuple(pred_p.shape)}")
    if n < 2:
        raise ValueError(f"render size must be >= 2, got {n}")


def _sweep_loss(impl: _Impl, true_p, pred_p, n, reduce, z_window, z_margin,
                sharp):
    sharp = float(sharp)
    if z_margin is None:
        z_margin = default_margin(sharp)
    par_t, par_p = pack_params(true_p, pred_p, n, z_window, z_margin)
    # Inside Function.forward grad mode is always off, so the choice of
    # the loss-only kernel is made here.
    if torch.is_grad_enabled() and pred_p.requires_grad:
        sums = _ExplicitCore.apply(par_t, par_p, n, sharp, impl)
    else:
        sums = impl.fwd(par_t, par_p.detach(), n, sharp)
    per_sample = sums * (100.0 / (n + 1) ** 3)  # mean over (N+1)³, ×100
    return torch.mean(per_sample) if reduce else per_sample


def explicit_loss_cuda(true_p: torch.Tensor, pred_p: torch.Tensor,
                       render_size: int = 32, reduce: bool = True,
                       z_window: bool = True, z_margin: float | None = None,
                       sharp: float = SHARP) -> torch.Tensor:
    """The explicit loss through K4 (value and pred gradient) or K5 (value
    alone, when nothing is differentiated) for CUDA float32 params; the
    plain :func:`sqtpu_torch.ops.losses.explicit_loss` for CPU tensors
    (which, like the JAX package's XLA path, sweeps the full lattice and
    differentiates both sides). ``z_window=True`` sweeps only each
    sample's window ± ``z_margin`` (None: :func:`default_margin`);
    ``z_window=False`` sweeps all N+1 planes. On a CUDA tensor it launches
    the kernels or raises."""
    _check_inputs(true_p, pred_p, render_size)
    if pred_p.device.type == "cpu":
        return losses.explicit_loss(true_p, pred_p, render_size, reduce,
                                    sharp)
    if pred_p.device.type != "cuda":
        raise ValueError(f"no kernel for device {pred_p.device}")
    if pred_p.dtype != torch.float32 or true_p.dtype != torch.float32:
        raise TypeError(f"the explicit-loss kernels take float32 params, "
                        f"got {true_p.dtype} and {pred_p.dtype}")
    if true_p.device != pred_p.device:
        raise ValueError(f"true params on {true_p.device}, pred params on "
                         f"{pred_p.device}")
    return _sweep_loss(CUDA, true_p, pred_p, render_size, reduce, z_window,
                       z_margin, sharp)


def explicit_loss_emulated(true_p: torch.Tensor, pred_p: torch.Tensor,
                           render_size: int = 32, reduce: bool = True,
                           z_window: bool = True,
                           z_margin: float | None = None,
                           sharp: float = SHARP) -> torch.Tensor:
    """The same loss through the torch emulation of K4 and K5, on any
    device, in ``pred_p``'s floating dtype."""
    _check_inputs(true_p, pred_p, render_size)
    return _sweep_loss(EMULATION, true_p.to(pred_p.dtype), pred_p,
                       render_size, reduce, z_window, z_margin, sharp)


def window_points(par_p: torch.Tensor, n: int) -> int:
    """In-window (x, y, z) lattice points the kernels visit for these
    packed pred params: Σ_b (j_hi − j_lo + 1) · (N+1)²."""
    return sq_field.window_points(par_p, (n + 1) ** 2)
