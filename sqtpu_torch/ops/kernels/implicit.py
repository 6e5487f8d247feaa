"""The implicit loss's forward and backward as hand-written CUDA kernels.

Counterpart of ``sqtpu/ops/kernels/implicit.py``: K1 replaces the Pallas
TPU kernel ``_fwd_kernel`` (launched by ``_fwd_call``), K2 replaces
``_bwd_kernel`` (launched by ``_bwd_call``). Their source is
``sqtpu_torch/csrc/implicit.cu``; it is built with ``nvcc`` at first use
and called through ``ctypes``.

Per sample, K1 sweeps the N × N_cols plane of (x, y) rays far→near over
the superquadric's z window, with the occupancy sigmoid(sharp·(1 − F)),
the running sum S and the transmittance exp(−τS); planes outside the
window enter in closed form. It returns Σ|img − depth| per sample and the
per-pixel transmittance sum Tacc, the backward's only residual. K2
recomputes S_j and T_j in one far→near sweep, recovers the prefix sums as
W_j = Tacc − V + T_j, and accumulates the gradient of the 17 frame
scalars (a, e, R(q*)·t, R(q*)) and the image cotangent.

The torch side is the JAX wrapper's, step for step: the clamp, R(q*) and
t_rot = R·t (``sq_field.frame_params``) stay in torch autograd around a
``torch.autograd.Function`` (the ``custom_vjp`` of the JAX package), so
clamped-out parameters get zero gradient; the z window
(:func:`z_window_indices`) carries no gradient; the image is resized,
row-flipped and transposed to the (x·n + y) plane, and its gradient flows
back through those steps. The JAX wrapper cuts the batch into chunks of
512 samples, a limit of the TPU's scalar memory; the CUDA kernels take the
whole batch in one launch. They also take every render size n ≥ 2, where
the TPU kernel needs n² to be a multiple of 128.

K6 replaces ``implicit_sums_pallas_slab`` (:543-591), the building block
of the grid-sharded loss: K1 and K2 launched on a slab of image columns,
the plane (x_local·n + y) of ``n_cols < n`` columns with the slab's first
column x0 in slot 19, as on the TPU, where the slab reaches K1's and K2's
own ``pallas_call``. It returns the per-sample partial sums over the slab
(:func:`implicit_sums_slab_cuda`); the grid axis adds them up across
ranks (``sqtpu_torch.parallel.sharded_losses``). Its launches are counted
apart from K1's and K2's.

Beside the kernels, :func:`emulate_fwd` and :func:`emulate_bwd` are a
torch emulation of their own algorithm (same window, closed-form terms,
Tacc residual and analytic backward; per-sample reciprocals, body
coordinates linear in z, 11 running sums a pixel and the exact-zero cull,
from the helpers shared with the explicit loss's emulation in
``sq_field.py``), the analogue of Pallas interpret mode; ``cull=False``
sweeps the whole window with the same arithmetic. The tests hold it
against the JAX kernel in interpret mode and against autograd of the
plain loss; on the card the kernels are held against it. The main path
never calls it.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from sqtpu_torch.ops import geometry
from sqtpu_torch.ops import losses
from sqtpu_torch.ops import render
from sqtpu_torch.ops.image import nearest_resize
from sqtpu_torch.ops.kernels import _build, sq_field
from sqtpu_torch.ops.kernels.sq_field import (
    N_PAR, PAR_STRIDE, SEP_SUMS, _body_origin, _box_planes, _field_terms_lin,
    _occupancy, _recip, _Recip, _sep_finish, _sep_grad_step, _sweep_setup,
    _Sweep, _zval, box_half_width, check_operands, cull_sound,
)

Z_MARGIN = 0.05    # z-window margin, normalized z units


# ---------------------------------------------------------------------------
# The wrapper's torch side (sqtpu/ops/kernels/implicit.py:258-270, 473-540)
# ---------------------------------------------------------------------------

def z_window_indices(pred_p: torch.Tensor, n: int,
                     margin: float = Z_MARGIN):
    """Per-sample lattice window [j_lo, j_hi] on the implicit axis
    (z_j = j/(n−1)) covering the clamped superquadric's z-support box ±
    ``margin``, as float indices with no gradient."""
    return sq_field.z_window([pred_p], n - 1, margin)


def pack_params(pred_p: torch.Tensor, n: int, z_window: bool = True,
                z_margin: float = Z_MARGIN, x0: int = 0) -> torch.Tensor:
    """(B, 12) params -> the kernels' (B, 24) parameters: the frame
    scalars with the z window (or the full sweep [0, n−1]) and the slab's
    x offset in slots 17-19. Differentiable in the frame scalars."""
    window = z_window_indices(pred_p, n, z_margin) if z_window else None
    return sq_field.pack_row(pred_p, n - 1, window, x0)


def image_plane(img: torch.Tensor, n: int, dtype=torch.float32):
    """(B, H, W) or (B, 1, H, W) images -> the kernels' (B, n·n) plane:
    nearest resize to n × n, then :func:`slab_plane`. Differentiable."""
    return slab_plane(nearest_resize(losses._as_bhw(img).to(dtype), (n, n)))


def slab_plane(img_slab: torch.Tensor) -> torch.Tensor:
    """(B, n, n_cols) columns of a resized image (rows top-down) -> the
    kernels' (B, n·n_cols) plane: row flip (y counts from the image
    bottom), then the (x_local·n + y) layout. Differentiable."""
    b, n, n_cols = img_slab.shape
    return torch.flip(img_slab, dims=(-2,)).transpose(-1, -2).reshape(
        b, n * n_cols).contiguous()


# ---------------------------------------------------------------------------
# The emulation of the kernels' algorithm (the analogue of interpret mode)
# ---------------------------------------------------------------------------

class _Rays(NamedTuple):
    sw: _Sweep
    k: _Recip
    origin: list      # u, v, w of each pixel at z = 0, each (B, P)
    a: torch.Tensor   # (B, P) the planes each pixel sweeps, from b down
    b: torch.Tensor   # to a (a = lo, b = lo − 1: none), int64


def _rays(par: torch.Tensor, n: int, n_cols: int, tau: float, sharp: float,
          cull: bool, finite=None) -> _Rays:
    """The kernels' per-sample constants, per-pixel body origins and
    planes: each sample's window [j_lo, j_hi], cut to the frame's box
    (the exact-zero cull) where the row proves it sound, 0 < sharp and 0 ≤
    τ are finite, and ``finite`` (B, P), if given, holds."""
    sw = _sweep_setup(par, n, n_cols)
    k = _recip(par)
    origin = _body_origin(par, k, sw.X, sw.Y)
    lo, hi = sw.lo.expand_as(sw.X), sw.hi.expand_as(sw.X)
    a, b = lo, hi
    if cull and 0.0 < sharp < math.inf and 0.0 <= tau < math.inf:
        bb = box_half_width(sharp, par.dtype).to(par.device)
        j0, j1 = _box_planes(k, origin, bb, n - 1)
        on = cull_sound(par)[:, None].expand_as(sw.X)
        if finite is not None:
            on = on & finite
        a = torch.where(on, torch.maximum(lo, j0), lo)
        b = torch.where(on, torch.minimum(hi, j1), hi)
        empty = a > b
        a, b = torch.where(empty, lo, a), torch.where(empty, lo - 1, b)
    return _Rays(sw, k, origin, a, b)


def _field_at(r: _Rays, z) -> dict:
    return _field_terms_lin(r.k, *[o + c * z for o, c in zip(r.origin,
                                                             r.k.c)])


def emulate_fwd(img_xy: torch.Tensor, par: torch.Tensor, n: int,
                n_cols: int, tau: float, sharp: float, cull: bool = True):
    """K1's algorithm in torch: (B, P) plane, (B, 24) params -> (B,) sums
    of |img − depth| and the (B, P) transmittance sums Tacc; the dtype is
    the params'. Each pixel sweeps the planes of its sample's window
    [j_lo, j_hi] inside the frame's box (the exact-zero cull); the far
    planes outside it add 1 each to t_in as one integer, the near ones
    T_end each, as adds. ``cull=False`` sweeps the whole window with the
    same arithmetic: the cull skips only points of occupancy exactly 0 and
    changes no bit."""
    r = _rays(par, n, n_cols, tau, sharp, cull)
    lo, hi = r.sw.lo.expand_as(r.a), r.sw.hi.expand_as(r.a)
    S = torch.zeros_like(r.sw.X)
    t_in = (hi - r.b).to(par.dtype)  # the far planes: T = 1 each
    for j in range(int(r.b.max()), int(r.a.min()) - 1, -1):
        active = (r.a <= j) & (j <= r.b)
        S_j = S + _occupancy(_field_at(r, _zval(j, r.sw.inv, par))["F"],
                             sharp)
        t_in = torch.where(active, t_in + torch.exp(-tau * S_j), t_in)
        S = torch.where(active, S_j, S)
    t_end = torch.exp(-tau * S)
    for j in range(int(r.a.max()) - 1, int(r.sw.lo.min()) - 1, -1):
        t_in = torch.where((lo <= j) & (j < r.a), t_in + t_end, t_in)
    c_pre = (n - 1) - r.sw.hi.to(par.dtype)
    tacc = c_pre + t_in + r.sw.lo.to(par.dtype) * t_end
    sums = torch.abs(img_xy - (1.0 - tacc / n)).sum(dim=-1)
    return sums, tacc


def emulate_bwd(img_xy: torch.Tensor, par: torch.Tensor, tacc: torch.Tensor,
                g: torch.Tensor, n: int, n_cols: int, tau: float,
                sharp: float, cull: bool = True):
    """K2's algorithm in torch: -> (B, 24) gradient of the frame scalars
    (slots 17-23 zero) and the (B, P) image cotangent, for the upstream
    gradient ``g`` (B,) of the per-sample sums. Each pixel sweeps the
    planes of :func:`emulate_fwd`, with V entering them at c_pre + the far
    planes; a pixel whose φ or Tacc is not finite sweeps its whole window.
    The 17 terms come from 11 running sums a pixel. ``cull=False`` sweeps
    the whole window with the same arithmetic."""
    d = img_xy - (1.0 - tacc / n)
    sgn = torch.where(torch.isnan(d), d, torch.sign(d))  # NaN stays NaN
    g = g[:, None]
    dimg = sgn * g
    phi = -sgn * g * (tau / n)
    r = _rays(par, n, n_cols, tau, sharp, cull,
              torch.isfinite(phi) & torch.isfinite(tacc))
    hi = r.sw.hi.expand_as(r.a)
    acc = {k: torch.zeros_like(r.sw.X) for k in SEP_SUMS}
    S = torch.zeros_like(r.sw.X)
    V = ((n - 1) - hi.to(par.dtype)) + (hi - r.b).to(par.dtype)
    for j in range(int(r.b.max()), int(r.a.min()) - 1, -1):
        active = (r.a <= j) & (j <= r.b)
        z = _zval(j, r.sw.inv, par)
        T = _field_at(r, z)
        occ = _occupancy(T["F"], sharp)
        S_j = S + occ
        T_j = torch.exp(-tau * S_j)
        V_j = V + T_j
        W = tacc - V_j + T_j
        gF = phi * W * (-sharp) * occ * (1.0 - occ)
        _sep_grad_step(acc, T, gF, r.k, z, active)
        S = torch.where(active, S_j, S)
        V = torch.where(active, V_j, V)
    dpar = torch.zeros_like(par)
    dpar[:, :N_PAR] = torch.stack(
        [t.sum(dim=-1) for t in _sep_finish(acc, r.k, r.sw.X, r.sw.Y)],
        dim=-1)
    return dpar, dimg


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _launch_fwd(img_xy: torch.Tensor, par: torch.Tensor, n: int,
                n_cols: int, tau: float, sharp: float, what: str,
                lib: ctypes.CDLL | None = None):
    """K1 of ``lib`` (default: this package's) on the card."""
    check_operands(n, n_cols, {"params": par}, planes=(img_xy,))
    lib = _build.library("implicit") if lib is None else lib
    b = par.shape[0]
    blocks = lib.sqtpu_implicit_blocks(n, n_cols)
    tacc = torch.empty_like(img_xy)
    partial = torch.empty((b, blocks), dtype=torch.float32,
                          device=par.device)
    sums = torch.empty((b,), dtype=torch.float32, device=par.device)
    _build.launch(lib, "sqtpu_implicit_fwd", par.device, par.data_ptr(),
                  img_xy.data_ptr(), tacc.data_ptr(), partial.data_ptr(),
                  sums.data_ptr(), b, n, n_cols, float(tau), float(sharp),
                  what=what)
    return sums, tacc


def _launch_bwd(img_xy: torch.Tensor, par: torch.Tensor, tacc: torch.Tensor,
                g: torch.Tensor, n: int, n_cols: int, tau: float,
                sharp: float, what: str, lib: ctypes.CDLL | None = None):
    """K2 of ``lib`` (default: this package's) on the card."""
    g = g.contiguous()
    check_operands(n, n_cols, {"params": par}, planes=(img_xy, tacc),
                   vectors=(g,))
    lib = _build.library("implicit") if lib is None else lib
    b = par.shape[0]
    blocks = lib.sqtpu_implicit_blocks(n, n_cols)
    dimg = torch.empty_like(img_xy)
    partial = torch.empty((b, blocks, N_PAR), dtype=torch.float32,
                          device=par.device)
    dpar = torch.empty((b, PAR_STRIDE), dtype=torch.float32,
                       device=par.device)
    _build.launch(lib, "sqtpu_implicit_bwd", par.device, par.data_ptr(),
                  g.data_ptr(), img_xy.data_ptr(), tacc.data_ptr(),
                  dimg.data_ptr(), partial.data_ptr(), dpar.data_ptr(), b, n,
                  n_cols, float(tau), float(sharp), what=what)
    return dpar, dimg


def cuda_fwd(img_xy: torch.Tensor, par: torch.Tensor, n: int, n_cols: int,
             tau: float, sharp: float):
    """K1 on the card: same contract as :func:`emulate_fwd`."""
    out = _launch_fwd(img_xy, par, n, n_cols, tau, sharp,
                      "implicit forward (K1)")
    _build.count("K1")
    return out


def cuda_bwd(img_xy: torch.Tensor, par: torch.Tensor, tacc: torch.Tensor,
             g: torch.Tensor, n: int, n_cols: int, tau: float, sharp: float):
    """K2 on the card: same contract as :func:`emulate_bwd`."""
    out = _launch_bwd(img_xy, par, tacc, g, n, n_cols, tau, sharp,
                      "implicit backward (K2)")
    _build.count("K2")
    return out


def cuda_slab_fwd(img_xy: torch.Tensor, par: torch.Tensor, n: int,
                  n_cols: int, tau: float, sharp: float):
    """K6's forward on the card: K1 on a slab of ``n_cols`` columns from
    the x offset in slot 19; same contract as :func:`emulate_fwd`."""
    out = _launch_fwd(img_xy, par, n, n_cols, tau, sharp,
                      "implicit slab forward (K6)")
    _build.count("K6")
    return out


def cuda_slab_bwd(img_xy: torch.Tensor, par: torch.Tensor,
                  tacc: torch.Tensor, g: torch.Tensor, n: int, n_cols: int,
                  tau: float, sharp: float):
    """K6's backward on the card: K2 on the slab of
    :func:`cuda_slab_fwd`; same contract as :func:`emulate_bwd`."""
    out = _launch_bwd(img_xy, par, tacc, g, n, n_cols, tau, sharp,
                      "implicit slab backward (K6)")
    _build.count("K6_bwd")
    return out


class _Impl(NamedTuple):
    fwd: object
    bwd: object


CUDA = _Impl(cuda_fwd, cuda_bwd)
CUDA_SLAB = _Impl(cuda_slab_fwd, cuda_slab_bwd)
EMULATION = _Impl(emulate_fwd, emulate_bwd)


class _ImplicitCore(torch.autograd.Function):
    """Per-sample sums with the analytic backward: the ``custom_vjp``
    ``_core`` of the JAX package (:453-470)."""

    @staticmethod
    def forward(ctx, img_xy, par, n, n_cols, tau, sharp, impl):
        sums, tacc = impl.fwd(img_xy, par, n, n_cols, tau, sharp)
        ctx.save_for_backward(img_xy, par, tacc)
        ctx.consts = (n, n_cols, tau, sharp, impl)
        return sums

    @staticmethod
    def backward(ctx, g):
        img_xy, par, tacc = ctx.saved_tensors
        n, n_cols, tau, sharp, impl = ctx.consts
        dpar, dimg = impl.bwd(img_xy, par, tacc, g, n, n_cols, tau, sharp)
        return dimg, dpar, None, None, None, None, None


def _check_inputs(img: torch.Tensor, pred_p: torch.Tensor, n: int) -> None:
    if pred_p.ndim != 2 or pred_p.shape[-1] != geometry.N_PARAMS:
        raise ValueError(f"params must be (B, 12), got {tuple(pred_p.shape)}")
    if img.ndim not in (3, 4) or img.shape[0] != pred_p.shape[0] \
            or (img.ndim == 4 and img.shape[1] != 1):
        raise ValueError(f"images must be (B, H, W) or (B, 1, H, W) with "
                         f"B = {pred_p.shape[0]}, got {tuple(img.shape)}")
    if n < 2:
        raise ValueError(f"render size must be >= 2, got {n}")


def _sweep_loss(impl: _Impl, img, pred_p, n, tau, sharpness, z_window,
                z_margin, reduce=True):
    img_xy = image_plane(img, n, pred_p.dtype)
    par = pack_params(pred_p, n, z_window, z_margin)
    sums = _ImplicitCore.apply(img_xy, par, n, n, float(tau),
                               float(sharpness), impl)
    return torch.mean(sums) / (n * n) if reduce else sums / (n * n)


def implicit_loss_cuda(img: torch.Tensor, pred_p: torch.Tensor,
                       render_size: int = 64, tau: float = 1.5,
                       sharpness: float = 260.0, z_window: bool = True,
                       z_margin: float = Z_MARGIN,
                       reduce: bool = True) -> torch.Tensor:
    """The implicit loss through K1 (forward) and K2 (backward) for a
    CUDA float32 ``pred_p``; the plain :func:`sqtpu_torch.ops.losses
    .implicit_loss` for a CPU tensor. ``z_window=True`` sweeps only each
    sample's z-support window ± ``z_margin`` (the out-of-window
    transmittance is closed form); ``z_window=False`` sweeps all n planes.
    ``reduce=False`` gives the (B,) per-sample losses. On a CUDA tensor it
    launches the kernels or raises."""
    _check_inputs(img, pred_p, render_size)
    if pred_p.device.type == "cpu":
        return losses.implicit_loss(img, pred_p, render_size, tau,
                                    sharpness, reduce)
    if pred_p.device.type != "cuda":
        raise ValueError(f"no kernel for device {pred_p.device}")
    if pred_p.dtype != torch.float32:
        raise TypeError(f"the implicit-loss kernels take float32 params, "
                        f"got {pred_p.dtype}")
    if img.device != pred_p.device:
        raise ValueError(f"images on {img.device}, params on "
                         f"{pred_p.device}")
    return _sweep_loss(CUDA, img, pred_p, render_size, tau, sharpness,
                       z_window, z_margin, reduce)


def implicit_loss_emulated(img: torch.Tensor, pred_p: torch.Tensor,
                           render_size: int = 64, tau: float = 1.5,
                           sharpness: float = 260.0, z_window: bool = True,
                           z_margin: float = Z_MARGIN,
                           reduce: bool = True) -> torch.Tensor:
    """The same loss through the torch emulation of K1 and K2, on any
    device, in ``pred_p``'s floating dtype."""
    _check_inputs(img, pred_p, render_size)
    return _sweep_loss(EMULATION, img, pred_p, render_size, tau, sharpness,
                       z_window, z_margin, reduce)


# ---------------------------------------------------------------------------
# K6: the partial sums over a slab of image columns (:543-591)
# ---------------------------------------------------------------------------

def _check_slab(img_slab: torch.Tensor, pred_p: torch.Tensor, x0: int,
                n: int) -> None:
    if pred_p.ndim != 2 or pred_p.shape[-1] != geometry.N_PARAMS:
        raise ValueError(f"params must be (B, 12), got {tuple(pred_p.shape)}")
    if img_slab.ndim != 3 or img_slab.shape[:2] != (pred_p.shape[0], n):
        raise ValueError(f"the slab must be (B, n, n_cols) with B = "
                         f"{pred_p.shape[0]} and n = {n}, got "
                         f"{tuple(img_slab.shape)}")
    n_cols = img_slab.shape[-1]
    if n < 2 or n_cols < 1 or not 0 <= x0 <= n - n_cols:
        raise ValueError(f"columns [{x0}, {x0 + n_cols}) are not a slab of "
                         f"the {n}-column lattice")


def _slab_sums(impl: _Impl, img_slab, pred_p, x0, n, tau, sharpness,
               z_window, z_margin):
    par = pack_params(pred_p, n, z_window, z_margin, x0=x0)
    return _ImplicitCore.apply(slab_plane(img_slab.to(pred_p.dtype)), par, n,
                               img_slab.shape[-1], float(tau),
                               float(sharpness), impl)


def implicit_sums_slab_plain(img_slab: torch.Tensor, pred_p: torch.Tensor,
                             x0: int, render_size: int, tau: float = 1.5,
                             sharpness: float = 260.0) -> torch.Tensor:
    """Per-sample Σ|img − depth| over the columns [x0, x0 + n_cols) of the
    render lattice, in plain torch (autograd): the soft render of the
    slab's lattice x axis only (``sharded_losses.py:175-186``), full z
    sweep. ``img_slab`` is (B, n, n_cols) in image space, already resized
    to the lattice. Returns (B,) in ``pred_p``'s dtype."""
    n = render_size
    _check_slab(img_slab, pred_p, x0, n)
    ax = geometry.make_axis(n, "implicit", dtype=pred_p.dtype,
                            device=pred_p.device)
    ax_x = ax[x0:x0 + img_slab.shape[-1]]
    depth = render.depth_from_axes(ax_x, ax, ax,
                                   geometry.clamp_params(pred_p), tau,
                                   sharpness, n)
    return torch.sum(torch.abs(img_slab.to(pred_p.dtype) - depth),
                     dim=(1, 2))


def implicit_sums_slab_cuda(img_slab: torch.Tensor, pred_p: torch.Tensor,
                            x0: int, render_size: int, tau: float = 1.5,
                            sharpness: float = 260.0, z_window: bool = True,
                            z_margin: float = Z_MARGIN) -> torch.Tensor:
    """K6: the per-sample partial sums of :func:`implicit_sums_slab_plain`
    through K1 (forward) and K2 (backward) launched on the slab, with the
    gradient to ``pred_p`` and to the slab, for a CUDA float32 ``pred_p``;
    the plain version for a CPU tensor. The z window and the full sweep
    are K1's. On a CUDA tensor it launches the kernels or raises."""
    _check_slab(img_slab, pred_p, x0, render_size)
    if pred_p.device.type == "cpu":
        return implicit_sums_slab_plain(img_slab, pred_p, x0, render_size,
                                        tau, sharpness)
    if pred_p.device.type != "cuda":
        raise ValueError(f"no kernel for device {pred_p.device}")
    if pred_p.dtype != torch.float32:
        raise TypeError(f"the implicit-loss kernels take float32 params, "
                        f"got {pred_p.dtype}")
    if img_slab.device != pred_p.device:
        raise ValueError(f"slab on {img_slab.device}, params on "
                         f"{pred_p.device}")
    return _slab_sums(CUDA_SLAB, img_slab, pred_p, x0, render_size, tau,
                      sharpness, z_window, z_margin)


def implicit_sums_slab_emulated(img_slab: torch.Tensor, pred_p: torch.Tensor,
                                x0: int, render_size: int, tau: float = 1.5,
                                sharpness: float = 260.0,
                                z_window: bool = True,
                                z_margin: float = Z_MARGIN) -> torch.Tensor:
    """The same partial sums through the torch emulation of K1 and K2 on
    the slab, on any device, in ``pred_p``'s floating dtype."""
    _check_slab(img_slab, pred_p, x0, render_size)
    return _slab_sums(EMULATION, img_slab, pred_p, x0, render_size, tau,
                      sharpness, z_window, z_margin)


def window_points(par: torch.Tensor, n: int, n_cols: int) -> int:
    """In-window (x, y, z) points for these packed params, the points the
    TPU kernels' algorithm visits: Σ_b (j_hi − j_lo + 1) · n · n_cols."""
    return sq_field.window_points(par, n * n_cols)


def cull_points(par: torch.Tensor, n: int, n_cols: int, tau: float,
                sharp: float) -> int:
    """Points K1 evaluates after the exact-zero cull (and K2, for finite
    cotangents and Tacc): Σ over the pixels of the planes each sweeps
    (counted by the emulation)."""
    r = _rays(par, n, n_cols, tau, sharp, True)
    return int((r.b - r.a + 1).sum())

