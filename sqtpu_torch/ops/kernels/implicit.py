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
t_rot = R·t (:func:`frame_params`) stay in torch autograd around a
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
Tacc residual and analytic backward), the analogue of Pallas interpret
mode. The tests hold it against the JAX kernel in interpret mode and
against autograd of the plain loss; on the card the kernels are held
against it. The main path never calls it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sqtpu_torch.ops import geometry
from sqtpu_torch.ops import losses
from sqtpu_torch.ops import quaternion as quat
from sqtpu_torch.ops import render
from sqtpu_torch.ops.image import nearest_resize

N_PAR = 17         # frame scalars: a(3), e(2), t_rot(3), R(9)
PAR_STRIDE = 24    # floats per sample in the packed parameters
Z_MARGIN = 0.05    # z-window margin, normalized z units
# slots 17..19 carry the z window [j_lo, j_hi] as float lattice indices and
# the x-column offset of the plane slab; 20..23 are zero
SLOT_JLO, SLOT_JHI, SLOT_X0 = 17, 18, 19
# The gradient's exponentials are assembled in log space with the exponent
# clamped: far outside the occupancy shell they overflow while their
# cotangent is exactly 0, and inf·0 would give NaN.
CLAMP = 30.0
EXPCLAMP = 1.0686475e13  # exp(CLAMP) in float32
MAX_BATCH = 65535        # the kernels' grid.y

# Launches of K1 and K2 on the whole plane, and of K6 (the same kernels on
# a column slab, forward and backward), since the last reset_launches();
# each wrapper adds one where it launches its kernel and nowhere else.
fwd_launches = 0
bwd_launches = 0
slab_fwd_launches = 0
slab_bwd_launches = 0


def reset_launches() -> None:
    global fwd_launches, bwd_launches, slab_fwd_launches, slab_bwd_launches
    fwd_launches = bwd_launches = slab_fwd_launches = slab_bwd_launches = 0


def _lib() -> ctypes.CDLL:
    from sqtpu_torch.ops.kernels import _build

    lib = _build.load("implicit")
    if not getattr(lib, "_sqtpu_typed", False):
        ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.sqtpu_implicit_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                           i32, f64, f64, ptr]
        lib.sqtpu_implicit_fwd.restype = i32
        lib.sqtpu_implicit_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                           i32, i32, i32, f64, f64, ptr]
        lib.sqtpu_implicit_bwd.restype = i32
        lib.sqtpu_implicit_blocks.argtypes = [i32, i32]
        lib.sqtpu_implicit_blocks.restype = i32
        lib.sqtpu_error_string.argtypes = [i32]
        lib.sqtpu_error_string.restype = ctypes.c_char_p
        lib._sqtpu_typed = True
    return lib


# ---------------------------------------------------------------------------
# The wrapper's torch side (sqtpu/ops/kernels/implicit.py:258-270, 473-540)
# ---------------------------------------------------------------------------

def frame_params(p: torch.Tensor) -> torch.Tensor:
    """Clamp a (B, 12) batch and expand it to the (B, 24) frame layout
    [a(3), e(2), R(q*)·t(3), R(q*)(9), 0(7)], differentiably. Keeps a
    float64 input in float64 (the CUDA path takes float32)."""
    pp = geometry.clamp_params(p)
    a, e, t, q = geometry.split_params(pp)
    rot = quat.to_matrix(quat.conjugate(q))
    tr = torch.einsum("bij,bj->bi", rot, t)
    return torch.cat([a, e, tr, rot.reshape(-1, 9),
                      pp.new_zeros((pp.shape[0], PAR_STRIDE - N_PAR))],
                     dim=-1)


@torch.no_grad()
def z_window_indices(pred_p: torch.Tensor, n: int,
                     margin: float = Z_MARGIN):
    """Per-sample lattice window [j_lo, j_hi] on the implicit axis
    (z_j = j/(n−1)) covering the clamped superquadric's z-support box ±
    ``margin``, as float indices with no gradient."""
    pp = geometry.clamp_params(pred_p)
    a, e, t, q = geometry.split_params(pp)
    rot = quat.to_matrix(quat.conjugate(q))
    zlo, zhi, _ = geometry.z_support_window(a, rot, t, 2)
    zlo = torch.clamp(zlo - margin, 0.0, 1.0)
    zhi = torch.clamp(zhi + margin, 0.0, 1.0)
    jlo = torch.ceil(zlo * (n - 1))
    jhi = torch.maximum(torch.floor(zhi * (n - 1)), jlo)
    return jlo, jhi


def pack_params(pred_p: torch.Tensor, n: int, z_window: bool = True,
                z_margin: float = Z_MARGIN, x0: int = 0) -> torch.Tensor:
    """(B, 12) params -> the kernels' (B, 24) parameters: the frame
    scalars with the z window (or the full sweep [0, n−1]) and the slab's
    x offset in slots 17-19. Differentiable in the frame scalars."""
    par = frame_params(pred_p)
    tail = torch.zeros((par.shape[0], PAR_STRIDE - N_PAR), dtype=par.dtype,
                       device=par.device)
    if z_window:
        jlo, jhi = z_window_indices(pred_p, n, z_margin)
        tail[:, SLOT_JLO - N_PAR] = jlo
        tail[:, SLOT_JHI - N_PAR] = jhi
    else:
        tail[:, SLOT_JHI - N_PAR] = float(n - 1)
    tail[:, SLOT_X0 - N_PAR] = float(x0)
    return torch.cat([par[:, :N_PAR], tail], dim=-1).contiguous()


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

class _Sweep(NamedTuple):
    pp: list          # 17 frame scalars, each (B, 1)
    X: torch.Tensor   # (B, P) plane coordinates
    Y: torch.Tensor
    lo: torch.Tensor  # (B, 1) window bounds, int64
    hi: torch.Tensor
    inv: float


def _sweep_setup(par: torch.Tensor, n: int, n_cols: int) -> _Sweep:
    """Coordinates of the (x_local·n + y) plane as the kernels compute
    them: lattice index 0 maps to 1e-4, any other k to k/(n−1); x is
    offset by slot 19."""
    dev = par.device
    idx = torch.arange(n * n_cols, device=dev)
    x0 = par[:, SLOT_X0].to(torch.int64)[:, None]
    xi = (idx // n)[None, :] + x0
    yi = (idx % n)[None, :].expand_as(xi)
    inv = 1.0 / (n - 1)
    X = torch.where(xi == 0, 1e-4, xi.to(par.dtype) * inv)
    Y = torch.where(yi == 0, 1e-4, yi.to(par.dtype) * inv)
    pp = [par[:, i:i + 1] for i in range(N_PAR)]
    lo = par[:, SLOT_JLO].to(torch.int64)[:, None]
    hi = par[:, SLOT_JHI].to(torch.int64)[:, None]
    return _Sweep(pp, X, Y, lo, hi, inv)


def _zval(j: int, inv: float, like: torch.Tensor) -> torch.Tensor:
    if j == 0:
        return like.new_tensor(1e-4)
    return like.new_tensor(float(j)) * inv


def _field_terms(pp, X, Y, z) -> dict:
    """The forward chain at one z plane (``_field_terms`` of the JAX
    kernel, :149-178)."""
    a1, a2, a3, e1, e2, t0, t1, t2 = pp[:8]
    r = pp[8:17]
    u = (r[0] * X + r[1] * Y + r[2] * z - t0) / a1
    v = (r[3] * X + r[4] * Y + r[5] * z - t1) / a2
    w = (r[6] * X + r[7] * Y + r[8] * z - t2) / a3
    x2, y2, z2 = u * u, v * v, w * w
    x2g = x2 + (x2 == 0).to(x2.dtype) * 1e-4
    y2g = y2 + (y2 == 0).to(y2.dtype) * 1e-4
    z2g = z2 + (z2 == 0).to(z2.dtype) * 1e-4
    lx, ly, lz = torch.log(x2g), torch.log(y2g), torch.log(z2g)
    A = torch.exp(lx / e2)
    B = torch.exp(ly / e2)
    C = torch.exp(lz / e1)
    tiny = torch.finfo(X.dtype).tiny
    G = A + B + tiny
    lg = torch.log(G)
    E = torch.exp(lg * (e2 / e1))
    H = E + C + tiny
    lh = torch.log(H)
    F = torch.exp(lh * e1)
    return dict(u=u, v=v, w=w, x2g=x2g, y2g=y2g, z2g=z2g, lx=lx, ly=ly,
                lz=lz, lg=lg, lh=lh, F=F)


def _ex(logterm: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(logterm, max=CLAMP))


def _frame_grad_step(acc: list, T: dict, gF, pp, X, Y, z) -> None:
    """Add one plane's gradient of the 17 frame scalars to ``acc``
    (``_frame_grad_step`` of the JAX kernel, :200-255)."""
    a1, a2, a3, e1, e2 = pp[:5]
    F, lh, lg = T["F"], T["lh"], T["lg"]
    lx, ly, lz = T["lx"], T["ly"], T["lz"]
    lfh = (e1 - 1.0) * lh
    dF_dx2 = _ex(lfh + (e2 / e1 - 1.0) * lg + (1.0 / e2 - 1.0) * lx)
    dF_dy2 = _ex(lfh + (e2 / e1 - 1.0) * lg + (1.0 / e2 - 1.0) * ly)
    dF_dz2 = _ex(lfh + (1.0 / e1 - 1.0) * lz)
    u, v, w = T["u"], T["v"], T["w"]
    gx = gF * dF_dx2 * 2.0 * u
    gy = gF * dF_dy2 * 2.0 * v
    gz = gF * dF_dz2 * 2.0 * w
    le = (e2 / e1) * lg
    x2g, y2g, z2g = T["x2g"], T["y2g"], T["z2g"]
    ex_le = _ex(lfh + le)
    terms = [
        -gx * u / a1, -gy * v / a2, -gz * w / a3,
        gF * (torch.clamp(F, max=EXPCLAMP) * lh
              - (ex_le * lg * e2 + dF_dz2 * z2g * lz) / e1),
        gF * (ex_le * lg - (dF_dx2 * x2g * lx + dF_dy2 * y2g * ly) / e2),
        -gx / a1, -gy / a2, -gz / a3,
        gx * X / a1, gx * Y / a1, gx * z / a1,
        gy * X / a2, gy * Y / a2, gy * z / a2,
        gz * X / a3, gz * Y / a3, gz * z / a3,
    ]
    for i, t in enumerate(terms):
        acc[i] = acc[i] + t


def _occ(F, sharp: float):
    return torch.sigmoid(sharp * (1.0 - F))


def emulate_fwd(img_xy: torch.Tensor, par: torch.Tensor, n: int,
                n_cols: int, tau: float, sharp: float):
    """K1's algorithm in torch: (B, P) plane, (B, 24) params -> (B,) sums
    of |img − depth| and the (B, P) transmittance sums Tacc. Each sample
    sweeps only its own window [j_lo, j_hi]; the dtype is the params'."""
    sw = _sweep_setup(par, n, n_cols)
    S = torch.zeros_like(sw.X)
    t_in = torch.zeros_like(sw.X)
    for j in range(int(sw.hi.max()), int(sw.lo.min()) - 1, -1):
        active = (sw.lo <= j) & (j <= sw.hi)
        z = _zval(j, sw.inv, par)
        F = _field_terms(sw.pp, sw.X, sw.Y, z)["F"]
        S_j = S + _occ(F, sharp)
        t_in = torch.where(active, t_in + torch.exp(-tau * S_j), t_in)
        S = torch.where(active, S_j, S)
    c_pre = (n - 1) - sw.hi.to(par.dtype)
    c_post = sw.lo.to(par.dtype)
    tacc = c_pre + t_in + c_post * torch.exp(-tau * S)
    sums = torch.abs(img_xy - (1.0 - tacc / n)).sum(dim=-1)
    return sums, tacc


def emulate_bwd(img_xy: torch.Tensor, par: torch.Tensor, tacc: torch.Tensor,
                g: torch.Tensor, n: int, n_cols: int, tau: float,
                sharp: float):
    """K2's algorithm in torch: -> (B, 24) gradient of the frame scalars
    (slots 17-23 zero) and the (B, P) image cotangent, for the upstream
    gradient ``g`` (B,) of the per-sample sums."""
    sw = _sweep_setup(par, n, n_cols)
    depth = 1.0 - tacc / n
    sgn = torch.sign(img_xy - depth)
    g = g[:, None]
    dimg = sgn * g
    phi = -sgn * g * (tau / n)
    acc = [torch.zeros_like(sw.X) for _ in range(N_PAR)]
    S = torch.zeros_like(sw.X)
    V = ((n - 1) - sw.hi.to(par.dtype)).expand_as(sw.X)
    for j in range(int(sw.hi.max()), int(sw.lo.min()) - 1, -1):
        active = (sw.lo <= j) & (j <= sw.hi)
        z = _zval(j, sw.inv, par)
        T = _field_terms(sw.pp, sw.X, sw.Y, z)
        occ = _occ(T["F"], sharp)
        S_j = S + occ
        T_j = torch.exp(-tau * S_j)
        V_j = V + T_j
        W = tacc - V_j + T_j
        gF = torch.where(active, phi * W * (-sharp) * occ * (1.0 - occ), 0.0)
        _frame_grad_step(acc, T, gF, sw.pp, sw.X, sw.Y, z)
        S = torch.where(active, S_j, S)
        V = torch.where(active, V_j, V)
    dpar = torch.zeros_like(par)
    dpar[:, :N_PAR] = torch.stack([a.sum(dim=-1) for a in acc], dim=-1)
    return dpar, dimg


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _check_operands(n: int, n_cols: int, par: torch.Tensor, planes=(),
                    vectors=()) -> None:
    """Raise unless ``par`` is (B, 24), each of ``planes`` (B, n·n_cols)
    and each of ``vectors`` (B,), all float32, contiguous and on one CUDA
    device, with B and n within what the kernels take."""
    b = par.shape[0]
    if not 0 < b <= MAX_BATCH:
        raise ValueError(f"batch {b} outside the kernels' grid "
                         f"(1..{MAX_BATCH})")
    if n < 2 or not 0 < n_cols <= n:
        raise ValueError(f"need n >= 2 and 0 < n_cols <= n, got {n}, "
                         f"{n_cols}")
    want = [("params", par, (b, PAR_STRIDE))]
    want += [("plane", t, (b, n * n_cols)) for t in planes]
    want += [("cotangent", t, (b,)) for t in vectors]
    for name, t, shape in want:
        check_operand(name, t, shape, par.device)


def check_operand(name: str, t: torch.Tensor, shape: tuple,
                  device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    the CUDA ``device``: what a kernel's launcher takes."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, the "
                         f"kernel takes {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be on the params' CUDA device, "
                         f"got {t.device}")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.sqtpu_error_string(err).decode())


def _launch_fwd(img_xy: torch.Tensor, par: torch.Tensor, n: int,
                n_cols: int, tau: float, sharp: float, what: str):
    _check_operands(n, n_cols, par, planes=(img_xy,))
    lib = _lib()
    b = par.shape[0]
    blocks = lib.sqtpu_implicit_blocks(n, n_cols)
    tacc = torch.empty_like(img_xy)
    partial = torch.empty((b, blocks), dtype=torch.float32,
                          device=par.device)
    sums = torch.empty((b,), dtype=torch.float32, device=par.device)
    with torch.cuda.device(par.device):
        stream = torch.cuda.current_stream(par.device).cuda_stream
        err = lib.sqtpu_implicit_fwd(
            par.data_ptr(), img_xy.data_ptr(), tacc.data_ptr(),
            partial.data_ptr(), sums.data_ptr(), b, n, n_cols, float(tau),
            float(sharp), stream)
    _raise_on(lib, err, what)
    return sums, tacc


def _launch_bwd(img_xy: torch.Tensor, par: torch.Tensor, tacc: torch.Tensor,
                g: torch.Tensor, n: int, n_cols: int, tau: float,
                sharp: float, what: str):
    g = g.contiguous()
    _check_operands(n, n_cols, par, planes=(img_xy, tacc), vectors=(g,))
    lib = _lib()
    b = par.shape[0]
    blocks = lib.sqtpu_implicit_blocks(n, n_cols)
    dimg = torch.empty_like(img_xy)
    partial = torch.empty((b, blocks, N_PAR), dtype=torch.float32,
                          device=par.device)
    dpar = torch.empty((b, PAR_STRIDE), dtype=torch.float32,
                       device=par.device)
    with torch.cuda.device(par.device):
        stream = torch.cuda.current_stream(par.device).cuda_stream
        err = lib.sqtpu_implicit_bwd(
            par.data_ptr(), g.data_ptr(), img_xy.data_ptr(),
            tacc.data_ptr(), dimg.data_ptr(), partial.data_ptr(),
            dpar.data_ptr(), b, n, n_cols, float(tau), float(sharp), stream)
    _raise_on(lib, err, what)
    return dpar, dimg


def cuda_fwd(img_xy: torch.Tensor, par: torch.Tensor, n: int, n_cols: int,
             tau: float, sharp: float):
    """K1 on the card: same contract as :func:`emulate_fwd`."""
    global fwd_launches
    out = _launch_fwd(img_xy, par, n, n_cols, tau, sharp,
                      "implicit forward (K1)")
    fwd_launches += 1
    return out


def cuda_bwd(img_xy: torch.Tensor, par: torch.Tensor, tacc: torch.Tensor,
             g: torch.Tensor, n: int, n_cols: int, tau: float, sharp: float):
    """K2 on the card: same contract as :func:`emulate_bwd`."""
    global bwd_launches
    out = _launch_bwd(img_xy, par, tacc, g, n, n_cols, tau, sharp,
                      "implicit backward (K2)")
    bwd_launches += 1
    return out


def cuda_slab_fwd(img_xy: torch.Tensor, par: torch.Tensor, n: int,
                  n_cols: int, tau: float, sharp: float):
    """K6's forward on the card: K1 on a slab of ``n_cols`` columns from
    the x offset in slot 19; same contract as :func:`emulate_fwd`."""
    global slab_fwd_launches
    out = _launch_fwd(img_xy, par, n, n_cols, tau, sharp,
                      "implicit slab forward (K6)")
    slab_fwd_launches += 1
    return out


def cuda_slab_bwd(img_xy: torch.Tensor, par: torch.Tensor,
                  tacc: torch.Tensor, g: torch.Tensor, n: int, n_cols: int,
                  tau: float, sharp: float):
    """K6's backward on the card: K2 on the slab of
    :func:`cuda_slab_fwd`; same contract as :func:`emulate_bwd`."""
    global slab_bwd_launches
    out = _launch_bwd(img_xy, par, tacc, g, n, n_cols, tau, sharp,
                      "implicit slab backward (K6)")
    slab_bwd_launches += 1
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
                z_margin):
    img_xy = image_plane(img, n, pred_p.dtype)
    par = pack_params(pred_p, n, z_window, z_margin)
    sums = _ImplicitCore.apply(img_xy, par, n, n, float(tau),
                               float(sharpness), impl)
    return torch.mean(sums) / (n * n)


def implicit_loss_cuda(img: torch.Tensor, pred_p: torch.Tensor,
                       render_size: int = 64, tau: float = 1.5,
                       sharpness: float = 260.0, z_window: bool = True,
                       z_margin: float = Z_MARGIN) -> torch.Tensor:
    """The implicit loss through K1 (forward) and K2 (backward) for a
    CUDA float32 ``pred_p``; the plain :func:`sqtpu_torch.ops.losses
    .implicit_loss` for a CPU tensor. ``z_window=True`` sweeps only each
    sample's z-support window ± ``z_margin`` (the out-of-window
    transmittance is closed form); ``z_window=False`` sweeps all n planes.
    On a CUDA tensor it launches the kernels or raises."""
    _check_inputs(img, pred_p, render_size)
    if pred_p.device.type == "cpu":
        return losses.implicit_loss(img, pred_p, render_size, tau,
                                    sharpness)
    if pred_p.device.type != "cuda":
        raise ValueError(f"no kernel for device {pred_p.device}")
    if pred_p.dtype != torch.float32:
        raise TypeError(f"the implicit-loss kernels take float32 params, "
                        f"got {pred_p.dtype}")
    if img.device != pred_p.device:
        raise ValueError(f"images on {img.device}, params on "
                         f"{pred_p.device}")
    return _sweep_loss(CUDA, img, pred_p, render_size, tau, sharpness,
                       z_window, z_margin)


def implicit_loss_emulated(img: torch.Tensor, pred_p: torch.Tensor,
                           render_size: int = 64, tau: float = 1.5,
                           sharpness: float = 260.0, z_window: bool = True,
                           z_margin: float = Z_MARGIN) -> torch.Tensor:
    """The same loss through the torch emulation of K1 and K2, on any
    device, in ``pred_p``'s floating dtype."""
    _check_inputs(img, pred_p, render_size)
    return _sweep_loss(EMULATION, img, pred_p, render_size, tau, sharpness,
                       z_window, z_margin)


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
    """In-window (x, y, z) points the kernels visit for these packed
    params: Σ_b (j_hi − j_lo + 1) · n · n_cols."""
    span = par[:, SLOT_JHI].to(torch.int64) - par[:, SLOT_JLO].to(
        torch.int64) + 1
    return int(span.sum()) * n * n_cols

