"""Superquadric geometry in PyTorch: parameter layout, grids, and the
inside-outside field.

Counterpart of ``sqtpu/ops/geometry.py`` (:54-330, :333-352,
:356-412). Every
function works on the canonical 12-vector
``[a1,a2,a3, e1,e2, t1,t2,t3, qx,qy,qz,qw]`` (normalized units: a, t in
[0, 1] ~ /255 world units) and broadcasts over a leading batch dimension
where the JAX package would ``vmap``.

The field follows the torch reference convention:
``F = (((x²)^(1/e2) + (y²)^(1/e2))^(e2/e1) + (z²)^(1/e1))^(e1)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sqtpu_torch.ops import quaternion as quat

SIZE_SLICE = slice(0, 3)
SHAPE_SLICE = slice(3, 5)
POS_SLICE = slice(5, 8)
QUAT_SLICE = slice(8, 12)
N_PARAMS = 12

A_MIN, A_MAX = 0.05, 1.0
E_MIN, E_MAX = 0.1, 1.0
T_MIN, T_MAX = 0.0, 1.0


class SQParams(NamedTuple):
    """Unpacked superquadric parameters (each (..., k))."""

    a: torch.Tensor  # (..., 3) sizes
    e: torch.Tensor  # (..., 2) shape exponents
    t: torch.Tensor  # (..., 3) position
    q: torch.Tensor  # (..., 4) xyzw unit quaternion


def split_params(p: torch.Tensor) -> SQParams:
    """(..., 12) -> SQParams."""
    return SQParams(a=p[..., SIZE_SLICE], e=p[..., SHAPE_SLICE],
                    t=p[..., POS_SLICE], q=p[..., QUAT_SLICE])


def join_params(sq: SQParams) -> torch.Tensor:
    return torch.cat([sq.a, sq.e, sq.t, sq.q], dim=-1)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``, derivative included: the values of ``torch.clamp``,
    whose derivative is 1 where x equals a bound; ``jnp.clip``'s is 1/2
    there, and the classical fit starts its shape exponents exactly at the
    bound 1. The mean of the clamp and of the clamp differentiated only
    strictly inside gives those values bit for bit and that derivative
    (``torch.minimum``/``maximum`` would too, but their forward-mode
    derivative turns float32 into float64)."""
    c = torch.clamp(x, lo, hi)
    inner = torch.where((x > lo) & (x < hi), x, c.detach())
    return 0.5 * (c + inner)


def clamp_params(p: torch.Tensor) -> torch.Tensor:
    """a ∈ [0.05, 1], e ∈ [0.1, 1], t ∈ [0, 1]; quaternion untouched."""
    a, e, t, q = split_params(p)
    return join_params(SQParams(a=clip(a, A_MIN, A_MAX),
                                e=clip(e, E_MIN, E_MAX),
                                t=clip(t, T_MIN, T_MAX), q=q))


def make_axis(n: int, kind: str, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """1-D coordinate axis for the voxelized [0,1]³ space.

    ``"explicit"``: N+1 points k/N with the zero nudged to 1e-4;
    ``"implicit"``: N points linspace(0, 1, N), zero nudged;
    ``"iou"``: N points linspace(0, 1, N), no nudge.
    """
    if kind == "explicit":
        ax = torch.arange(n + 1, dtype=dtype, device=device) / n
    elif kind in ("implicit", "iou"):
        # k · (1/(N-1)) with the end point exactly 1: what jnp.linspace(0,
        # 1, N) computes, to the last bit (torch.linspace rounds otherwise)
        recip = torch.ones((), dtype=dtype, device=device) / max(n - 1, 1)
        ax = torch.cat([torch.arange(n - 1, dtype=dtype, device=device)
                        * recip, torch.ones(1, dtype=dtype, device=device)])
    else:
        raise ValueError(f"unknown grid kind: {kind}")
    if kind == "iou":
        return ax
    return torch.where(ax == 0, torch.full_like(ax, 1e-4), ax)


def _power_chain(x2, y2, z2, e1, e2, *, guard: bool):
    """Squared body coordinates -> F^(e1).

    ``guard`` adds 1e-4 at exact zeros of the squared coordinates (the
    losses' guard; the IoU omits it). The dtype's smallest normal is
    added inside both outer powers so an fp32 underflow of the inner
    powers never yields 0^(negative) in a gradient.
    """
    if guard:
        x2 = x2 + (x2 == 0).to(x2.dtype) * 1e-4
        y2 = y2 + (y2 == 0).to(y2.dtype) * 1e-4
        z2 = z2 + (z2 == 0).to(z2.dtype) * 1e-4
    A = torch.pow(x2, 1.0 / e2)
    B = torch.pow(y2, 1.0 / e2)
    C = torch.pow(z2, 1.0 / e1)
    tiny = torch.finfo(x2.dtype).tiny
    E = torch.pow(A + B + tiny, e2 / e1)
    return torch.pow(E + C + tiny, e1)


def rotated_frame(p: torch.Tensor):
    """Sizes, exponents, R(q*)·t and R(q*): the reference rotates the
    space, not the superquadric. The one frame of the plain fields and of
    every kernel's packed rows."""
    a, e, t, q = split_params(p)
    rot = quat.to_matrix(quat.conjugate(q))  # (..., 3, 3)
    tr = torch.einsum("...ij,...j->...i", rot, t)
    return a, e, tr, rot


def field_grid(ax_x: torch.Tensor, ax_y: torch.Tensor, ax_z: torch.Tensor,
               p: torch.Tensor, *, guard: bool = True) -> torch.Tensor:
    """F^(e1) on a separable grid: (Nx, Ny, Nz) for p of shape (12,),
    (B, Nx, Ny, Nz) for p of shape (B, 12)."""
    a, e, tr, rot = rotated_frame(p)
    lead = p.shape[:-1]
    pad = (1,) * 3

    def s(v):  # a per-sample scalar, broadcast over the grid
        return v.reshape(lead + pad)

    X = ax_x[:, None, None]
    Y = ax_y[None, :, None]
    Z = ax_z[None, None, :]
    coord = []
    for i in range(3):
        c = s(rot[..., i, 0]) * X + s(rot[..., i, 1]) * Y \
            + s(rot[..., i, 2]) * Z
        coord.append(((c - s(tr[..., i])) / s(a[..., i])) ** 2)
    return _power_chain(*coord, s(e[..., 0]), s(e[..., 1]), guard=guard)


def field_points(points: torch.Tensor, p: torch.Tensor, *,
                 guard: bool = True) -> torch.Tensor:
    """F^(e1) at arbitrary world points: ``points`` (..., N, 3) and ``p``
    (..., 12) with the same leading dims (none for one superquadric) ->
    (..., N); F < 1 inside, > 1 outside."""
    a, e, tr, rot = rotated_frame(p)
    rp = torch.einsum("...ij,...nj->...ni", rot, points)

    def s(v):  # a per-sample scalar, broadcast over the points
        return v[..., None]

    sq = [((rp[..., i] - s(tr[..., i])) / s(a[..., i])) ** 2
          for i in range(3)]
    return _power_chain(*sq, s(e[..., 0]), s(e[..., 1]), guard=guard)


def _spow(base: torch.Tensor, expo) -> torch.Tensor:
    """Signed power sgn(x)·|x|^e (the scanner's ``spow``); 0 at 0."""
    return torch.sign(base) * torch.pow(torch.abs(base), expo)


def surface_point(p: torch.Tensor, eta: torch.Tensor, omega: torch.Tensor,
                  frame: str = "world") -> torch.Tensor:
    """The closed-form surface point r(η, ω) of one superquadric ``p``
    (12,) (the scanner's ``sq::r``): x = a1·cos^e1(η)·cos^e2(ω),
    y = a2·cos^e1(η)·sin^e2(ω), z = a3·sin^e1(η), signed powers, over the
    broadcast shape of ``eta`` and ``omega`` -> (..., 3); ``frame="body"``
    leaves it unposed."""
    a, e, t, q = split_params(p)
    ce1 = _spow(torch.cos(eta), e[0])
    x = a[0] * ce1 * _spow(torch.cos(omega), e[1])
    y = a[1] * ce1 * _spow(torch.sin(omega), e[1])
    z = a[2] * _spow(torch.sin(eta), e[0]) * torch.ones_like(x)
    pts = torch.stack([x, y, z], dim=-1)
    if frame == "body":
        return pts
    return quat.rotate(pts.reshape(-1, 3), q[None, :]).reshape(pts.shape) \
        + t


def surface_normal(p: torch.Tensor, eta: torch.Tensor, omega: torch.Tensor,
                   frame: str = "world") -> torch.Tensor:
    """The closed-form outward unit normal n(η, ω) (the scanner's
    ``sq::normal``): ∝ [cos^(2−e1)(η)·cos^(2−e2)(ω)/a1,
    cos^(2−e1)(η)·sin^(2−e2)(ω)/a2, sin^(2−e1)(η)/a3], signed powers;
    parallel to ∇F at :func:`surface_point`."""
    a, e, t, q = split_params(p)
    ce = _spow(torch.cos(eta), 2.0 - e[0])
    nx = ce * _spow(torch.cos(omega), 2.0 - e[1]) / a[0]
    ny = ce * _spow(torch.sin(omega), 2.0 - e[1]) / a[1]
    nz = _spow(torch.sin(eta), 2.0 - e[0]) / a[2] * torch.ones_like(nx)
    n = torch.stack([nx, ny, nz], dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    if frame == "body":
        return n
    return quat.rotate(n.reshape(-1, 3), q[None, :]).reshape(n.shape)


def map_eta_omega(points: torch.Tensor, p: torch.Tensor):
    """The inverse parameterization (the scanner's ``sq::map_eta`` and
    ``map_omega``): world points (..., 3) -> (η, ω) of the surface point
    on the same ray from the center; η from the x or the y branch,
    whichever |cos ω| or |sin ω| conditions better."""
    a, e, t, q = split_params(p)
    body = quat.rotate(points.reshape(-1, 3) - t[None, :],
                       quat.conjugate(q)[None, :]).reshape(points.shape)
    x, y, z = body[..., 0] / a[0], body[..., 1] / a[1], body[..., 2] / a[2]
    omega = torch.atan2(_spow(y, 1.0 / e[1]), _spow(x, 1.0 / e[1]))
    cw, sw = torch.cos(omega), torch.sin(omega)
    one = torch.ones_like(cw)
    ce1 = torch.where(torch.abs(cw) > torch.abs(sw),
                      x / torch.where(cw == 0, one, _spow(cw, e[1])),
                      y / torch.where(sw == 0, one, _spow(sw, e[1])))
    eta = torch.atan2(_spow(z, 1.0 / e[0]), _spow(ce1, 1.0 / e[0]))
    return eta, omega


def surface_angles(n_theta: int, n_gamma: int, dtype=torch.float32,
                   device=None):
    """The angles of :func:`sample_surface`: ``arange(-π, π, 2π/n_theta)``
    and ``arange(-π/2, π/2, π/n_gamma)`` in ``dtype``, formed by numpy: its
    values and its count (n + 1 at some n, 61 among them) are the JAX
    package's to the bit, and ``torch.arange``'s are not."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    theta = np.arange(-np.pi, np.pi, 2 * np.pi / n_theta, dtype=np_dtype)
    gamma = np.arange(-np.pi / 2, np.pi / 2, np.pi / n_gamma, dtype=np_dtype)
    return (torch.from_numpy(theta).to(device),
            torch.from_numpy(gamma).to(device))


def sample_surface(p: torch.Tensor, n_theta: int = 64, n_gamma: int = 32,
                   dtype=torch.float32) -> torch.Tensor:
    """Closed-form surface samples of one superquadric ``p`` (12,), posed
    in the world frame -> (T·G, 3) (``sqtpu/ops/geometry.py:279``), over
    the grid of :func:`surface_angles`."""
    a, e, t, q = split_params(p)
    theta, gamma = surface_angles(n_theta, n_gamma, dtype, p.device)
    ct, st = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    cg, sg = torch.cos(gamma)[None, :], torch.sin(gamma)[None, :]
    # the JAX package promotes the angles' dtype to the params' where
    # they meet them; a 0-dim tensor does not promote in torch
    res = torch.promote_types(p.dtype, dtype)
    sx, sy = torch.sign(cg * ct).to(res), torch.sign(cg * st).to(res)
    ct, st, cg, sg = (v.to(res) for v in (ct, st, cg, sg))
    x = a[0] * sx * torch.abs(cg) ** e[0] * torch.abs(ct) ** e[1]
    y = a[1] * sy * torch.abs(cg) ** e[0] * torch.abs(st) ** e[1]
    z = a[2] * _spow(sg, e[0]) * torch.ones_like(ct)
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    return quat.rotate(pts, q[None, :]) + t[None, :]


def pose_matrix(p: torch.Tensor) -> torch.Tensor:
    """The 4x4 homogeneous world-from-superquadric transform of (..., 12)
    params (the scanner's ``hmatrix``): R(q) and t."""
    _, _, t, q = split_params(p)
    m = torch.zeros(p.shape[:-1] + (4, 4), dtype=p.dtype, device=p.device)
    m[..., :3, :3] = quat.to_matrix(q)
    m[..., :3, 3] = t
    m[..., 3, 3] = 1.0
    return m


def pose_inverse(m: torch.Tensor) -> torch.Tensor:
    """The inverse of rigid 4x4 transforms (..., 4, 4): Rᵀ and −Rᵀt."""
    rt = m[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(m)
    out[..., :3, :3] = rt
    out[..., :3, 3] = -torch.einsum("...ij,...j->...i", rt, m[..., :3, 3])
    out[..., 3, 3] = 1.0
    return out


def signed_distance(points: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Signed radial distance |r0|·(1 − F^(−e1/2)) (the scanner's
    ``sq::sdistance``): positive outside, negative inside, zero on the
    surface. Shapes as :func:`field_points`."""
    f = field_points(points, p, guard=True)
    r0 = torch.linalg.vector_norm(points - p[..., None, POS_SLICE], dim=-1)
    return r0 * (1.0 - torch.pow(f, -0.5))


def radial_distance(points: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Radial point-to-surface distance |r0|·|1 − F^(−e1/2)| (the
    scanner's ``sq::distance``). Shapes as :func:`field_points`."""
    f = field_points(points, p, guard=True)
    r0 = torch.linalg.vector_norm(points - p[..., None, POS_SLICE], dim=-1)
    return r0 * torch.abs(1.0 - torch.pow(f, -0.5))


def transform_params(p: torch.Tensor, q2: torch.Tensor,
                     t2: torch.Tensor) -> torch.Tensor:
    """A rigid pose (q2, t2) applied to a superquadric (the scanner's
    ``sq::transform_g``): q' = q2·q, t' = R(q2)·t + t2; sizes and shape
    unchanged. Broadcasts over leading dims."""
    a, e, t, q = split_params(p)
    t_new, q_new = quat.rotate(t, q2) + t2, quat.multiply(q2, q)
    lead = t_new.shape[:-1]
    return join_params(SQParams(a=a.expand(lead + (3,)),
                                e=e.expand(lead + (2,)), t=t_new, q=q_new))


def betaln(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """log B(x, y) = lgamma(x) + lgamma(y) − lgamma(x + y) (torch has no
    betaln; the JAX package takes ``jax.scipy.special.betaln``)."""
    return torch.lgamma(x) + torch.lgamma(y) - torch.lgamma(x + y)


def _beta(x, y):
    return torch.exp(betaln(x, y))


def volume(p: torch.Tensor) -> torch.Tensor:
    """Analytic volume 2·a1a2a3·e1e2·B(e1/2+1, e1)·B(e2/2, e2/2); a sphere
    (e = (1, 1)) gives 4/3·π·a³."""
    a, e, _, _ = split_params(p)
    e1, e2 = e[..., 0], e[..., 1]
    prod_a = a[..., 0] * a[..., 1] * a[..., 2]
    return (2.0 * prod_a * e1 * e2
            * _beta(e1 / 2 + 1, e1) * _beta(e2 / 2, e2 / 2))


def inertia(p: torch.Tensor) -> torch.Tensor:
    """Principal moments (Ixx, Iyy, Izz) about the superquadric's own
    frame at unit density (Jaklič/Solina closed forms); a sphere of radius
    a gives 8πa⁵/15 for each."""
    a, e, _, _ = split_params(p)
    a1, a2, a3 = a[..., 0], a[..., 1], a[..., 2]
    e1, e2 = e[..., 0], e[..., 1]
    coef = 0.5 * a1 * a2 * a3 * e1 * e2
    b_xy = _beta(1.5 * e2, 0.5 * e2) * _beta(0.5 * e1, 2.0 * e1 + 1.0)
    b_z = 4.0 * _beta(0.5 * e2, 0.5 * e2 + 1.0) * _beta(1.5 * e1, e1 + 1.0)
    ixx = coef * (a2**2 * b_xy + a3**2 * b_z)
    iyy = coef * (a1**2 * b_xy + a3**2 * b_z)
    izz = coef * (a1**2 + a2**2) * b_xy
    return torch.stack([ixx, iyy, izz], dim=-1)


def z_support_window(a: torch.Tensor, rot: torch.Tensor, t: torch.Tensor,
                     n_sweep: int):
    """(z_lo, z_hi, step) of the renderer's bounded z-sweep: the support
    of the body box [-a, a] along world z, clipped to [0, 1]."""
    h = (torch.abs(rot[..., 0, 2]) * a[..., 0]
         + torch.abs(rot[..., 1, 2]) * a[..., 1]
         + torch.abs(rot[..., 2, 2]) * a[..., 2])
    z_lo = torch.clamp(t[..., 2] - h, 0.0, 1.0)
    z_hi = torch.minimum(torch.maximum(t[..., 2] + h, z_lo + 1e-6),
                         torch.ones_like(z_lo))
    step = (z_hi - z_lo) / (n_sweep - 1)
    return z_lo, z_hi, step
