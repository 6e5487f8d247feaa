"""Quaternion algebra in PyTorch, xyzw layout (w last).

Counterpart of ``sqtpu/ops/quaternion.py``: the same conventions (Hamilton
product, w last, ``to_matrix(q) @ p`` rotates ``p`` by ``q``), dtype
preserving and broadcasting over leading batch dimensions. Only the
functions the port's paths need are here, ``slerp`` and the angle
conversions of the diagnostics among them.
"""

from __future__ import annotations

import math

import torch


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2 in xyzw layout; broadcasts over leading dims."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    x = x1 * w2 + y1 * z2 - z1 * y2 + w1 * x2
    y = -x1 * z2 + y1 * w2 + z1 * x2 + w1 * y2
    z = x1 * y2 - y1 * x2 + z1 * w2 + w1 * z2
    w = -x1 * x2 - y1 * y2 - z1 * z2 + w1 * w2
    return torch.stack([x, y, z, w], dim=-1)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    """(-x, -y, -z, w): the vector part negated, which is exact, so every
    value keeps its bits (a NaN stays a NaN). No constant is copied to
    the device: from pageable host memory that copy would wait for the
    card's queue to drain at every call."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> 3x3 rotation matrix, shape (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    # x + x, not 2.0 * x: the same bits, and forward-mode AD of a 0-dim
    # tensor times a Python float gives a float64 tangent (torch 2.13)
    tx, ty, tz = x + x, y + y, z + z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz = ty * y, tz * y
    tzz = tz * z
    m = torch.stack(
        [
            1.0 - (tyy + tzz), txy - twz, txz + twy,
            txy + twz, 1.0 - (txx + tzz), tyz - twx,
            txz - twy, tyz + twx, 1.0 - (txx + tyy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Project onto the unit sphere (safe at 0)."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def rotate(point: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vector(s) ``point`` (..., 3) by unit quaternion(s) q:
    q * p * q⁻¹, broadcasting over leading dims."""
    p4 = torch.cat([point, torch.zeros_like(point[..., :1])], dim=-1)
    return multiply(multiply(q, p4), conjugate(q))[..., :3]


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion, xyzw layout.

    Shepperd's method: of the four reconstructions (from w, x, y or z) the
    one with the largest pivot is taken per element, so every rotation is
    well conditioned, trace −1 included (``sqtpu/ops/quaternion.py:85``).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    pivots = [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22,
              1.0 + m22 - m00 - m11]
    cases = torch.stack([
        torch.stack([m21 - m12, m02 - m20, m10 - m01, pivots[0]], dim=-1),
        torch.stack([pivots[1], m01 + m10, m02 + m20, m21 - m12], dim=-1),
        torch.stack([m01 + m10, pivots[2], m12 + m21, m02 - m20], dim=-1),
        torch.stack([m02 + m20, m12 + m21, pivots[3], m10 - m01], dim=-1),
    ], dim=-2)  # (..., 4 cases, 4)
    best = torch.argmax(torch.stack(pivots, dim=-1), dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return normalize(torch.gather(cases, -2, idx)[..., 0, :])


def to_magnitude(q: torch.Tensor) -> torch.Tensor:
    """Rotation angle of q: 2·atan2(‖xyz‖, w)."""
    return 2.0 * torch.atan2(torch.linalg.vector_norm(q[..., :3], dim=-1),
                             q[..., 3])


def to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """(x, y, z, angle): the rotation's axis scaled by 1/sin(acos w + 1e-8)
    and its angle 2·(acos w + 1e-8) (``sqtpu/ops/quaternion.py:121``)."""
    xyz, w = q[..., :3], q[..., 3:]
    w_acos = torch.acos(torch.clamp(w, -1.0, 1.0)) + 1e-8
    return torch.cat([xyz / torch.sin(w_acos), 2.0 * w_acos], dim=-1)


def to_euler(q: torch.Tensor) -> torch.Tensor:
    """(phi, theta, gamma) in the reference's convention
    (``sqtpu/ops/quaternion.py:135``), its quirk kept: theta is
    acos(−|q|²), constantly π for a unit quaternion."""
    qi, qj, qk, qr = q.unbind(-1)
    phi = torch.atan2(qi * qk + qj * qr, -(qj * qk - qi * qr))
    theta = torch.acos(torch.clamp(-(qi ** 2) - qj ** 2 - qk ** 2 - qr ** 2,
                                   -1.0, 1.0))
    gamma = torch.atan2(qi * qk - qj * qr, qj * qk + qi * qr)
    return torch.stack([phi, theta, gamma], dim=-1)


def slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation from ``q0`` to ``q1`` at the
    fractions ``t`` -> ``t.shape + (4,)``, branch free as the JAX package's
    (``sqtpu/ops/quaternion.py:173``): ``q1`` flipped to the hemisphere of
    ``q0``, a safe divisor where sin θ0 vanishes, and the normalized lerp
    where the dot exceeds 0.9995."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    dot = torch.sum(q0 * q1, dim=-1)
    q1 = torch.where(dot < 0.0, -q1, q1)
    dot = torch.abs(dot)
    dot_c = torch.clamp(dot, -1.0, 1.0)
    theta0 = torch.acos(dot_c)
    sin_theta0 = torch.sin(theta0)
    theta = theta0 * t[..., None]
    # the safe divisor's result is discarded where it applies
    safe_sin = torch.where(sin_theta0 > 1e-6, sin_theta0,
                           torch.ones_like(sin_theta0))
    s0 = torch.cos(theta) - dot_c * torch.sin(theta) / safe_sin
    s1 = torch.sin(theta) / safe_sin
    slerped = s0 * q0 + s1 * q1
    lerped = normalize(q0 + t[..., None] * (q1 - q0))
    return torch.where(dot > 0.9995, lerped, slerped)


def random_uniform(shape: tuple, generator: torch.Generator,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """Shoemake-uniform random unit quaternions, shape ``shape + (4,)``,
    drawn from ``generator`` (same distribution as the JAX package's
    ``random_uniform``; not the same numbers)."""
    u = torch.rand(tuple(shape) + (3,), generator=generator, dtype=dtype,
                   device=device)
    u0, u1, u2 = u.unbind(-1)
    two_pi = 2.0 * math.pi
    return torch.stack(
        [
            torch.sqrt(1.0 - u0) * torch.sin(two_pi * u1),
            torch.sqrt(1.0 - u0) * torch.cos(two_pi * u1),
            torch.sqrt(u0) * torch.sin(two_pi * u2),
            torch.sqrt(u0) * torch.cos(two_pi * u2),
        ],
        dim=-1,
    )
