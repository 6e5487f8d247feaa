"""The superquadric field, its gradient chain and the exact-zero cull in
torch: the emulation's counterpart of ``sqtpu_torch/csrc/sq_field.cuh``,
shared by the emulations of the implicit-loss kernels (K1/K2,
``implicit.py``) and of the explicit-loss kernels (K4/K5,
``explicit.py``).

* :func:`_recip`, :func:`_body_origin`, :func:`_field_terms_lin`,
  :func:`_occupancy`, :func:`_sep_grad_step` and :func:`_sep_finish` are
  the chain of K1, K2, K4 and K5: per-sample reciprocals, body
  coordinates linear in z along a lattice column, 11 running sums a column.
* :func:`cull_sound`, :func:`box_half_width` and :func:`_box_planes` are
  the exact-zero cull: a point outside a frame's box |u|, |v|, |w| ≤ bb
  has occupancy exactly 0 under that frame, for rows whose values the
  proof (``csrc/sq_field.cuh``) covers.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

N_PAR = 17  # frame scalars: a(3), e(2), t_rot(3), R(9)
# The gradient's exponentials are assembled in log space with the exponent
# clamped: far outside the occupancy shell they overflow while their
# cotangent is exactly 0, and inf·0 would give NaN.
CLAMP = 30.0
EXPCLAMP = 1.0686475e13  # exp(CLAMP) in float32
# The exact-zero cull: exp overflows above log(max) of the dtype (88.7228
# in float32, 709.78 in float64), where the occupancy 1/(1 + exp(sharp·(F −
# 1))) is exactly 0; a column sweeps the planes where |u|, |v| and |w| ≤
# sqrt(CULL_MARGIN·(1 + EXP_OVERFLOW/sharp)), on rows that keep every
# log-domain value below FINITE_LOG.
EXP_OVERFLOW = {torch.float32: 88.73, torch.float64: 709.79}
FINITE_LOG = {torch.float32: 87.0, torch.float64: 707.0}
CULL_MARGIN = 1.05


def _ex(logterm: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(logterm, max=CLAMP))


class _Recip(NamedTuple):
    """The per-sample constants of one frame row (sq_field.cuh
    ``make_recip``), each (B, 1)."""
    ia: list    # 1/a1, 1/a2, 1/a3
    c: list     # slopes of u, v, w in z: R[., 2]/a
    ic: list    # their reciprocals
    e1: torch.Tensor
    e2: torch.Tensor
    ie1: torch.Tensor
    ie2: torch.Tensor
    e21: torch.Tensor


def _recip(par: torch.Tensor) -> _Recip:
    ia = [1.0 / par[:, i:i + 1] for i in range(3)]
    c = [par[:, k:k + 1] * ia[i] for i, k in enumerate((10, 13, 16))]
    e1, e2 = par[:, 3:4], par[:, 4:5]
    return _Recip(ia, c, [1.0 / x for x in c], e1, e2, 1.0 / e1, 1.0 / e2,
                  e2 / e1)


def _body_origin(par: torch.Tensor, k: _Recip, X, Y) -> list:
    """u, v, w of each column at z = 0: (R[., :2]·(X, Y) − t_rot)/a."""
    return [(par[:, 8 + 3 * i:9 + 3 * i] * X + par[:, 9 + 3 * i:10 + 3 * i]
             * Y - par[:, 5 + i:6 + i]) * k.ia[i] for i in range(3)]


def _field_terms_lin(k: _Recip, u, v, w) -> dict:
    """The redesigned field chain (sq_field.cuh ``field_terms_lin``) on
    body coordinates u, v, w."""
    x2, y2, z2 = u * u, v * v, w * w
    x2g = x2 + (x2 == 0).to(x2.dtype) * 1e-4
    y2g = y2 + (y2 == 0).to(y2.dtype) * 1e-4
    z2g = z2 + (z2 == 0).to(z2.dtype) * 1e-4
    lx, ly, lz = torch.log(x2g), torch.log(y2g), torch.log(z2g)
    tiny = torch.finfo(u.dtype).tiny
    lg = torch.log(torch.exp(lx * k.ie2) + torch.exp(ly * k.ie2) + tiny)
    lh = torch.log(torch.exp(lg * k.e21) + torch.exp(lz * k.ie1) + tiny)
    return dict(u=u, v=v, w=w, x2g=x2g, y2g=y2g, z2g=z2g, lx=lx, ly=ly,
                lz=lz, lg=lg, lh=lh, F=torch.exp(lh * k.e1))


def _occupancy(F, sharp: float):
    """The kernels' sigmoid, 1/(1 + exp(−sharp·(1 − F))): exactly 0 where
    exp overflows."""
    return 1.0 / (1.0 + torch.exp(-(sharp * (1.0 - F))))


SEP_SUMS = ("gu", "gv", "gw", "de1", "de2", "gx", "gy", "gz", "gxz", "gyz",
            "gzz")


def _sep_grad_step(acc: dict, T: dict, gF, k: _Recip, z, active) -> None:
    """Add one plane to a column's 11 running sums (sq_field.cuh
    ``sep_grad_step``) where ``active`` holds: a column that does not sweep
    the plane adds nothing (not gF·terms, which may be inf·0 there)."""
    lfh = (k.e1 - 1.0) * T["lh"]
    lxy = lfh + (k.e21 - 1.0) * T["lg"]
    dF_dx2 = _ex(lxy + (k.ie2 - 1.0) * T["lx"])
    dF_dy2 = _ex(lxy + (k.ie2 - 1.0) * T["ly"])
    dF_dz2 = _ex(lfh + (k.ie1 - 1.0) * T["lz"])
    g = [gF * dF_dx2 * 2.0 * T["u"], gF * dF_dy2 * 2.0 * T["v"],
         gF * dF_dz2 * 2.0 * T["w"]]
    ex_le = _ex(lfh + k.e21 * T["lg"])
    lg, lh = T["lg"], T["lh"]
    terms = {
        "gu": g[0] * T["u"], "gv": g[1] * T["v"], "gw": g[2] * T["w"],
        "de1": gF * (torch.clamp(T["F"], max=EXPCLAMP) * lh
                     - (ex_le * lg * k.e2 + dF_dz2 * T["z2g"] * T["lz"])
                     * k.ie1),
        "de2": gF * (ex_le * lg - (dF_dx2 * T["x2g"] * T["lx"] + dF_dy2
                                   * T["y2g"] * T["ly"]) * k.ie2),
        "gx": g[0], "gy": g[1], "gz": g[2],
        "gxz": g[0] * z, "gyz": g[1] * z, "gzz": g[2] * z,
    }
    for name, t in terms.items():
        acc[name] = torch.where(active, acc[name] + t, acc[name])


def _sep_finish(acc: dict, k: _Recip, X, Y) -> list:
    """A column's 17 frame-scalar terms from its running sums."""
    ia1, ia2, ia3 = k.ia
    return [-acc["gu"] * ia1, -acc["gv"] * ia2, -acc["gw"] * ia3,
            acc["de1"], acc["de2"],
            -acc["gx"] * ia1, -acc["gy"] * ia2, -acc["gz"] * ia3,
            acc["gx"] * X * ia1, acc["gx"] * Y * ia1, acc["gxz"] * ia1,
            acc["gy"] * X * ia2, acc["gy"] * Y * ia2, acc["gyz"] * ia2,
            acc["gz"] * X * ia3, acc["gz"] * Y * ia3, acc["gzz"] * ia3]


def cull_sound(par: torch.Tensor) -> torch.Tensor:
    """(B,) whether a frame row proves the cull's bounds (sq_field.cuh
    ``cull_sound``): finite, a ≥ 0.05, e in [0.1, 1], and log(S)/min(e) ≤
    FINITE_LOG with S bounding x2g + y2g and z2g over the unit cube."""
    p = par[:, :N_PAR]
    a, e = p[:, :3], p[:, 3:5]
    ok = (torch.isfinite(p).all(dim=-1) & (a.min(dim=-1).values >= 0.05)
          & ((e >= 0.1) & (e <= 1.0)).all(dim=-1))
    rot = torch.nan_to_num(p[:, 8:17]).reshape(-1, 3, 3)
    g2 = (rot.transpose(-1, -2) @ rot).abs().sum(dim=-1).max(dim=-1).values
    d = torch.sqrt(g2) * 1.7320509 + torch.linalg.vector_norm(
        torch.nan_to_num(p[:, 5:8]), dim=-1)
    amin = torch.minimum(a[:, 0], a[:, 1])
    s = torch.maximum(d * d / (amin * amin) + 2e-4,
                      d * d / (a[:, 2] * a[:, 2]) + 1e-4)
    return ok & (torch.log(s) <= FINITE_LOG[par.dtype] * e.min(dim=-1).values)


def box_half_width(sharp: float, dtype=torch.float32) -> torch.Tensor:
    """The cull's box: sqrt(1.05·(1 + EXP_OVERFLOW/sharp))."""
    one = torch.ones((), dtype=dtype)
    return torch.sqrt(CULL_MARGIN * one * (1.0 + EXP_OVERFLOW[dtype] * one
                                           / sharp))


def _box_planes(k: _Recip, origin: list, bb, last: int):
    """The planes [j0, j1] whose z (z_j = j/last, ``last`` the lattice's
    last index: N on the explicit lattice, n − 1 on the implicit one) lies
    in the interval where one frame's |u|, |v|, |w| ≤ bb (sq_field.cuh
    ``box_planes``); j0 > j1 when none."""
    inf = origin[0].new_tensor(math.inf)
    zl, zu = -inf, inf
    for u0, ic in zip(origin, k.ic):
        flat = ~(ic.abs() <= torch.finfo(ic.dtype).max)  # u = u0 at every z
        za, zb = (-bb - u0) * ic, (bb - u0) * ic
        out = ~(u0.abs() <= bb)
        zl = torch.where(flat, torch.where(out, inf, zl),
                         torch.maximum(zl, torch.minimum(za, zb)))
        zu = torch.where(flat, torch.where(out, -inf, zu),
                         torch.minimum(zu, torch.maximum(za, zb)))
    fn = float(last)
    j0 = torch.where(zl <= 1e-4, 0.0, torch.ceil(torch.clamp(zl * fn,
                                                             max=fn + 1)))
    j1 = torch.where(zu < 1e-4, -1.0, torch.floor(torch.clamp(zu * fn,
                                                              max=fn)))
    return j0.to(torch.int64), j1.to(torch.int64)
