"""The work a kernel's inputs need, counted as the port's kernels were
counted when this benchmark was written: frozen copies of the packing and
the exact-zero cull of ``sqtpu_torch/ops/kernels/sq_field.py``,
``implicit.py``, ``explicit.py`` and ``hardrender.py`` (the parts that
count; none of the arithmetic that computes a loss or an image).

* K3 (the hard ray-caster): the inside tests the kernel makes, which skip
  the slabs its ray-box interval rules out (:func:`k3_tests`).
* K1/K2 (the implicit loss): the (x, y, z) points left after the cull on
  the window of each sample (:func:`k1k2_points`).
* K4 (the explicit loss, value and gradient): the lattice points left
  after the cull (:func:`k4_points`).

A point the cull drops has occupancy exactly 0 and moves no output, so a
kernel that skips more points than these still did all the work these
count: a share of a bound built on them cannot pass 100%.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from perfbench.reference import geometry
from perfbench.reference import quaternion as quat

N_PAR = 17                  # frame scalars: a(3), e(2), t_rot(3), R(9)
PAR_STRIDE = 24             # floats a sample in every packed row
SLOT_JLO, SLOT_JHI, SLOT_X0 = 17, 18, 19
IMPLICIT_Z_MARGIN = 0.05
EXPLICIT_SHARP, EXPLICIT_Z_MARGIN = 5.0, 0.08
EXP_OVERFLOW = {torch.float32: 88.73, torch.float64: 709.79}
FINITE_LOG = {torch.float32: 87.0, torch.float64: 707.0}
CULL_MARGIN = 1.05


# -- the field's per-sample constants and the cull (sq_field) -------------

class _Recip(NamedTuple):
    ia: list
    c: list
    ic: list


def _recip(par: torch.Tensor) -> _Recip:
    ia = [1.0 / par[:, i:i + 1] for i in range(3)]
    c = [par[:, k:k + 1] * ia[i] for i, k in enumerate((10, 13, 16))]
    return _Recip(ia, c, [1.0 / x for x in c])


def _body_origin(par: torch.Tensor, k: _Recip, X, Y) -> list:
    return [(par[:, 8 + 3 * i:9 + 3 * i] * X + par[:, 9 + 3 * i:10 + 3 * i]
             * Y - par[:, 5 + i:6 + i]) * k.ia[i] for i in range(3)]


def cull_sound(par: torch.Tensor) -> torch.Tensor:
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
    one = torch.ones((), dtype=dtype)
    return torch.sqrt(CULL_MARGIN * one * (1.0 + EXP_OVERFLOW[dtype] * one
                                           / sharp))


def _box_planes(k: _Recip, origin: list, bb, last: int):
    inf = origin[0].new_tensor(math.inf)
    zl, zu = -inf, inf
    for u0, ic in zip(origin, k.ic):
        flat = ~(ic.abs() <= torch.finfo(ic.dtype).max)
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


# -- packing (the wrappers' torch side) ----------------------------------

def frame_params(p: torch.Tensor) -> torch.Tensor:
    pp = geometry.clamp_params(p)
    a, e, t, q = geometry.split_params(pp)
    rot = quat.to_matrix(quat.conjugate(q))
    tr = torch.einsum("bij,bj->bi", rot, t)
    return torch.cat([a, e, tr, rot.reshape(-1, 9),
                      pp.new_zeros((pp.shape[0], PAR_STRIDE - N_PAR))],
                     dim=-1)


def _support(p: torch.Tensor):
    pp = geometry.clamp_params(p.to(torch.float32))
    a, e, t, q = geometry.split_params(pp)
    rot = quat.to_matrix(quat.conjugate(q))
    zlo, zhi, _ = geometry.z_support_window(a, rot, t, 2)
    return zlo, zhi


def _with_window(par: torch.Tensor, jlo, jhi) -> torch.Tensor:
    tail = torch.zeros((par.shape[0], PAR_STRIDE - N_PAR), dtype=par.dtype,
                       device=par.device)
    tail[:, SLOT_JLO - N_PAR] = jlo
    tail[:, SLOT_JHI - N_PAR] = jhi
    return torch.cat([par[:, :N_PAR], tail], dim=-1).contiguous()


def implicit_pack(pred_p: torch.Tensor, n: int) -> torch.Tensor:
    """K1/K2's (B, 24) rows for these predictions: the frame scalars and
    each sample's z window ± IMPLICIT_Z_MARGIN on the n-point axis."""
    zlo, zhi = _support(pred_p)
    zlo = torch.clamp(zlo - IMPLICIT_Z_MARGIN, 0.0, 1.0)
    zhi = torch.clamp(zhi + IMPLICIT_Z_MARGIN, 0.0, 1.0)
    jlo = torch.ceil(zlo * (n - 1))
    jhi = torch.maximum(torch.floor(zhi * (n - 1)), jlo)
    return _with_window(frame_params(pred_p.float()), jlo, jhi)


def explicit_pack(true_p: torch.Tensor, pred_p: torch.Tensor, n: int,
                  sharp: float):
    """K4's two (B, 24) rows: the true and the predicted frame scalars,
    the predicted row carrying the union window ± the sharpness's
    margin on the (N+1)-point axis."""
    margin = max(EXPLICIT_Z_MARGIN * EXPLICIT_SHARP / sharp, 0.02)
    lo_t, hi_t = _support(true_p)
    lo_p, hi_p = _support(pred_p)
    zlo = torch.clamp(torch.minimum(lo_t, lo_p) - margin, 0.0, 1.0)
    zhi = torch.clamp(torch.maximum(hi_t, hi_p) + margin, 0.0, 1.0)
    jlo = torch.ceil(zlo * n)
    jhi = torch.maximum(torch.floor(zhi * n), jlo)
    par_t = frame_params(true_p.float()).contiguous()
    return par_t, _with_window(frame_params(pred_p.float()), jlo, jhi)


def _plane(par: torch.Tensor, n: int, n_cols: int):
    dev = par.device
    idx = torch.arange(n * n_cols, device=dev)
    xi = (idx // n)[None, :] + par[:, SLOT_X0].to(torch.int64)[:, None]
    yi = (idx % n)[None, :].expand_as(xi)
    inv = 1.0 / (n - 1)
    X = torch.where(xi == 0, 1e-4, xi.to(par.dtype) * inv)
    Y = torch.where(yi == 0, 1e-4, yi.to(par.dtype) * inv)
    lo = par[:, SLOT_JLO].to(torch.int64)[:, None]
    hi = par[:, SLOT_JHI].to(torch.int64)[:, None]
    return X, Y, lo.expand_as(X), hi.expand_as(X)


# -- the counts ----------------------------------------------------------

@torch.no_grad()
def k1k2_points(pred_p: torch.Tensor, n: int, tau: float,
                sharp: float) -> int:
    """Points K1 evaluates after the cull (and K2, for finite cotangents):
    Σ over the n² pixels of the planes each sweeps."""
    par = implicit_pack(pred_p, n)
    X, Y, lo, hi = _plane(par, n, n)
    a, b = lo, hi
    if 0.0 < sharp < math.inf and 0.0 <= tau < math.inf:
        k = _recip(par)
        origin = _body_origin(par, k, X, Y)
        bb = box_half_width(sharp, par.dtype).to(par.device)
        j0, j1 = _box_planes(k, origin, bb, n - 1)
        on = cull_sound(par)[:, None].expand_as(X)
        a = torch.where(on, torch.maximum(lo, j0), lo)
        b = torch.where(on, torch.minimum(hi, j1), hi)
        empty = a > b
        a, b = torch.where(empty, lo, a), torch.where(empty, lo - 1, b)
    return int((b - a + 1).sum())


@torch.no_grad()
def k4_points(true_p: torch.Tensor, pred_p: torch.Tensor, n: int,
              sharp: float) -> int:
    """Lattice points K4 evaluates after the cull: Σ over the (N+1)²
    columns of the planes each sweeps."""
    par_t, par_p = explicit_pack(true_p, pred_p, n, sharp)
    X, Y, j0, j1 = _plane(par_p, n + 1, n + 1)
    kt, kp = _recip(par_t), _recip(par_p)
    bb = box_half_width(sharp, par_p.dtype).to(par_p.device)
    jt0, jt1 = _box_planes(kt, _body_origin(par_t, kt, X, Y), bb, n)
    jp0, jp1 = _box_planes(kp, _body_origin(par_p, kp, X, Y), bb, n)
    on = ((cull_sound(par_t) & cull_sound(par_p))[:, None]
          & (0.0 < sharp < math.inf))
    j0 = torch.where(on, torch.maximum(j0, torch.minimum(jt0, jp0)), j0)
    j1 = torch.where(on, torch.minimum(j1, torch.maximum(jt1, jp1)), j1)
    return int((j1 - j0 + 1).clamp(min=0).sum())


def _frames(p: torch.Tensor, n_sweep: int) -> torch.Tensor:
    """K3's (B, 24) rows (the hard renderer's frame scalars and sweep)."""
    p = p.to(torch.float32)
    b = p.shape[0]
    a, e, t, q = geometry.split_params(p)
    rot = quat.to_matrix(quat.conjugate(q))
    tr = torch.einsum("bij,bj->bi", rot, t)
    _, z_hi, step = geometry.z_support_window(a, rot, t, n_sweep)
    return torch.cat([
        a, (1.0 / e[:, 1])[:, None], (e[:, 1] / e[:, 0])[:, None],
        (1.0 / e[:, 0])[:, None], tr, rot.reshape(b, 9),
        z_hi[:, None], step[:, None], p.new_zeros((b, PAR_STRIDE - 20)),
    ], dim=-1).contiguous()


class _Pixels:
    def __init__(self, par: torch.Tensor, s: int):
        b = par.shape[0]

        def c(k):
            return par[:, k].reshape(b, 1, 1)

        idx = torch.arange(s, device=par.device, dtype=torch.float32)
        inv = torch.ones((), dtype=torch.float32, device=par.device) / (s - 1)
        X = (idx * inv)[None, None, :]
        Y = (torch.flip(idx, (0,)) * inv)[None, :, None]
        self.origin = [(c(9 + 3 * i) * X + c(10 + 3 * i) * Y - c(6 + i))
                       / c(i) for i in range(3)]
        self.slope = [c(11 + 3 * i) / c(i) for i in range(3)]
        self.ie2, self.e21, self.ie1 = c(3), c(4), c(5)
        self.z_hi, self.step = c(18), c(19)

    def inside(self, z: torch.Tensor) -> torch.Tensor:
        u, v, w = (o + k * z for o, k in zip(self.origin, self.slope))
        tiny = torch.finfo(torch.float32).tiny
        A = torch.exp(torch.log(u * u + tiny) * self.ie2)
        B = torch.exp(torch.log(v * v + tiny) * self.ie2)
        C = torch.exp(torch.log(w * w + tiny) * self.ie1)
        E = torch.exp(torch.log(A + B + tiny) * self.e21)
        return E + C <= 1.0


def _slab_range(par: torch.Tensor, px: _Pixels, n_sweep: int):
    p = par.to(torch.float64)
    ie2, e21, ie1 = p[:, 3], p[:, 4], p[:, 5]
    low = torch.minimum(torch.minimum(ie1, ie2), ie2 * e21)
    on = (torch.isfinite(par[:, :20]).all(dim=-1) & (low >= 0.01)
          & (par[:, :3] > 0).all(dim=-1) & (par[:, 19] > 0))
    delta = 1e-3 * torch.clamp(1.0 / low, min=1.0)
    z_hi, step = p[:, 18], p[:, 19]
    zmax = torch.abs(z_hi) + (n_sweep - 1) * step

    def per_sample(x):
        return x.reshape(-1, 1, 1)

    lo = torch.full(px.origin[0].shape, -math.inf, dtype=torch.float64,
                    device=par.device)
    hi = torch.full_like(lo, math.inf)
    empty = torch.zeros_like(lo, dtype=torch.bool)
    finite = torch.ones_like(empty)
    for u0, c in zip(px.origin, px.slope):
        finite &= torch.abs(u0) <= torch.finfo(torch.float32).max
        u0, c = u0.to(torch.float64), c.to(torch.float64)
        b = 1.0 + per_sample(delta) + 2.0 ** -20 * (
            torch.abs(u0) + torch.abs(c) * per_sample(zmax))
        flat = c == 0
        ic = 1.0 / torch.where(flat, 1.0, c)
        za, zb = (-b - u0) * ic, (b - u0) * ic
        empty |= flat & ~(torch.abs(u0) <= b)
        lo = torch.where(flat, lo, torch.maximum(lo, torch.minimum(za, zb)))
        hi = torch.where(flat, hi, torch.minimum(hi, torch.maximum(za, zb)))
    empty |= ~(lo <= hi)
    first = torch.ceil((per_sample(z_hi) - hi) * per_sample(1.0 / step))
    last = torch.floor((per_sample(z_hi) - lo) * per_sample(1.0 / step))
    j0 = torch.where(first > 0, torch.clamp(first, max=n_sweep), 0.0)
    j1 = torch.where(last < n_sweep - 1, torch.clamp(last, min=-1.0),
                     n_sweep - 1.0)
    j1 = torch.where(empty, -1.0, j1)
    full = ~(per_sample(on) & finite)
    j0 = torch.where(full, 0.0, torch.where(empty, 0.0, j0))
    j1 = torch.where(full, n_sweep - 1.0, j1)
    return j0.to(torch.int64), j1.to(torch.int64)


@torch.no_grad()
def k3_tests(p: torch.Tensor, image_size: int, n_sweep: int,
             n_bisect: int, rows: int = 64) -> int:
    """Inside tests K3 makes on (B, 12) shapes: a pixel that first hits at
    slab j makes j − j0 + 1 tests and n_bisect more, a miss j1 − j0 + 1
    (the sweep kept to the pixel's ray-box interval [j0, j1])."""
    total = 0
    for lo in range(0, p.shape[0], rows):
        par = _frames(p[lo:lo + rows], n_sweep)
        px = _Pixels(par, image_size)
        j0, j1 = _slab_range(par, px, n_sweep)
        first = torch.full_like(j0, n_sweep)
        for j in range(n_sweep):
            z = px.z_hi - j * px.step
            newly = (px.inside(z) & (j0 <= j) & (j <= j1)
                     & (first == n_sweep))
            first = torch.where(newly, j, first)
        hit = first < n_sweep
        tests = torch.where(hit, first - j0 + 1 + n_bisect,
                            torch.clamp(j1 - j0 + 1, min=0))
        total += int(tests.sum())
    return total
