"""The layer under the two loss wrappers: the K1/K2/K4/K5 rows, their z
window and the lattice, and the superquadric field, its gradient chain and
the exact-zero cull in torch (the emulation's counterpart of
``sqtpu_torch/csrc/sq_field.cuh``). Shared by the implicit-loss kernels'
wrapper (K1/K2, ``implicit.py``) and the explicit-loss kernels' wrapper
(K4/K5, ``explicit.py``).

* The rows: :data:`PAR_STRIDE` floats a sample, [a(3), e(2), R(q*)·t(3),
  R(q*)(9)] (:func:`frame_params`), then the z window [j_lo, j_hi] and
  the slab's x offset in slots 17-19 (:func:`pack_row`, the window from
  :func:`z_window`), zeros after; :func:`check_operands` checks what a
  launcher takes, :func:`window_points` counts a window's points.
* :func:`_sweep_setup` and :func:`_zval` are the kernels' lattice.
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

from sqtpu_torch.ops import geometry

N_PAR = 17  # frame scalars: a(3), e(2), t_rot(3), R(9)
PAR_STRIDE = 24  # floats per sample in the packed rows
# slots 17..19 carry the z window [j_lo, j_hi] as float lattice indices and
# the x-column offset of the plane slab; 20..23 are zero
SLOT_JLO, SLOT_JHI, SLOT_X0 = 17, 18, 19
MAX_BATCH = 65535  # the kernels' grid.y
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


# ---------------------------------------------------------------------------
# The rows (sqtpu/ops/kernels/implicit.py:258-270, explicit.py:290-363)
# ---------------------------------------------------------------------------

def frame_params(p: torch.Tensor) -> torch.Tensor:
    """Clamp a (B, 12) batch and expand it to the (B, 24) frame layout
    [a(3), e(2), R(q*)·t(3), R(q*)(9), 0(7)], differentiably. Keeps a
    float64 input in float64 (the CUDA path takes float32)."""
    pp = geometry.clamp_params(p)
    a, e, tr, rot = geometry.rotated_frame(pp)
    return torch.cat([a, e, tr, rot.reshape(-1, 9),
                      pp.new_zeros((pp.shape[0], PAR_STRIDE - N_PAR))],
                     dim=-1)


@torch.no_grad()
def z_window(params, last: int, margin: float):
    """Per-sample lattice window [j_lo, j_hi] on the axis z_j = j/last
    covering the union of the clamped superquadrics' z-support boxes (one
    (B, 12) batch of ``params`` each) ± ``margin``, as float indices in
    their dtype with no gradient."""
    lo = hi = None
    for p in params:
        pp = geometry.clamp_params(p)
        a, _, _, rot = geometry.rotated_frame(pp)
        zlo, zhi, _ = geometry.z_support_window(
            a, rot, geometry.split_params(pp).t, 2)
        lo = zlo if lo is None else torch.minimum(lo, zlo)
        hi = zhi if hi is None else torch.maximum(hi, zhi)
    zlo = torch.clamp(lo - margin, 0.0, 1.0)
    zhi = torch.clamp(hi + margin, 0.0, 1.0)
    jlo = torch.ceil(zlo * last)
    jhi = torch.maximum(torch.floor(zhi * last), jlo)
    return jlo, jhi


def pack_row(p: torch.Tensor, last: int, window=None,
             x0: int = 0) -> torch.Tensor:
    """(B, 12) params -> the kernels' (B, 24) row: :func:`frame_params`
    with the z window ``(j_lo, j_hi)`` (None: the full sweep [0, last])
    and the slab's x offset in slots 17-19. Differentiable in the frame
    scalars."""
    par = frame_params(p)
    par[:, SLOT_JLO], par[:, SLOT_JHI] = ((0.0, float(last)) if window is None
                                          else window)
    par[:, SLOT_X0] = float(x0)
    return par


def check_operands(n: int, n_cols: int, rows: dict, planes=(),
                   vectors=()) -> None:
    """Raise unless each of ``rows`` (name -> tensor) is (B, 24), each of
    ``planes`` (B, n·n_cols) and each of ``vectors`` (B,), all float32,
    contiguous and on the first row's CUDA device, with B and n within
    what the kernels take: what a launcher takes."""
    device = next(iter(rows.values())).device
    b = next(iter(rows.values())).shape[0]
    if not 0 < b <= MAX_BATCH:
        raise ValueError(f"batch {b} outside the kernels' grid "
                         f"(1..{MAX_BATCH})")
    if n < 2 or not 0 < n_cols <= n:
        raise ValueError(f"need n >= 2 and 0 < n_cols <= n, got {n}, "
                         f"{n_cols}")
    want = [(name, t, (b, PAR_STRIDE)) for name, t in rows.items()]
    want += [("plane", t, (b, n * n_cols)) for t in planes]
    want += [("cotangent", t, (b,)) for t in vectors]
    for name, t, shape in want:
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


def window_points(par: torch.Tensor, columns: int) -> int:
    """In-window (x, y, z) points for these packed rows, ``columns``
    lattice columns a sample: Σ_b (j_hi − j_lo + 1) · columns."""
    span = par[:, SLOT_JHI].to(torch.int64) - par[:, SLOT_JLO].to(
        torch.int64) + 1
    return int(span.sum()) * columns


# ---------------------------------------------------------------------------
# The lattice and the field chain of the emulations
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
