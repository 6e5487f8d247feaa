"""The voxel IoU's counts as a hand-written CUDA kernel (K7).

The port's own kernel: the JAX package scores the IoU with plain ``jnp``
(``sqtpu/ops/metrics.py:25-52``), so K7 replaces no TPU kernel. Its source
is ``sqtpu_torch/csrc/voxel_iou.cu``; it is built with ``nvcc`` at first
use and called through ``ctypes``.

:func:`voxel_iou_cuda` takes several (B, 12) parameter sets (the fields)
and a table of pairs of them, and returns, per sample and pair, the voxel
counts of the intersection and of the union of the two occupancies
F^(e1) <= 1 on the N³ ``"iou"`` lattice, (B, P, 2) int64, from one launch
and with no grid in device memory. A field that two pairs share is
evaluated once per voxel. The frames are packed here in torch by the
plain path's own expressions (:func:`pack_fields`), and the kernel
repeats the plain path's arithmetic one rounding for one, so the counts
are the plain path's (:func:`sqtpu_torch.ops.metrics.iou_counts` on CPU
tensors). It launches or raises: it takes CUDA float32 and bfloat16
fields (each field in its own arithmetic, as the plain path builds each
grid in its own dtype), or float64 fields alone.

Beside it, :func:`emulate_voxel_iou` is a torch emulation of the kernel's
algorithm on the packed rows, the analogue of interpret mode: each field
is evaluated only on the z interval of its column where the cull
(:func:`z_ranges`) allows it to be occupied, or on every voxel where the
row lies outside the range the cull's proof covers, and it counts the
field evaluations it makes. The tests hold its counts to the plain
path's; the main path never calls it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from sqtpu_torch.ops import geometry
from sqtpu_torch.ops.kernels import _build

PAR_STRIDE = 24     # values per field and sample in the packed rows
MAX_FIELDS = 8
MAX_PAIRS = 8
MAX_N = 2048
# The range of exponents the cull's proof covers (csrc/voxel_iou.cu).
E_MIN, E_MAX = 1e-3, 100.0


def row_dtype(fields: Sequence[torch.Tensor]) -> torch.dtype:
    """The packed rows' dtype: float64 where every field is float64, else
    float32, which holds float32 and bfloat16 fields exactly; raises for
    any other mix."""
    dtypes = {p.dtype for p in fields}
    if dtypes == {torch.float64}:
        return torch.float64
    if dtypes <= {torch.float32, torch.bfloat16}:
        return torch.float32
    raise TypeError(f"the kernel takes float32 and bfloat16 fields, or "
                    f"float64 ones alone; got {sorted(map(str, dtypes))}")


def pack_fields(fields: Sequence[torch.Tensor]) -> torch.Tensor:
    """F (B, 12) param sets -> (B, F, 24) rows in :func:`row_dtype`: a
    (0-2), e1 (3), e2 (4), 1/e2 (5), e2/e1 (6), 1/e1 (7), R(q*)·t (8-10),
    R(q*) (11-19, row-major), 1 at 20 for a bfloat16 field, zero padding
    (21-23). Each is the plain path's expression
    (``geometry.rotated_frame``, ``geometry._power_chain``) in the field's
    own dtype, so every constant has its bits; the fields of one dtype
    are packed at once."""
    fields = list(fields)
    dtype = row_dtype(fields)
    b = fields[0].shape[0]
    rows = [None] * len(fields)
    groups = dict.fromkeys(p.dtype for p in fields)
    for dt in groups:
        idx = [i for i, p in enumerate(fields) if p.dtype == dt]
        p = torch.stack([fields[i] for i in idx], dim=1).reshape(-1, 12)
        a, e, tr, rot = geometry.rotated_frame(p)
        e1, e2 = e[:, 0], e[:, 1]
        flag = p.new_full((p.shape[0], 1), float(dt == torch.bfloat16))
        packed = torch.cat([
            a, e,
            (1.0 / e2)[:, None], (e2 / e1)[:, None], (1.0 / e1)[:, None],
            tr, rot.reshape(-1, 9), flag,
            p.new_zeros((p.shape[0], PAR_STRIDE - 21)),
        ], dim=-1).to(dtype).reshape(b, len(idx), PAR_STRIDE)
        if len(groups) == 1:
            return packed
        for j, i in enumerate(idx):
            rows[i] = packed[:, j]
    return torch.stack(rows, dim=1)


_axes: dict = {}


def axes(fields: Sequence[torch.Tensor], render_size: int) -> torch.Tensor:
    """(F, N) each field's ``"iou"`` lattice axis in its own dtype (the
    plain path's ``make_axis``), held in :func:`row_dtype`; made once for
    each size, device and list of dtypes."""
    key = (render_size, tuple(p.dtype for p in fields),
           str(fields[0].device))
    if key not in _axes:
        dtype = row_dtype(fields)
        per = {dt: geometry.make_axis(render_size, "iou", dtype=dt,
                                      device=fields[0].device).to(dtype)
               for dt in dict.fromkeys(key[1])}
        _axes[key] = torch.stack([per[dt] for dt in key[1]])
    return _axes[key]


def _check_pairs(pairs, n_fields: int) -> tuple:
    pairs = tuple((int(f), int(g)) for f, g in pairs)
    if not 0 < len(pairs) <= MAX_PAIRS:
        raise ValueError(f"{len(pairs)} pairs outside the kernel's "
                         f"1..{MAX_PAIRS}")
    if not all(0 <= i < n_fields for pair in pairs for i in pair):
        raise ValueError(f"pairs {pairs} name fields outside "
                         f"0..{n_fields - 1}")
    return pairs


_pair_tables: dict = {}


def _pair_table(pairs: tuple, device: torch.device) -> torch.Tensor:
    """The (P, 2) int32 pair table on ``device``, copied there once: a
    copy from pageable host memory would hold the host until the card's
    queue drains, at every call."""
    key = (pairs, str(device))
    if key not in _pair_tables:
        _pair_tables[key] = torch.tensor(pairs, dtype=torch.int32,
                                         device=device)
    return _pair_tables[key]


def voxel_iou_cuda(fields: Sequence[torch.Tensor], pairs,
                   render_size: int) -> torch.Tensor:
    """K7: (B, P, 2) int64 [intersection, union] voxel counts of each pair
    (f, g) of ``pairs`` (indices into ``fields``, each (B, 12)) on the
    ``render_size``³ ``"iou"`` lattice. Raises unless it launched."""
    fields = list(fields)
    if not 0 < len(fields) <= MAX_FIELDS:
        raise ValueError(f"{len(fields)} fields outside the kernel's "
                         f"1..{MAX_FIELDS}")
    pairs = _check_pairs(pairs, len(fields))
    first = fields[0]
    if first.device.type != "cuda":
        raise ValueError(f"no kernel for device {first.device}")
    row_dtype(fields)
    for p in fields:
        if p.ndim != 2 or p.shape != first.shape or p.shape[-1] != 12:
            raise ValueError(f"params must be (B, 12) alike, got "
                             f"{[tuple(q.shape) for q in fields]}")
        if p.device != first.device:
            raise ValueError("every field must be on one device")
    if first.shape[0] == 0:
        raise ValueError("batch 0 outside the kernel's grid")
    if not 1 <= render_size <= MAX_N:
        raise ValueError(f"render size {render_size} outside the kernel's "
                         f"1..{MAX_N}")
    pair_t = _pair_table(pairs, first.device)
    out = _launch(pack_fields(fields), axes(fields, render_size), pair_t)
    _build.count("K7")
    return out


def _launch(par: torch.Tensor, ax: torch.Tensor, pairs: torch.Tensor,
            lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """The kernel of ``lib`` (default: this package's) on (B, F, 24) rows
    packed by :func:`pack_fields`, the (F, N) :func:`axes` and an (P, 2)
    int32 pair table, all on the card -> (B, P, 2) int64 counts; raises
    unless it launched."""
    b, f = par.shape[:2]
    n = ax.shape[-1]
    if not (par.is_cuda and par.is_contiguous() and par.ndim == 3
            and par.shape[2] == PAR_STRIDE
            and par.dtype in (torch.float32, torch.float64)
            and ax.dtype == par.dtype and ax.is_contiguous()
            and ax.shape == (f, n)
            and ax.device == par.device and pairs.dtype == torch.int32
            and pairs.is_contiguous() and pairs.device == par.device
            and pairs.ndim == 2 and pairs.shape[1] == 2):
        raise RuntimeError("packed rows, axis or pair table have the wrong "
                           "layout")
    out = torch.zeros((b, pairs.shape[0], 2), dtype=torch.int64,
                      device=par.device)
    lib = _build.library("voxel_iou") if lib is None else lib
    _build.launch(lib, "sqtpu_voxel_iou", par.device, par.data_ptr(),
                  ax.data_ptr(), pairs.data_ptr(), out.data_ptr(), b, f,
                  pairs.shape[0], n, int(par.dtype == torch.float64),
                  what="voxel IoU")
    return out


# ---------------------------------------------------------------------------
# The emulation of the kernel's algorithm (the analogue of interpret mode)
# ---------------------------------------------------------------------------

def cull_on(par: torch.Tensor):
    """(B, F) whether the cull's proof holds for each packed row (finite,
    not a bfloat16 field, each a ≠ 0, E_MIN <= e1, e2 <= E_MAX), and its
    δ = 5e-4·max(1, e1, e2) in float64 (csrc/voxel_iou.cu
    ``make_cull``)."""
    e1, e2 = par[..., 3].double(), par[..., 4].double()
    on = (torch.isfinite(par[..., :21]).all(dim=-1) & (par[..., 20] == 0)
          & (par[..., :3] != 0).all(dim=-1)
          & (e1 >= E_MIN) & (e1 <= E_MAX) & (e2 >= E_MIN) & (e2 <= E_MAX))
    delta = 5e-4 * torch.clamp(torch.maximum(e1, e2), min=1.0)
    return on, delta


def _column_terms(par: torch.Tensor, ax: torch.Tensor):
    """P = r0·X + r1·Y of each axis, (..., N, N) (x, y) for rows (..., 24)
    and their axes (..., N), in the rows' dtype, rounded as the kernel
    rounds them."""
    X, Y = ax[..., :, None], ax[..., None, :]
    return [par[..., 11 + 3 * i, None, None] * X
            + par[..., 12 + 3 * i, None, None] * Y for i in range(3)]


def z_ranges(par: torch.Tensor, ax: torch.Tensor):
    """(B, F, N, N) int64 [k0, k1]: the lattice indices of each column
    (x, y) where the kernel evaluates each field (csrc/voxel_iou.cu
    ``make_cull`` and ``z_range``, in float64 as there, by the per-field
    reciprocals 1/a, 1/|a| and a/r2); k0 > k1 where the field is occupied
    nowhere on the column. A row outside the proof's range, or a column
    whose P is not finite, takes [0, N − 1]."""
    n = ax.shape[-1]
    on, delta = cull_on(par)
    P = _column_terms(par, ax)
    zmax = torch.maximum(ax[:, 0].abs(), ax[:, -1].abs()).double()

    def per_field(v):
        return v.double()[..., None, None]

    lo = torch.full(P[0].shape, -math.inf, dtype=torch.float64,
                    device=par.device)
    hi = torch.full_like(lo, math.inf)
    empty = torch.zeros_like(lo, dtype=torch.bool)
    finite = torch.ones_like(empty)
    base = 1.0 + delta + 2.0 ** -20
    for i in range(3):
        finite &= torch.isfinite(P[i])
        a, t = par[..., i].double(), per_field(par[..., 8 + i])
        c = par[..., 13 + 3 * i].double()
        ia, iabs = per_field(1.0 / a), per_field(1.0 / torch.abs(a))
        islope = per_field(torch.where(c != 0, a / c, 0.0))
        cz = per_field(torch.abs(c) * zmax)
        p = P[i].double()
        b = per_field(base) + 2.0 ** -20 * (
            (torch.abs(p) + cz + torch.abs(t)) * iabs)
        u0 = (p - t) * ia
        flat = (c == 0)[..., None, None].expand_as(u0)
        empty |= (flat & ~(torch.abs(u0) <= b) & torch.isfinite(b)
                  & torch.isfinite(u0))
        za, zb = (-b - u0) * islope, (b - u0) * islope
        ok = ~flat & torch.isfinite(za) & torch.isfinite(zb)
        lo = torch.where(ok, torch.maximum(lo, torch.minimum(za, zb)), lo)
        hi = torch.where(ok, torch.minimum(hi, torch.maximum(za, zb)), hi)
    empty |= ~(lo <= hi)
    ax64 = ax.double()
    k0 = torch.stack([torch.searchsorted(ax64[f], lo[:, f].contiguous())
                      for f in range(ax.shape[0])], dim=1)
    k1 = torch.stack([torch.searchsorted(ax64[f], hi[:, f].contiguous(),
                                         right=True)
                      for f in range(ax.shape[0])], dim=1) - 1
    k0 = torch.where(empty, 0, k0)
    k1 = torch.where(empty, -1, k1)
    full = ~(on[..., None, None] & finite)
    return torch.where(full, 0, k0), torch.where(full, n - 1, k1)


def field_occupancy(par: torch.Tensor, ax: torch.Tensor) -> torch.Tensor:
    """(B, F, N, N, N) bool: F^(e1) <= 1 of every field at every voxel
    (x, y, z), by the kernel's arithmetic in the kernel's order on the
    packed rows and their axes, which is the plain path's: each product
    and sum rounded on its own, the division and the five pows as the
    plain grid takes them; a bfloat16 field's in bfloat16."""
    occ = []
    for f in range(par.shape[1]):          # one field at a time
        b16 = bool((par[:, f, 20] != 0).any())
        dt = torch.bfloat16 if b16 else par.dtype
        r, a = par[:, f].to(dt), ax[f].to(dt)
        tiny = torch.finfo(dt).tiny
        P = _column_terms(r, a)
        Z = a[None, None, None, :]

        def c(k):
            return r[:, k, None, None, None]

        s = []
        for i in range(3):
            u = (P[i][..., None] + c(13 + 3 * i) * Z - c(8 + i)) / c(i)
            s.append(u ** 2)
        A = torch.pow(s[0], c(5))
        B = torch.pow(s[1], c(5))
        C = torch.pow(s[2], c(7))
        E = torch.pow(A + B + tiny, c(6))
        occ.append(torch.pow(E + C + tiny, c(3)) <= 1.0)
    return torch.stack(occ, dim=1)


@torch.no_grad()
def emulate_voxel_iou(par: torch.Tensor, ax: torch.Tensor, pairs,
                      cull: bool = True):
    """The kernel's algorithm on (B, F, 24) packed rows -> the (B, P, 2)
    int64 counts and the (B,) field evaluations each sample makes: a
    field's occupancy is evaluated on its columns' [k0, k1] (every voxel
    with ``cull=False``, the full sweep) and is false elsewhere."""
    pairs = _check_pairs(pairs, par.shape[1])
    n = ax.shape[-1]
    occ = field_occupancy(par, ax)
    if cull:
        k0, k1 = z_ranges(par, ax)
        kz = torch.arange(n, device=par.device)
        occ &= (kz >= k0[..., None]) & (kz <= k1[..., None])
        evals = (k1 - k0 + 1).clamp(min=0).sum(dim=(1, 2, 3))
    else:
        evals = torch.full((par.shape[0],), par.shape[1] * n ** 3,
                           dtype=torch.int64, device=par.device)
    counts = torch.stack([torch.stack([
        (occ[:, f] & occ[:, g]).sum(dim=(1, 2, 3)),
        (occ[:, f] | occ[:, g]).sum(dim=(1, 2, 3))], dim=-1)
        for f, g in pairs], dim=1)
    return counts, evals


def evaluations(par: torch.Tensor, ax: torch.Tensor) -> int:
    """Field evaluations the kernel makes on these rows: Σ over samples,
    fields and columns of k1 − k0 + 1 (counted by the emulation's
    cull)."""
    k0, k1 = z_ranges(par, ax)
    return int((k1 - k0 + 1).clamp(min=0).sum())


def tested_share(par: torch.Tensor, ax: torch.Tensor) -> float:
    """The kernel's field evaluations over the full sweep's (every field
    at every voxel): the rate at which the cull engages."""
    b, f = par.shape[:2]
    return evaluations(par, ax) / (b * f * ax.shape[-1] ** 3)
