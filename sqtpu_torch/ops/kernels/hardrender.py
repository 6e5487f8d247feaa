"""The hard ray-cast renderer as a hand-written CUDA kernel.

Counterpart of ``sqtpu/ops/kernels/hardrender.py`` (the Pallas TPU kernel
``_kernel`` launched by ``render_depth_hard_pallas``). The kernel source is
``sqtpu_torch/csrc/hardrender.cu``; it is built with ``nvcc`` at first use
and called through ``ctypes``. The frame scalars are packed here in torch
exactly as the JAX wrapper packs them.

:func:`render_depth_hard_cuda` takes a CUDA tensor to the kernel and a CPU
tensor to the plain version (:func:`sqtpu_torch.ops.render
.render_depth_hard_batch`); on a CUDA tensor it launches the kernel or
raises. Forward only: no gradient flows through a ground-truth render.

Beside them, :func:`emulate_hardrender` is a torch emulation of the
kernel's algorithm on :func:`pack_frames`' rows: each pixel sweeps only
the slabs where its ray is inside the body box (:func:`slab_range`), or,
with ``interval=False``, every slab, as the first port of the kernel did.
The two give the same bits (a test holds them so), and each counts the
inside tests it makes. The main path never calls them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sqtpu_torch.ops import geometry
from sqtpu_torch.ops.kernels import _build
from sqtpu_torch.ops.render import render_depth_hard_batch
from sqtpu_torch.utils.profiling import span

PAR_STRIDE = 24  # floats per sample in K3's packed frame scalars


def pack_frames(p: torch.Tensor, n_sweep: int) -> torch.Tensor:
    """(B, 12) params -> (B, 24) float32 frame scalars:
    a (0-2), 1/e2 (3), e2/e1 (4), 1/e1 (5), R(q*)·t (6-8), R(q*) (9-17),
    z_hi (18), step (19), zero padding (20-23)."""
    p = p.to(torch.float32)
    b = p.shape[0]
    a, e, tr, rot = geometry.rotated_frame(p)
    _, z_hi, step = geometry.z_support_window(
        a, rot, geometry.split_params(p).t, n_sweep)
    return torch.cat([
        a,
        (1.0 / e[:, 1])[:, None],
        (e[:, 1] / e[:, 0])[:, None],
        (1.0 / e[:, 0])[:, None],
        tr,
        rot.reshape(b, 9),
        z_hi[:, None], step[:, None],
        p.new_zeros((b, PAR_STRIDE - 20)),
    ], dim=-1).contiguous()


def render_depth_hard_cuda(p: torch.Tensor, image_size: int = 256,
                           n_sweep: int = 48, n_bisect: int = 12,
                           quantize: bool = True) -> torch.Tensor:
    """(B, 12) params -> (B, S, S) float32 depth maps, image layout; the
    span ``ops.render_hard`` (:mod:`sqtpu_torch.utils.profiling`)."""
    if p.ndim != 2 or p.shape[-1] != geometry.N_PARAMS:
        raise ValueError(f"params must be (B, 12), got {tuple(p.shape)}")
    if not p.is_floating_point():
        raise TypeError(f"params must be floating point, got {p.dtype}")
    if image_size < 2 or n_sweep < 2 or n_bisect < 0:
        raise ValueError(
            f"need image_size >= 2, n_sweep >= 2, n_bisect >= 0; got "
            f"{image_size}, {n_sweep}, {n_bisect}")
    with span("ops.render_hard"):
        if p.device.type == "cpu":
            return render_depth_hard_batch(p, image_size, n_bisect=n_bisect,
                                           quantize=quantize, n_sweep=n_sweep)
        if p.device.type != "cuda":
            raise ValueError(f"no kernel for device {p.device}")
        if not 0 < p.shape[0] <= 65535:
            raise ValueError(f"batch {p.shape[0]} outside the kernel's grid "
                             "(1..65535)")
        out = _launch(pack_frames(p, n_sweep), image_size, n_sweep, n_bisect,
                      quantize)
        _build.count("K3")
        return out


def _launch(par: torch.Tensor, image_size: int, n_sweep: int,
            n_bisect: int, quantize: bool = True,
            lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """The kernel of ``lib`` (default: this package's) on (B, 24) rows
    packed by :func:`pack_frames` on the card -> (B, S, S) float32 depth
    maps; raises unless it launched."""
    b = par.shape[0]
    if not (par.is_cuda and par.is_contiguous()
            and par.dtype == torch.float32 and par.shape == (b, PAR_STRIDE)
            and 0 < b <= 65535):
        raise RuntimeError("packed frame scalars have the wrong layout")
    out = torch.empty((b, image_size, image_size), dtype=torch.float32,
                      device=par.device)
    lib = _build.library("hardrender") if lib is None else lib
    _build.launch(lib, "sqtpu_hardrender", par.device, par.data_ptr(),
                  out.data_ptr(), b, image_size, n_sweep, n_bisect,
                  int(bool(quantize)), what="hardrender")
    return out


# ---------------------------------------------------------------------------
# The emulation of the kernel's algorithm (the analogue of interpret mode)
# ---------------------------------------------------------------------------

class _Pixels:
    """The kernel's per-pixel frame on (B, 24) packed rows: body
    coordinates at z = 0 (B, s, s), their slopes in z and the exponents
    (B, 1, 1), all float32 as the kernel computes them."""

    def __init__(self, par: torch.Tensor, s: int):
        b = par.shape[0]
        self.par = par

        def c(k):
            return par[:, k].reshape(b, 1, 1)

        idx = torch.arange(s, device=par.device, dtype=torch.float32)
        inv = torch.ones((), dtype=torch.float32, device=par.device) / (s - 1)
        X = (idx * inv)[None, None, :]                 # col = x
        Y = (torch.flip(idx, (0,)) * inv)[None, :, None]  # row = s-1-y
        self.origin = [(c(9 + 3 * i) * X + c(10 + 3 * i) * Y - c(6 + i))
                       / c(i) for i in range(3)]
        self.slope = [c(11 + 3 * i) / c(i) for i in range(3)]
        self.ie2, self.e21, self.ie1 = c(3), c(4), c(5)
        self.z_hi, self.step = c(18), c(19)

    def inside(self, z: torch.Tensor) -> torch.Tensor:
        """The kernel's inside test at z (a scalar per sample or per
        pixel)."""
        u, v, w = (o + k * z for o, k in zip(self.origin, self.slope))
        tiny = torch.finfo(torch.float32).tiny
        A = torch.exp(torch.log(u * u + tiny) * self.ie2)
        B = torch.exp(torch.log(v * v + tiny) * self.ie2)
        C = torch.exp(torch.log(w * w + tiny) * self.ie1)
        E = torch.exp(torch.log(A + B + tiny) * self.e21)
        return E + C <= 1.0


def slab_range(par: torch.Tensor, s: int, n_sweep: int):
    """(B, s, s) int64 [j0, j1]: the slabs each pixel sweeps, those whose
    z = z_hi − j·step lies where the pixel's ray is inside the box |u|,
    |v|, |w| ≤ 1 + δ + a rounding allowance (csrc/hardrender.cu
    ``slab_range``, in float64 as there); j0 > j1 where the ray misses. A
    sample outside the range the kernel's proof covers sweeps every slab.
    """
    px = _Pixels(par, s)
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
def emulate_hardrender(par: torch.Tensor, s: int, n_sweep: int,
                       n_bisect: int, quantize: bool = True,
                       interval: bool = True):
    """The kernel's algorithm on (B, 24) packed rows -> the (B, s, s)
    depth maps in image layout and the (B,) inside tests each sample
    makes: a pixel that first hits at slab j makes j − j0 + 1 tests and
    n_bisect more, a miss j1 − j0 + 1. ``interval=False`` sweeps every
    slab (j0 = 0, j1 = n_sweep − 1), as the first port did."""
    px = _Pixels(par, s)
    if interval:
        j0, j1 = slab_range(par, s, n_sweep)
    else:
        j0 = torch.zeros(px.origin[0].shape, dtype=torch.int64,
                         device=par.device)
        j1 = torch.full_like(j0, n_sweep - 1)
    first = torch.full_like(j0, n_sweep)
    z_in = torch.zeros(j0.shape, dtype=torch.float32, device=par.device)
    for j in range(n_sweep):
        z = px.z_hi - j * px.step
        newly = (px.inside(z) & (j0 <= j) & (j <= j1) & (first == n_sweep))
        first = torch.where(newly, j, first)
        z_in = torch.where(newly, z, z_in)
    hit = first < n_sweep
    lo, hi = z_in, z_in + px.step
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        ins = px.inside(mid)
        lo, hi = torch.where(ins, mid, lo), torch.where(ins, hi, mid)
    depth = torch.where(hit, lo, 0.0)
    if quantize:  # a true division by a tensor, as the kernel divides
        depth = torch.floor(depth * 255.0) / torch.full_like(depth, 255.0)
    tests = torch.where(hit, first - j0 + 1 + n_bisect,
                        torch.clamp(j1 - j0 + 1, min=0))
    return depth, tests.sum(dim=(-1, -2))

