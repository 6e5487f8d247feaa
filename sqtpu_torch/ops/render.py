"""Hard (exact) superquadric depth renderer: the plain PyTorch version of
the ray-cast kernel (``sqtpu_torch/csrc/hardrender.cu``).

Counterpart of ``render_depth_hard`` / ``render_depth_hard_batch`` in
``sqtpu/ops/render.py:95-186``. Camera model: orthographic view along −z;
image column = world x, image row counted from the bottom = world y;
pixel value = max surface z along the ray; background 0.
"""

from __future__ import annotations

import torch

from sqtpu_torch.ops import geometry
from sqtpu_torch.ops import quaternion as quat


def render_depth_hard_batch(p: torch.Tensor, image_size: int = 256,
                            n_bisect: int = 24, quantize: bool = False,
                            n_sweep: int | None = None) -> torch.Tensor:
    """(B, 12) params -> (B, S, S) exact depth maps.

    For each pixel a far→near sweep of ``n_sweep`` z-slabs over the
    superquadric's support window finds the topmost inside slab (the
    shape is convex for e1, e2 ≤ 1, so the inside set along a ray is an
    interval), then ``n_bisect`` bisection steps refine the crossing.
    ``quantize`` floors to integer gray levels / 255 like the scanner.
    """
    s = image_size
    b = p.shape[0]
    ax = torch.arange(s, dtype=p.dtype, device=p.device) / (s - 1)
    X = ax[None, :, None]  # (1, s, 1): x varies over dim 1
    Y = ax[None, None, :]  # (1, 1, s): y varies over dim 2

    a, e, t, q = geometry.split_params(p)
    rot = quat.to_matrix(quat.conjugate(q))            # (B, 3, 3)
    tr = torch.einsum("bij,bj->bi", rot, t)

    def c(v):  # per-sample scalar -> (B, 1, 1)
        return v.reshape(b, 1, 1)

    # loop-invariant parts of the body coordinates; the z term is added
    # per step
    base = [(c(rot[:, i, 0]) * X + c(rot[:, i, 1]) * Y, c(rot[:, i, 2]),
             c(tr[:, i]), c(a[:, i])) for i in range(3)]
    e1, e2 = c(e[:, 0]), c(e[:, 1])

    def inside(z):
        sq = [((xy + rz * z - ti) / ai) ** 2 for xy, rz, ti, ai in base]
        return geometry._power_chain(*sq, e1, e2, guard=True) <= 1.0

    nsw = s if n_sweep is None else n_sweep
    _, z_hi, step = geometry.z_support_window(a, rot, t, nsw)
    z_hi, step = c(z_hi), c(step)

    z_in = torch.zeros((b, s, s), dtype=p.dtype, device=p.device)
    hit = torch.zeros((b, s, s), dtype=torch.bool, device=p.device)
    for j in range(nsw):
        z = z_hi - j * step
        ins = inside(z)
        z_in = torch.where(ins & ~hit, z.expand_as(z_in), z_in)
        hit = hit | ins

    lo, hi = z_in, z_in + step
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        ins = inside(mid)
        lo, hi = torch.where(ins, mid, lo), torch.where(ins, hi, mid)

    depth = torch.where(hit, lo, torch.zeros_like(lo))
    if quantize:
        depth = torch.floor(depth * 255.0) / 255.0
    # (x, y) plane -> image rows/cols: row = s-1-y, col = x
    return torch.flip(depth.transpose(-1, -2), dims=(-2,))


def render_depth_hard(p: torch.Tensor, image_size: int = 256,
                      n_bisect: int = 24, quantize: bool = False,
                      n_sweep: int | None = None) -> torch.Tensor:
    """(12,) params -> (S, S) exact depth map."""
    return render_depth_hard_batch(p[None], image_size, n_bisect=n_bisect,
                                   quantize=quantize, n_sweep=n_sweep)[0]
