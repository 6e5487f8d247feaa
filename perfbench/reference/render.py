"""Frozen copy of the port's plain ``sqtpu_torch/ops/render.py``, kept
with the benchmark so that a later change to the program cannot move
the reference it is judged by. Its own docstring follows.

Superquadric depth renderers in PyTorch.

Counterpart of ``sqtpu/ops/render.py``:

* the soft, differentiable transmittance render (:29-90) behind the
  implicit loss: occupancy sigmoid(sharpness·(1 − F)) on an N³ grid, a
  far→near cumulative sum along z, depth = 1 − Σ exp(−τ·cum) / N;
* the hard (exact) ray-cast render (:95-186), the plain PyTorch version
  of the kernel ``sqtpu_torch/csrc/hardrender.cu``;
* the general ray-superquadric intersection and the posed-camera render
  (:193-306): :func:`intersect_ray`, :func:`camera_frame_params` and
  :func:`render_depth_view`, which renders the superquadric expressed in
  the camera's frame with the −z ray-caster (K3 on the card).

Camera model: orthographic view along −z; image column = world x, image
row counted from the bottom = world y; pixel value = max surface z along
the ray; background 0.
"""

from __future__ import annotations

import torch

from perfbench.reference import geometry
from perfbench.reference import quaternion as quat


def _depth_from_field(inout: torch.Tensor, tau, sharpness,
                      n: int) -> torch.Tensor:
    """F^(e1) on an (..., Nx, Ny, Nz) grid -> (..., rows, cols) depth in
    image layout (row 0 = top): occupancy sigmoid, cumulative sum over z
    from the far end, exponential transmittance, then (x, y) -> (row,
    col) with the row axis flipped."""
    occ = torch.sigmoid(sharpness * (1.0 - inout))
    cum = torch.cumsum(torch.flip(occ, dims=(-1,)), dim=-1)
    depth = 1.0 - torch.sum(torch.exp(-tau * cum), dim=-1) / n
    return torch.flip(depth.transpose(-1, -2), dims=(-2,))


def depth_from_axes(ax_x, ax_y, ax_z, p, tau, sharpness,
                    n: int) -> torch.Tensor:
    """Clamped params + grid axes -> depth in image layout, (rows,
    len(ax_x)) for p of shape (12,), with a leading batch dimension for
    p of shape (B, 12)."""
    f = geometry.field_grid(ax_x, ax_y, ax_z, p, guard=True)
    return _depth_from_field(f, tau, sharpness, n)


def render_depth_soft(p: torch.Tensor, render_size: int = 64,
                      tau: float = 1.5, sharpness: float = 260.0, *,
                      clamp: bool = True, dtype=None) -> torch.Tensor:
    """Soft differentiable depth render, values in [0, 1]: (N, N) for p
    of shape (12,), (B, N, N) for p of shape (B, 12)."""
    dtype = p.dtype if dtype is None else dtype
    ax = geometry.make_axis(render_size, "implicit", dtype=dtype,
                            device=p.device)
    pp = geometry.clamp_params(p) if clamp else p
    return depth_from_axes(ax, ax, ax, pp, tau, sharpness, render_size)


def render_depth_soft_batch(p: torch.Tensor, render_size: int = 64,
                            tau: float = 1.5,
                            sharpness: float = 260.0) -> torch.Tensor:
    """(B, 12) params -> (B, N, N) soft depth renders."""
    return render_depth_soft(p, render_size, tau, sharpness)


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


# ---------------------------------------------------------------------------
# General ray-superquadric intersection and posed-camera rendering
# ---------------------------------------------------------------------------

def intersect_ray(origin: torch.Tensor, direction: torch.Tensor,
                  p: torch.Tensor, n_sweep: int = 128,
                  n_bisect: int = 24):
    """First intersection of rays with the surface F = 1 of one
    superquadric ``p`` (12,): ``origin`` and ``direction`` (R, 3) (or
    (3,), broadcast). Clips each ray to the bounding sphere (radius |a|
    around t), sweeps ``n_sweep`` samples for the first inside point (the
    inside set along a ray is an interval) and bisects the bracket.
    Returns ``(t_hit, hit)``, (R,) each: the entry point's ray parameter
    in units of |direction| (0 where there is no hit) and the hit mask;
    only t ≥ 0 counts."""
    origin, direction = torch.broadcast_tensors(origin, direction)
    a, e, t, q = geometry.split_params(p)
    tiny = torch.as_tensor(1e-20, dtype=p.dtype, device=p.device)
    dn = torch.linalg.vector_norm(direction, dim=-1)
    d = direction / torch.maximum(dn, tiny)[..., None]

    oc = origin - t
    b = torch.sum(oc * d, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - torch.dot(a, a)
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = torch.clamp(-b - sq, min=0.0)
    t1 = -b + sq
    miss_sphere = (disc <= 0.0) | (t1 <= 0.0)
    step = (t1 - t0) / n_sweep

    def inside(tt):
        return geometry.field_points(origin + tt[..., None] * d, p,
                                     guard=True) <= 1.0

    t_in = torch.zeros_like(t0)
    found = torch.zeros_like(t0, dtype=torch.bool)
    for i in range(n_sweep):
        tt = t0 + float(i) * step
        ins = inside(tt)
        t_in = torch.where(ins & ~found, tt, t_in)
        found = found | ins
    hit = found & ~miss_sphere

    lo, hi = torch.maximum(t_in - step, t0), t_in  # outside, inside end
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        ins = inside(mid)
        lo, hi = torch.where(ins, lo, mid), torch.where(ins, mid, hi)
    t_hit = torch.where(hit, hi / torch.maximum(dn, tiny),
                        torch.zeros_like(hi))
    return t_hit, hit


SCENE_CENTER = 0.5  # the reference scene lives in the unit box


def camera_frame_params(p: torch.Tensor, cam_q: torch.Tensor) -> torch.Tensor:
    """Parameters (..., 12) expressed in the frame of a camera rotated by
    ``cam_q`` (..., 4; world-from-camera, xyzw) about the scene center
    (0.5, 0.5, 0.5): a rigid :func:`geometry.transform_params`."""
    c0 = torch.full((3,), SCENE_CENTER, dtype=p.dtype, device=p.device)
    q_inv = quat.conjugate(cam_q)
    t2 = c0 - quat.rotate(c0, q_inv)
    return geometry.transform_params(p, q_inv, t2)
