"""Direct fitting of superquadrics to depth maps: no network in the loop.

Counterpart of ``sqtpu/fit.py``:

* the classical recovery of the scanner binary (``recover``/``estimate``/
  ``mrqmin``): :func:`moments_init` (centroid, principal axes and sizes
  of the image's point cloud) and :func:`lm_fit`, Levenberg-Marquardt on
  the Solina-Bajcsy energy (or the signed radial distance) with
  per-sample accept/reject and damping, optional Tukey IRLS;
  :func:`recover`, and :func:`recover_multiview` over posed views;
* the test-time refinement of network predictions, :func:`refine_params`
  (``lm``, ``gd``, ``lm+gd``);
* the gradient-descent fit of ``torch/visu.py:123-209`` (:func:`gd_fit`,
  SGD with per-step quaternion renormalization, or Adam) and the CLI.

Everything is batched over a leading B on the device, where the JAX
package ``vmap``s a per-sample solve: the (B, n², 12) Jacobian comes from
``torch.func.jacfwd`` under ``torch.func.vmap``, the damped normal
equations from one batched ``torch.linalg.solve``, and the accept/reject
choice and λ are (B,) tensors. The ``gd`` refinement and :func:`gd_fit`
take their losses through the kernel dispatch: the implicit loss is K1/K2
on the card, the explicit loss K4; the plain losses on the CPU.

Usage::

    python -m sqtpu_torch.fit --optimizer lm [--n-views 4] [--device cpu]
    python -m sqtpu_torch.fit --optimizer adam --loss implicit --steps 200
"""

from __future__ import annotations

import math
import sys

import torch

from sqtpu_torch.data.synthetic import sample_params
from sqtpu_torch.ops import geometry, losses, metrics
from sqtpu_torch.ops import quaternion as quat
from sqtpu_torch.ops.image import despeckle, median3, nearest_resize
from sqtpu_torch.ops.kernels import (
    explicit_loss_auto, implicit_loss_auto, render_hard_auto,
)
from sqtpu_torch.ops.render import SCENE_CENTER, render_depth_view
from sqtpu_torch.utils.config import FitConfig, parse_cli, resolve_device

# optax.adam's defaults (sqtpu/fit.py:66)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def apply_prefilter(img: torch.Tensor, prefilter: str) -> torch.Tensor:
    """Depth-map cleanup on (..., H, W): ``"despeckle"`` drops isolated
    object pixels, ``"median"`` is the 3×3 median (it also halves ranging
    noise and fills dropout holes), ``"none"`` (or empty) is the
    identity. Any other name raises ``ValueError``."""
    if prefilter == "despeckle":
        return despeckle(img)
    if prefilter == "median":
        return median3(img)
    if prefilter in ("none", "", None):
        return img
    raise ValueError(f"unknown prefilter {prefilter!r}")


def _renorm_quat(p: torch.Tensor) -> torch.Tensor:
    q = p[..., geometry.QUAT_SLICE]
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.cat([p[..., :8], q / torch.clamp(n, min=1e-12)], dim=-1)


# ---------------------------------------------------------------------------
# Gradient descent (torch/visu.py:123-209)
# ---------------------------------------------------------------------------

def _fit_scan(p0: torch.Tensor, loss_fn, steps: int, lr: float,
              optimizer: str):
    """``steps`` updates of ``p0`` (B, 12) on ``loss_fn`` (a scalar whose
    gradient in each row is that row's own loss's), each followed by the
    quaternion's renormalization outside the optimizer state: SGD
    (``visu.py:182-187``) or optax's Adam. Returns (params, the loss
    before each update). Runs with gradients on, also when called in
    inference mode."""
    with torch.inference_mode(False), torch.enable_grad():
        p = p0.detach().clone()
        m = torch.zeros_like(p)
        v = torch.zeros_like(p)
        hist = []
        for k in range(1, steps + 1):
            p.requires_grad_(True)
            loss = loss_fn(p)
            g, = torch.autograd.grad(loss, p)
            p = p.detach()
            hist.append(loss.detach())
            if optimizer == "adam":
                m = (1.0 - ADAM_B1) * g + ADAM_B1 * m
                v = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * v
                m_hat = m / (1.0 - ADAM_B1 ** k)
                v_hat = v / (1.0 - ADAM_B2 ** k)
                p = _renorm_quat(
                    p + (m_hat / (torch.sqrt(v_hat) + ADAM_EPS)) * -lr)
            else:
                p = _renorm_quat(p - lr * g)
    return p, torch.stack(hist) if hist else p.new_zeros(0)


def _loss_closure(cfg: FitConfig, target_params=None, target_image=None):
    """The fit's loss of one (1, 12) estimate against its target: the
    explicit loss (K4 on the card), the implicit loss (K1/K2 on the
    card) or the least-squares energy (plain)."""
    if cfg.loss == "explicit":
        tp = target_params[None]
        return lambda p: explicit_loss_auto(tp, p, cfg.render_size)
    if cfg.loss == "implicit":
        ti = target_image[None]
        return lambda p: implicit_loss_auto(ti, p, cfg.render_size, cfg.tau,
                                            cfg.sigmoid_sharpness)
    if cfg.loss == "leastsquares":
        ti = target_image[None]
        return lambda p: losses.least_squares_loss(ti, p, cfg.render_size)
    raise ValueError(f"unknown loss {cfg.loss}")


def draw_truth_and_start(cfg: FitConfig):
    """The CLI's random truth (the evaluation distribution) and the fit's
    random start (``visu.py:55-56``: a ~ U(0.1, 0.3), e ~ U(0.1, 1),
    t ~ U(0.34, 0.65), a uniform rotation), (12,) float32 each, drawn from
    one generator on the CPU seeded with ``cfg.seed``: the same on every
    device."""
    gen = torch.Generator()
    gen.manual_seed(cfg.seed)
    true_p = sample_params(1, gen)[0]

    def u(n, lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen)
    p0 = torch.cat([u(3, 0.1, 0.3), u(2, 0.1, 1.0), u(3, 0.34, 0.65),
                    quat.random_uniform((), gen)])
    return true_p, p0


def gd_fit(cfg: FitConfig, target_params=None, target_image=None, p0=None):
    """Gradient-descent fit of one (12,) estimate from ``p0`` (None: the
    start of :func:`draw_truth_and_start`) with ``cfg.optimizer`` (``lm``
    means SGD here, as in the JAX package). Returns (params, loss
    history)."""
    target = target_params if target_params is not None else target_image
    if p0 is None:
        p0 = draw_truth_and_start(cfg)[1].to(target.device)
    loss_fn = _loss_closure(cfg, target_params, target_image)
    p, hist = _fit_scan(p0[None], loss_fn, cfg.steps, cfg.learning_rate,
                        cfg.optimizer if cfg.optimizer != "lm" else "sgd")
    return p[0], hist


# ---------------------------------------------------------------------------
# Moments init + Levenberg-Marquardt (the scanner binary's recover)
# ---------------------------------------------------------------------------

def image_points(img: torch.Tensor, n: int = 64):
    """(..., H, W) depth maps -> their (..., n², 3) lattice points at
    resolution n (the least-squares loss's (y, 1−x, z) convention) and
    the (..., n²) mask of the nonzero ones, in ``img``'s dtype."""
    small = nearest_resize(img, (n, n))
    mask = (small > 0).reshape(small.shape[:-2] + (-1,)).to(img.dtype)
    return losses.lattice_points(small), mask


def _canonical_axes(vecs: torch.Tensor) -> torch.Tensor:
    """Each eigenvector (column) of (..., 3, 3) turned so its component of
    largest magnitude (the first such) is positive: an eigenvector's sign
    is arbitrary, and LAPACK and cuSOLVER may choose differently."""
    idx = torch.argmax(torch.abs(vecs), dim=-2, keepdim=True)
    lead = torch.gather(vecs, -2, idx)
    return torch.where(lead < 0, -vecs, vecs)


def moments_init(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Initial estimates (B, 12) from the moments of the masked points
    (B, P, 3): the centroid is t, the principal axes (eigenvectors of the
    covariance, ascending, each column's sign by :func:`_canonical_axes`,
    all three flipped when det < 0) the rotation, sqrt(3·λ) the semi-axes
    (exact for a uniform box), e = (1, 1)."""
    w = mask / torch.clamp(torch.sum(mask, dim=-1, keepdim=True), min=1.0)
    mean = torch.sum(pts * w[..., None], dim=-2)
    centered = pts - mean[..., None, :]
    cov = (centered * w[..., None]).transpose(-1, -2) @ centered
    eigval, eigvec = torch.linalg.eigh(cov)
    R = _canonical_axes(eigvec)
    R = torch.where((torch.linalg.det(R) < 0)[..., None, None], -R, R)
    q0 = quat.from_matrix(R)
    a0 = geometry.clip(torch.sqrt(torch.clamp(3.0 * eigval, min=1e-8)),
                       geometry.A_MIN, geometry.A_MAX)
    e0 = torch.ones_like(a0[..., :2])
    return torch.cat([a0, e0, geometry.clip(mean, 0.0, 1.0), q0], dim=-1)


def _residuals(p, pts, mask, residual: str):
    """The LM residuals of estimates ``p`` (..., 12) at ``pts`` (..., P,
    3): √(a1a2a3)·(F^e1 − 1) (``sb``) or the signed radial distance
    (``radial``), times the mask."""
    pp = geometry.clamp_params(_renorm_quat(p))
    if residual == "radial":
        return geometry.signed_distance(pts, pp) * mask
    f = geometry.field_points(pts, pp, guard=True)
    a = pp[..., geometry.SIZE_SLICE]
    scale = torch.sqrt(a[..., 0] * a[..., 1] * a[..., 2])[..., None]
    return scale * (f - 1.0) * mask


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median over the last dim ignoring NaNs, the mean of the two middle
    values of an even count (``jnp.nanmedian``; ``torch.nanmedian``
    returns the lower one); NaN where every value is NaN."""
    valid = torch.sum(~torch.isnan(x), dim=-1, keepdim=True)
    s = torch.sort(x, dim=-1).values  # NaNs sort last
    lo = torch.gather(s, -1, torch.clamp((valid - 1) // 2, min=0))
    hi = torch.gather(s, -1, torch.clamp(valid // 2, max=x.shape[-1] - 1))
    med = (0.5 * lo + 0.5 * hi)[..., 0]
    return torch.where(valid[..., 0] > 0, med, torch.full_like(med, math.nan))


def _weights(r: torch.Tensor, mask: torch.Tensor, robust_c: float):
    """Tukey biweights of the residuals (B, P) at ``robust_c`` robust
    standard deviations (MAD scale over the masked points); ones when
    ``robust_c`` is 0."""
    if not robust_c:
        return torch.ones_like(r)
    absr = torch.where(mask > 0, torch.abs(r), torch.full_like(r, math.nan))
    scale = torch.clamp(1.4826 * nanmedian(absr), min=1e-4)
    u = r / (robust_c * scale[..., None])
    return torch.where(torch.abs(u) < 1.0, (1.0 - u * u) ** 2,
                       torch.zeros_like(u))


def lm_fit(pts: torch.Tensor, mask: torch.Tensor, p0: torch.Tensor,
           iters: int = 50, lam0: float = 1e-2, robust_c: float = 0.0,
           residual: str = "sb"):
    """Levenberg-Marquardt of the estimates ``p0`` (B, 12) on the masked
    points ``pts`` (B, P, 3), ``mask`` (B, P): each sample solves its
    damped normal equations (J'WJ + λ·diag(J'WJ) + 1e-12·I) δ = J'Wr,
    accepts the step where its weighted cost falls (λ × 0.3) and rejects
    it otherwise (λ × 3), ``iters`` times (``mrqmin``). ``robust_c`` > 0
    reweights by Tukey's biweight each iteration (IRLS; 4.685 is the 95%
    efficiency constant); ``residual`` is ``sb`` (Solina-Bajcsy) or
    ``radial`` (the signed radial distance, which does not collapse on
    noisy points). Returns (clamped params (B, 12), the cost after each
    iteration (B, iters))."""
    def one(p, x, m):
        return _residuals(p, x, m, residual)

    jac = torch.func.vmap(torch.func.jacfwd(one))
    # forward-mode AD takes no inference tensor (torch 2.11 on the card:
    # no batching rule for _make_dual): leave inference mode, on copies
    with torch.inference_mode(False), torch.no_grad():
        pts, mask, p = pts.clone(), mask.clone(), p0.clone()
        lam = torch.full(p.shape[:-1], lam0, dtype=p.dtype, device=p.device)
        eye = torch.eye(12, dtype=p.dtype, device=p.device)
        hist = []
        for _ in range(iters):
            r = _residuals(p, pts, mask, residual)
            w = _weights(r, mask, robust_c)       # frozen within the step
            sw = torch.sqrt(w)
            Jw = sw[..., None] * jac(p, pts, mask)  # (B, P, 12)
            A = Jw.transpose(-1, -2) @ Jw
            g = (Jw.transpose(-1, -2) @ (sw * r)[..., None])[..., 0]
            damped = (A + lam[..., None, None] * torch.diag_embed(
                torch.diagonal(A, dim1=-2, dim2=-1)) + 1e-12 * eye)
            delta = torch.linalg.solve(damped, g)
            p_new = _renorm_quat(p - delta)
            c_old = torch.sum(w * r ** 2, dim=-1)
            c_new = torch.sum(
                w * _residuals(p_new, pts, mask, residual) ** 2, dim=-1)
            accept = c_new < c_old
            p = torch.where(accept[..., None], p_new, p)
            lam = torch.where(accept, lam * 0.3, lam * 3.0)
            hist.append(torch.minimum(c_old, c_new))
        hist = torch.stack(hist, dim=-1) if hist else p.new_zeros(
            p.shape[:-1] + (0,))
        return geometry.clamp_params(_renorm_quat(p)), hist


def image_points_view(img: torch.Tensor, cam_q: torch.Tensor, n: int = 64):
    """The points of posed views (..., H, W), lifted to the world frame:
    ``cam_q`` (..., 4) is each view's world-from-camera rotation about the
    scene center (:func:`sqtpu_torch.ops.render.render_depth_view`), so a
    camera-frame point lifts as R(cam_q)·(x − c) + c. The identity camera
    gives :func:`image_points`."""
    pts_cam, mask = image_points(img, n)
    c0 = SCENE_CENTER
    return quat.rotate(pts_cam - c0, cam_q[..., None, :]) + c0, mask


def recover_multiview(imgs: torch.Tensor, cam_qs: torch.Tensor,
                      n_points: int = 64, iters: int = 50,
                      robust_c: float = 0.0, prefilter: str = "none",
                      residual: str = "sb"):
    """Classical recovery of one superquadric from posed views ``imgs``
    (V, H, W) with cameras ``cam_qs`` (V, 4): every view's points in the
    world frame, one moments init and one LM solve over the merged
    V·n_points² masked points. Returns ((12,) params, (iters,) costs)."""
    imgs = apply_prefilter(imgs, prefilter)
    pts, mask = image_points_view(imgs, cam_qs, n_points)
    pts, mask = pts.reshape(1, -1, 3), mask.reshape(1, -1)
    p, hist = lm_fit(pts, mask, moments_init(pts, mask), iters,
                     robust_c=robust_c, residual=residual)
    return p[0], hist[0]


def recover(imgs: torch.Tensor, n_points: int = 64, iters: int = 50,
            robust_c: float = 0.0, prefilter: str = "none",
            residual: str = "sb"):
    """Classical recovery of (B, H, W) depth maps (the scanner binary's
    ``recover``): the prefilter, the moments init and the LM polish, each
    sample on its own. Returns ((B, 12) params, (B, iters) costs)."""
    imgs = apply_prefilter(imgs, prefilter)
    pts, mask = image_points(imgs, n_points)
    return lm_fit(pts, mask, moments_init(pts, mask), iters,
                  robust_c=robust_c, residual=residual)


def refine_params(imgs: torch.Tensor, p0: torch.Tensor, method: str = "lm",
                  steps: int = 30, n: int = 64, lr: float = 3e-3,
                  tau: float = 1.5, sharp: float = 260.0,
                  robust_c: float = 0.0, prefilter: str = "none",
                  residual: str = "sb") -> torch.Tensor:
    """Test-time refinement of estimates ``p0`` (B, 12) against their
    depth maps ``imgs`` (B, H, W): ``lm`` polishes them by
    Levenberg-Marquardt on the image's points (``n``² of them; it fits the
    visible surface), ``gd`` by ``steps`` Adam steps on the implicit
    depth-MAE loss at render size ``n`` (each sample on its own loss: the
    sum of the per-sample losses is differentiated; K1/K2 on the card),
    ``lm+gd`` the first then the second with max(steps, 50) steps. The
    prefilter is applied once, first."""
    imgs = apply_prefilter(imgs, prefilter)
    if method == "lm":
        pts, mask = image_points(imgs, n)
        return lm_fit(pts, mask, p0, steps, robust_c=robust_c,
                      residual=residual)[0]
    if method == "gd":
        b = p0.shape[0]
        with torch.inference_mode(False):
            imgs = imgs.clone()  # a tensor autograd may save

        def loss_fn(p):
            return b * implicit_loss_auto(imgs, p, n, tau, sharp)
        p, _ = _fit_scan(p0, loss_fn, steps, lr, "adam")
        return geometry.clamp_params(p)
    if method == "lm+gd":
        p1 = refine_params(imgs, p0, "lm", steps, n, lr, tau, sharp,
                           robust_c=robust_c, residual=residual)
        return refine_params(imgs, p1, "gd", max(steps, 50), n, lr, tau,
                             sharp)
    raise ValueError(f"unknown refine method {method!r}")


def main(argv=None):
    cfg = parse_cli(FitConfig, sys.argv[1:] if argv is None else argv)
    device = resolve_device(cfg.device)
    true_p, p0 = (x.to(device) for x in draw_truth_and_start(cfg))
    img = render_hard_auto(true_p[None], 256, n_sweep=256, n_bisect=12,
                           quantize=True)[0]
    iters = cfg.steps if cfg.steps <= 200 else 50
    if cfg.optimizer == "lm" and cfg.n_views > 1:
        # turntable views about the world y axis
        half = torch.arange(cfg.n_views, dtype=true_p.dtype,
                            device=device) * (math.pi / cfg.n_views)
        zero = torch.zeros_like(half)
        cam_qs = torch.stack([zero, torch.sin(half), zero, torch.cos(half)],
                             -1)
        views = render_depth_view(true_p, cam_qs, 256)
        p_fit, hist = recover_multiview(views, cam_qs, iters=iters)
    elif cfg.optimizer == "lm":
        p_fit, hist = recover(img[None], iters=iters)
        p_fit, hist = p_fit[0], hist[0]
    else:
        p_fit, hist = gd_fit(cfg, target_params=true_p, target_image=img,
                             p0=p0)
    iou = float(metrics.iou(true_p[None], p_fit[None], 64))
    hist = hist.detach().cpu().numpy()
    print("true:", true_p.cpu().numpy())
    print("fit: ", p_fit.detach().cpu().numpy())
    print(f"final loss {float(hist[-1]):.6f}  IoU {iou:.4f}  "
          f"steps {len(hist)}")
    return p_fit, hist, iou


if __name__ == "__main__":
    main()
