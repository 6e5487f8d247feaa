"""The plain reference of what the timed paths compute: the sampled
shapes, their depth maps, one training step (the model, the loss, the
backward, Adam) and the closed loop's scoring.

Nothing here imports the program. The shapes are drawn as the port's
``sample_params`` draws them (``sqtpu/data/synthetic.py:27-100``: a ~
U(25, 75)/255, e ~ U(0.1, 1.0), t ~ (128 + U(−40, 40))/255, q
Shoemake-uniform, then the gauge a1 >= a2), from the same
``torch.Generator`` stream, so the reference replays the program's
inputs from the seed alone. Losses run in blocks of rows so that the
full lattice fits; Adam is written out (optax's and torch's rule: β =
(0.9, 0.999), ε = 1e-8 outside the square root, bias-corrected).
"""

from __future__ import annotations

import contextlib
import math

import torch

from perfbench.reference import losses, metrics, model, render
from perfbench.reference import quaternion as quat

LOSS_ROWS = 16        # rows of a block of the lattice losses
RENDER_ROWS = 64      # rows of a block of the plain hard renderer
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _uniform(shape, lo, hi, generator, device):
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    return lo + u * (hi - lo)


def sample_params(batch: int, generator: torch.Generator) -> torch.Tensor:
    """(B, 12) shapes in normalized units on the generator's device."""
    dev = generator.device
    a = _uniform((batch, 3), 25 / 255, 75 / 255, generator, dev)
    e = _uniform((batch, 2), 0.1, 1.0, generator, dev)
    t = (128.0 + _uniform((batch, 3), -40.0, 40.0, generator, dev)) / 255.0
    q = quat.random_uniform((batch,), generator, torch.float32, dev)
    return losses.canonicalize_gauge(torch.cat([a, e, t, q], dim=-1))


def render_hard(p: torch.Tensor, image_size: int, n_sweep: int,
                n_bisect: int) -> torch.Tensor:
    """(B, S, S) quantized depth maps of the plain ray-caster, in blocks."""
    return torch.cat([
        render.render_depth_hard_batch(p[i:i + RENDER_ROWS], image_size,
                                       n_bisect=n_bisect, quantize=True,
                                       n_sweep=n_sweep)
        for i in range(0, p.shape[0], RENDER_ROWS)])


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in matrix products and convolutions on or off for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _lattice_loss_backward(per_rows, pd: torch.Tensor) -> torch.Tensor:
    """Σ over blocks of rows of ``per_rows(rows)`` (the per-sample loss of
    those rows), divided by B; its gradient accumulates into ``pd.grad``.
    Returns the value."""
    b = pd.shape[0]
    total = pd.new_zeros(())
    for lo in range(0, b, LOSS_ROWS):
        rows = slice(lo, lo + LOSS_ROWS)
        part = per_rows(rows).sum() / b
        part.backward()
        total = total + part.detach()
    return total


def _elong_weights(labels: torch.Tensor, weight: float) -> torch.Tensor:
    a = labels[..., 0:3]
    elong = torch.max(a, dim=-1).values / torch.clamp(
        torch.min(a, dim=-1).values, min=1e-6)
    w = 1.0 + weight * (elong - 1.0)
    return w / torch.mean(w)


def loss_backward(recipe: dict, pred: torch.Tensor, imgs: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """The recipe's loss of ``pred`` (a detached leaf; its gradient lands
    in ``pred.grad``): ``implicit`` (the soft render's MAE at
    ``render_size``³) or ``explicit_sym`` (the occupancy MSE on the full
    (N+1)³ lattice plus ``gauge_weight`` × the elongation-weighted size,
    shape, position and D2-symmetric rotation anchor)."""
    n = recipe["render_size"]
    if recipe["loss"] == "implicit":
        return _lattice_loss_backward(
            lambda r: losses.implicit_loss(
                imgs[r, ..., 0], pred[r], n, recipe["tau"],
                recipe["sigmoid_sharpness"], reduce=False), pred)
    if recipe["loss"] != "explicit_sym":
        raise ValueError(f"no reference for the loss {recipe['loss']!r}")
    geo = _lattice_loss_backward(
        lambda r: losses.explicit_loss(labels[r, :12], pred[r, :12], n,
                                       reduce=False,
                                       sharp=recipe["explicit_sharp"]), pred)
    per = (losses.param_mse(pred[..., :8], labels[..., :8], reduce=False)
           + losses.quaternion_loss_sym(pred[..., 8:12], labels[..., 8:12],
                                        reduce=False))
    w = _elong_weights(labels, recipe["elong_weight"])
    anchor = recipe["gauge_weight"] * torch.mean(per * w)
    anchor.backward()
    return geo + anchor.detach()


class Trainer:
    """The reference's training state: the weights, Adam's moments and
    its step count. ``quant`` and ``tf32_on`` set the precision (the
    reference: neither; the lower-precision controls: one of them);
    ``dtype`` float64 makes a second witness of the float32 reference."""

    def __init__(self, weights: dict, recipe: dict, quant=model.identity,
                 tf32_on: bool = False, dtype=torch.float32):
        self.dtype = dtype
        self.w = {k: v.detach().clone().to(dtype)
                  for k, v in weights.items()}
        self.recipe = recipe
        self.quant, self.tf32_on = quant, tf32_on
        self.m = {k: torch.zeros_like(v) for k, v in self.w.items()
                  if not model.is_stat(k)}
        self.v = {k: torch.zeros_like(v) for k, v in self.m.items()}
        self.t = 0
        self.last_pred = None
        self.last_pred_grad = None
        self.last_grad = None

    def step(self, imgs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """One train step on (B, H, W, 1) images and (B, 12) labels;
        returns the loss."""
        params = {k: v.requires_grad_(True) if k in self.m else v
                  for k, v in self.w.items()}
        imgs, labels = imgs.to(self.dtype), labels.to(self.dtype)
        with tf32(self.tf32_on):
            pred, stats = model.forward(params, imgs, True, self.quant)
            pd = pred.detach().requires_grad_(True)
            loss = loss_backward(self.recipe, pd, imgs, labels)
            pred.backward(pd.grad)
        self.last_pred = pred.detach()
        self.last_pred_grad = pd.grad.detach().clone()
        self.last_grad = {k: params[k].grad.detach().clone() for k in self.m}
        self.t += 1
        lr = self.recipe["learning_rate"]
        c1, c2 = 1.0 - ADAM_B1 ** self.t, 1.0 - ADAM_B2 ** self.t
        with torch.no_grad():
            for k in self.m:
                g = params[k].grad
                self.m[k].mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
                self.v[k].mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
                step = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2)
                                           + ADAM_EPS)
                self.w[k] = (params[k] - lr * step).detach()
            self.w.update(stats)
        return loss


@torch.no_grad()
def predict(weights: dict, imgs: torch.Tensor, quant=model.identity,
            tf32_on: bool = False) -> torch.Tensor:
    """Eval-mode predictions (running statistics) of (B, H, W, 1) images."""
    with tf32(tf32_on):
        return model.forward(weights, imgs, False, quant)[0]


@torch.no_grad()
def score(true_p: torch.Tensor, pred_p: torch.Tensor,
          render_size: int) -> torch.Tensor:
    """The closed loop's (B, 7) IoU tuple at ``render_size``³."""
    return metrics.iou_full(true_p, pred_p, render_size)


def worst_leaf(prog: dict, ref: dict, keys=None) -> float:
    """The worst leaf's gap of norms: the largest over the leaves of
    |‖prog‖ − ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖); inf where a
    norm is not finite."""
    keys = list(ref) if keys is None else list(keys)
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in keys}
    med = sorted(rn.values())[len(rn) // 2]
    gaps = [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys]
    return max(g if math.isfinite(g) else math.inf for g in gaps)


def levels_off(a, b) -> float:
    """The share of pixels whose gray levels (depth × 255, rounded; no
    wrap above 255) differ by more than one."""
    la = torch.round(torch.as_tensor(a).float() * 255.0).to(torch.int32)
    lb = torch.round(torch.as_tensor(b).float() * 255.0).to(torch.int32)
    return float(((la - lb).abs() > 1).double().mean())
