"""Synthetic data made on the device: random superquadric parameters and
their depth maps, and the true/pred BMP pairs that evaluation and training
write (:func:`save_pairs`).

Counterpart of ``sample_params`` and ``make_batch`` in
``sqtpu/data/synthetic.py:27-100``: a ~ U(25, 75)/255, e ~ U(0.1, 1.0),
t ~ (128 + U(−40, 40))/255, q Shoemake-uniform, then the canonical gauge
a1 >= a2; the isometric variant (``iso``, the 2019 data) fixes
q = (1, 1, 1, 0)/√3 and keeps the independent sizes. The numbers come
from a ``torch.Generator``, so they differ from ``jax.random``'s; the
distribution is the same.
"""

from __future__ import annotations

import math
import os

import torch

from sqtpu_torch.data.bmp import write_bmp

from sqtpu_torch.ops import quaternion as quat
from sqtpu_torch.ops.kernels import render_hard_auto
from sqtpu_torch.ops.losses import canonicalize_gauge
from sqtpu_torch.ops.render import render_depth_soft_batch
from sqtpu_torch.utils.profiling import span


def _uniform(shape, lo, hi, generator, dtype, device):
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return lo + u * (hi - lo)


def sample_params(batch: int, generator: torch.Generator,
                  dtype=torch.float32, device=None,
                  canonical: bool = True, iso: bool = False) -> torch.Tensor:
    """(B, 12) random parameters in normalized units. ``canonical``
    applies to rotation data only: ``iso`` data keep the reference's
    independent sizes under the one fixed view (no rotation ambiguity to
    resolve). ``device`` defaults to the generator's device."""
    with span("data.sample"):
        device = generator.device if device is None else device
        a = _uniform((batch, 3), 25 / 255, 75 / 255, generator, dtype, device)
        e = _uniform((batch, 2), 0.1, 1.0, generator, dtype, device)
        t = (128.0 + _uniform((batch, 3), -40.0, 40.0, generator, dtype,
                              device)) / 255.0
        if iso:
            q = torch.tensor([1.0, 1.0, 1.0, 0.0], dtype=dtype, device=device)
            q = (q / math.sqrt(3.0)).expand(batch, 4)
            return torch.cat([a, e, t, q], dim=-1)
        q = quat.random_uniform((batch,), generator, dtype, device)
        p = torch.cat([a, e, t, q], dim=-1)
        return canonicalize_gauge(p) if canonical else p


def make_batch(generator: torch.Generator, batch: int, image_size: int = 256,
               renderer: str = "hard", iso: bool = False,
               rows: slice | None = None):
    """One (images, labels) batch on the generator's device: images
    (B, S, S, 1) depth maps in [0, 1], labels (B, 12) (the isometric view
    with ``iso``). ``hard`` renders
    with the ray-cast renderer at the training sweep (48 slabs, 12
    bisections, quantized; K3 on the card); ``soft`` with the soft
    renderer at τ 1.5, sharpness 260. ``rows`` keeps only those rows of
    the batch and renders only them: a rank's share of the global batch,
    drawn from the same stream (each image is rendered on its own)."""
    with span("data.make_batch"):
        p = sample_params(batch, generator, iso=iso)
        if rows is not None:
            p = p[rows]
        if renderer == "hard":
            imgs = render_hard_auto(p, image_size, n_sweep=48, n_bisect=12,
                                    quantize=True)
        elif renderer == "soft":
            imgs = render_depth_soft_batch(p, image_size, 1.5, 260.0)
        else:
            raise ValueError(f"unknown renderer {renderer}")
        return imgs[..., None], p


# the saved pairs' prediction render: the full sweep, 24 bisections
# (sqtpu/evaluate.py:261, render_depth_hard's defaults)
PAIRS_BISECT = 24


def save_pairs(out_dir: str, first: int, true_imgs: torch.Tensor,
               p_pred: torch.Tensor, image_size: int) -> None:
    """Write ``<k>_true.bmp`` (the model's input) and ``<k>_pred.bmp``
    (the prediction rendered at the full sweep, K3 on the card in one
    launch) for k = first, first + 1, ... over the given rows."""
    pred_imgs = render_hard_auto(p_pred, image_size, n_sweep=image_size,
                                 n_bisect=PAIRS_BISECT, quantize=True)
    true_u8 = (true_imgs * 255).to(torch.uint8).cpu().numpy()
    pred_u8 = (pred_imgs * 255).to(torch.uint8).cpu().numpy()
    for i in range(true_u8.shape[0]):
        write_bmp(os.path.join(out_dir, f"{first + i}_true.bmp"), true_u8[i])
        write_bmp(os.path.join(out_dir, f"{first + i}_pred.bmp"), pred_u8[i])
