"""The kernel losses over the ('data', 'grid') layout of ranks.

Counterpart of ``sqtpu/parallel/sharded_losses.py`` (:28-196). Each rank
holds its rows of the global batch (:meth:`Layout.rows`) and runs the
kernels on them; the collectives of :mod:`sqtpu_torch.parallel.mesh`
combine the results, with autograd through them, so every rank holds the
global loss and differentiates its own copy (the trainer then averages
the parameter gradients over the world):

* :func:`implicit_loss_dp` and :func:`explicit_loss_dp`: the kernel loss
  of the rank's rows (K1/K2, K4/K5 on the card), then the mean over the
  data group (the JAX package's ``pmean`` over 'data');
* :func:`implicit_loss_gridsharded`: rank g of a grid group sweeps the
  image columns [g·n/G, (g+1)·n/G) of the n² lattice (K6 on the card, the
  plain slab render on the CPU); the per-sample partial sums are summed
  over the grid group, divided by n² and averaged over the data group
  (``psum`` over 'grid', as :133-196). In the backward each rank's slab
  gives its part of the gradient of the params, and those parts are
  summed over the grid group before the model's backward;
* :func:`make_batch_dp`: each rank samples and renders its own rows from
  its own stream (the JAX package's per-device key fold, :96-130).
"""

from __future__ import annotations

import torch

from sqtpu_torch.data.synthetic import make_batch
from sqtpu_torch.ops.image import nearest_resize
from sqtpu_torch.ops.kernels import (
    explicit_loss_auto, implicit_loss_auto, implicit_sums_slab_auto,
)
from sqtpu_torch.ops.kernels.implicit import implicit_sums_slab_plain
from sqtpu_torch.ops.losses import _as_bhw
from sqtpu_torch.parallel.mesh import Layout, data_mean, sum_grad, sum_value


def implicit_loss_dp(img: torch.Tensor, p: torch.Tensor, layout: Layout,
                     render_size: int = 64, tau: float = 1.5,
                     sharpness: float = 260.0) -> torch.Tensor:
    """The implicit loss of the global batch: K1/K2 on this rank's rows
    ``img`` (B_local, H, W) and ``p`` (B_local, 12), then the mean over the
    data group (equal shards, so the mean of the means is the global
    mean)."""
    return data_mean(implicit_loss_auto(img, p, render_size, tau, sharpness),
                     layout)


def explicit_loss_dp(true_p: torch.Tensor, pred_p: torch.Tensor,
                     layout: Layout, render_size: int = 32,
                     sharp: float = 5.0) -> torch.Tensor:
    """The explicit loss of the global batch: K4 (K5 when nothing is
    differentiated) on this rank's rows, then the mean over the data
    group. The gradient flows to ``pred_p`` only."""
    return data_mean(explicit_loss_auto(true_p, pred_p, render_size,
                                        sharp=sharp), layout)


def fold_in(generator: torch.Generator, index: int) -> torch.Generator:
    """A new generator on ``generator``'s device whose stream is set by
    ``generator``'s seed and ``index`` (``jax.random.fold_in``'s role)."""
    gen = torch.Generator(device=generator.device)
    gen.manual_seed((generator.initial_seed() * 1_000_003 + index + 1)
                    % (1 << 63))
    return gen


def make_batch_dp(generator: torch.Generator, batch: int, layout: Layout,
                  image_size: int = 256, renderer: str = "hard"):
    """This rank's rows of a global batch of ``batch``, sampled and
    rendered from ``generator`` folded with the data index: the ranks of
    a data group draw other shapes, those of a grid group the same ones.
    The same distribution as :func:`make_batch`, not the same samples."""
    rows = layout.rows(batch)
    return make_batch(fold_in(generator, layout.data_index),
                      rows.stop - rows.start, image_size, renderer)


def implicit_loss_gridsharded(img: torch.Tensor, p: torch.Tensor,
                              layout: Layout, render_size: int = 64,
                              tau: float = 1.5, sharpness: float = 260.0,
                              use_pallas: bool = True) -> torch.Tensor:
    """The implicit loss of the global batch with the lattice's x axis
    (the image columns) split over the grid group: this rank's column
    slab through K6 (``use_pallas``, on the card; the plain slab render on
    the CPU) or the plain slab render, the partial sums summed over the
    grid group and divided by n², the batch mean taken over the data
    group. Equal to :func:`sqtpu_torch.ops.losses.implicit_loss` of the
    global batch."""
    n = render_size
    if n % layout.n_grid:
        raise ValueError(f"render_size {n} must divide the grid axis "
                         f"{layout.n_grid}")
    shard = n // layout.n_grid
    x0 = layout.grid_index * shard
    small = nearest_resize(_as_bhw(img).to(p.dtype), (n, n))
    cols = small[:, :, x0:x0 + shard]
    # The ranks of a grid group run the same model on the same rows: the
    # cotangent of p is summed over the group before it enters the model,
    # so all of them run the model's backward on the whole gradient and
    # hold the same parameter gradient, as one rank would.
    p = sum_grad(p, layout.grid_group)
    if use_pallas:
        partial = implicit_sums_slab_auto(cols, p, x0, n, tau, sharpness)
    else:
        partial = implicit_sums_slab_plain(cols, p, x0, n, tau, sharpness)
    per_sample = sum_value(partial, layout.grid_group) / (n * n)
    return data_mean(torch.mean(per_sample), layout)
