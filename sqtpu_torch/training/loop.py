"""The training loop of the port: every model of the registry trained
self-supervised (the implicit loss) or supervised (the explicit loss, the
parameter-space anchors, the 2019 losses), on data rendered on the
device.

Counterpart of ``sqtpu/training/loop.py`` (:41-243, :246-749).
``init_base`` loads a ``resnet_sq`` weights file into the corrector's
base, and ``freeze_base`` zeroes the base's gradients (its BatchNorm
statistics still move: the base runs in train mode). ``pretrained`` loads
a torchvision-layout resnet18 state_dict into the encoder
(:mod:`sqtpu_torch.models.torch_port`); ``dtype=bfloat16`` builds the
model with flax's ``dtype`` (:mod:`sqtpu_torch.models.resnet`: the
parameters, the optimizer and the checkpoints stay float32);
``profile_dir`` wraps the epochs in a ``torch.profiler`` trace
(:mod:`sqtpu_torch.utils.profiling`), which carries the train step's
spans (``train.*``) and those of the data (``data.*``) and the metrics.
One train step runs the model in train mode, the loss (on the card K1/K2
through ``implicit_loss_auto``, K4 through ``explicit_loss_auto``), the
backward and the Adam update; a validation step runs the model in eval mode
under ``torch.no_grad``, so the explicit loss takes K5 there. The data are
rendered on the device by the hard ray-caster (K3). Training data come
from a resident uint8 dataset rendered once (``data="synthetic"``), are
rendered afresh for every step (``data="online"``), or are read from a
directory of BMPs with the labels of ``labels_csv`` (``data=<dir>``,
:class:`sqtpu_torch.data.datasets.DepthDataset`: no K3 launch, the JAX
package's shuffle). The ``augment_*`` options corrupt the model's input
of every train and validation batch with the sensor-noise model
(:func:`sqtpu_torch.data.augment.depth_noise`, quantized; labels
untouched), at per-sample magnitudes U(0, max) with
``augment_randomize``.

The random streams are torch generators on the device, one per purpose:
the resident dataset, each epoch's training batches, a validation stream
re-seeded every epoch so validation batches are identical across epochs
(the JAX package's fixed validation key), and the augmentation's noise,
one stream for each epoch's training batches and one re-seeded every
epoch for validation, so a resumed run repeats the uninterrupted one. The
same seed gives other shapes than ``jax.random`` does.

Over several ranks (``python -m torch.distributed.run``, the JAX
package's ('data', 'grid') mesh, :mod:`sqtpu_torch.parallel`) every rank
draws the same global batch from the same generator and keeps its rows;
the loss, the BatchNorm statistics and the gradient are the global
batch's, as under the JAX package's sharded ``jit``: the kernel losses go
through :mod:`sqtpu_torch.parallel.sharded_losses`, every other batch
mean is averaged over the data group, BatchNorm sums its moments over the
data group, and the gradients are averaged over the world after the
backward. Rank 0 logs and writes the checkpoints. Without the launcher the
trainer is one rank and runs no collective.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from sqtpu_torch.data.augment import depth_noise
from sqtpu_torch.data.datasets import DepthDataset
from sqtpu_torch.data.labels import parse_csv_torch
from sqtpu_torch.data.synthetic import make_batch, save_pairs
from sqtpu_torch.models import (
    build_model, load_state_dict_file, load_torchvision_resnet18,
    params_vector, warm_start_base,
)
from sqtpu_torch.models.resnet import use_global_batch_stats
from sqtpu_torch.ops import geometry, losses, metrics
from sqtpu_torch.ops import quaternion as quat
from sqtpu_torch.ops.kernels import launch_counts
from sqtpu_torch.parallel.mesh import (
    Layout, all_reduce_sum, average_gradients, barrier, broadcast_state,
    data_mean, gather_objects, init_layout, shutdown,
)
from sqtpu_torch.parallel.sharded_losses import (
    explicit_loss_dp, implicit_loss_dp, implicit_loss_gridsharded,
)
from sqtpu_torch.training.lr import ReduceLROnPlateau, step_schedule_2019
from sqtpu_torch.training.state import (
    TrainState, create_train_state, get_lr, set_lr,
)
from sqtpu_torch.utils.checkpoint import (
    checkpoint_exists, load_checkpoint, load_config, load_weights_npz,
    save_checkpoint,
)
from sqtpu_torch.utils.config import (
    MODEL_DTYPES, TrainConfig, check_slice, resolve_device,
)
from sqtpu_torch.utils.logging import MetricLogger, NanGuard, Throughput
from sqtpu_torch.utils.profiling import span, trace

# Offsets of the random streams under one seed (an epoch adds its index);
# the augmentation's are far from the others' epochs.
_DATA_STREAM, _VAL_STREAM, _TRAIN_STREAM = 0, 1, 2
_AUG_TRAIN_STREAM, _AUG_VAL_STREAM = 500_000, 700_000


def _generator(device: torch.device, seed: int, stream: int,
               epoch: int = 0) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + stream + epoch)
    return gen


def augment_batch(cfg: TrainConfig, gen: torch.Generator,
                  imgs: torch.Tensor, rows: Optional[slice] = None):
    """The ``augment_*`` corruption of a (B, H, W, 1) batch, quantized to
    the 8-bit lattice; the identity when every magnitude is 0. With
    ``augment_randomize`` each sample's magnitudes are U(0, max). When
    ``imgs`` holds only the ``rows`` of a global batch of
    ``cfg.batch_size``, the noise is drawn for the global batch's shape
    and these rows kept, so the ranks' rows together are the one-rank
    batch."""
    g, d, s = cfg.augment_gaussian, cfg.augment_dropout, cfg.augment_salt
    if not (g or d or s):
        return imgs
    x = imgs[..., 0]
    padded = rows is not None and x.shape[0] != cfg.batch_size
    if padded:
        full = x.new_zeros((cfg.batch_size,) + tuple(x.shape[1:]))
        full[rows] = x
        x = full
    if cfg.augment_randomize:
        def u():
            return torch.rand((x.shape[0], 1, 1), generator=gen,
                              dtype=x.dtype, device=x.device)
        g = g * u() if g else 0.0
        d = d * u() if d else 0.0
        s = s * u() if s else 0.0
    out = depth_noise(gen, x, gaussian=g, dropout=d, salt=s, quantize=True)
    if padded:
        out = out[rows]
    return out[..., None]


def _elong_weights(cfg: TrainConfig, labels,
                   layout: Optional[Layout] = None):
    """Per-sample weights 1 + w·(max(a)/min(a) − 1), normalized to mean 1
    over the global batch, that emphasize elongated shapes in the
    supervised terms; None when ``elong_weight`` is off."""
    layout = layout or Layout()
    if cfg.elong_weight <= 0:
        return None
    a = labels[..., 0:3]
    elong = torch.max(a, dim=-1).values / torch.clamp(
        torch.min(a, dim=-1).values, min=1e-6)
    w = 1.0 + cfg.elong_weight * (elong - 1.0)
    return w / data_mean(torch.mean(w), layout)


def _weighted_mean(cfg: TrainConfig, per, labels, layout: Layout):
    w = _elong_weights(cfg, labels, layout)
    return data_mean(torch.mean(per if w is None else per * w), layout)


def _explicit_geo(cfg: TrainConfig, pred, labels, layout: Layout):
    """The explicit occupancy-MSE geometry term of the global batch:
    through K4/K5 on the card with ``use_pallas`` (gradient with respect
    to pred only; the labels are constants here), else the plain loss."""
    if cfg.use_pallas:
        return explicit_loss_dp(labels[..., :12], pred[..., :12].float(),
                                layout, cfg.render_size,
                                sharp=cfg.explicit_sharp)
    return data_mean(losses.explicit_loss(
        labels[..., :12], pred[..., :12], cfg.render_size,
        sharp=cfg.explicit_sharp), layout)


def _supervised_sym(pred, labels, col_weight=None):
    """Per-sample block MSE of size, shape and position plus the D2
    symmetry-aware quaternion loss."""
    return (losses.param_mse(pred[..., :8], labels[..., :8], reduce=False,
                             col_weight=col_weight)
            + losses.quaternion_loss_sym(pred[..., 8:12], labels[..., 8:12],
                                         reduce=False))


def _compute_loss(cfg: TrainConfig, pred, imgs, labels,
                  layout: Optional[Layout] = None):
    """The JAX package's loss selection (``training/loop.py:78-243``) for
    every loss this port runs, as the loss of the global batch when
    ``layout`` spans several ranks (``pred``, ``imgs`` and ``labels`` are
    then this rank's rows): the implicit loss through the grid-sharded
    loss when the grid axis is larger than 1, the kernel losses through
    their data-parallel versions (:78-107, :58-75), every other batch
    mean averaged over the data group.

    The kernels take float32 params: a bfloat16 prediction (the Keras
    nets' output layer computes in the model's dtype) is cast to float32
    before them. The JAX package's dispatch sends it to its plain losses
    instead, which promote it to float32 where it meets the float32
    labels and images; on the card the port has no such fallback."""
    layout = layout or Layout()
    if cfg.loss == "implicit":
        if layout.n_grid > 1:
            return implicit_loss_gridsharded(
                imgs[..., 0], pred.float() if cfg.use_pallas else pred,
                layout, cfg.render_size, cfg.tau, cfg.sigmoid_sharpness,
                use_pallas=cfg.use_pallas)
        if cfg.use_pallas:
            return implicit_loss_dp(imgs[..., 0], pred.float(), layout,
                                    cfg.render_size, cfg.tau,
                                    cfg.sigmoid_sharpness)
        return data_mean(losses.implicit_loss(
            imgs[..., 0], pred, cfg.render_size, cfg.tau,
            cfg.sigmoid_sharpness), layout)
    if cfg.loss == "explicit":
        return _explicit_geo(cfg, pred, labels, layout)
    if cfg.loss == "leastsquares":
        return data_mean(losses.least_squares_loss(imgs[..., 0], pred,
                                                   cfg.render_size), layout)
    if cfg.loss == "param_mse":
        return data_mean(losses.param_mse(pred, labels[..., :pred.shape[-1]]),
                         layout)
    if cfg.loss == "supervised":
        per = (losses.param_mse(pred[..., :8], labels[..., :8], reduce=False)
               + losses.quaternion_loss(pred[..., 8:12], labels[..., 8:12],
                                        reduce=False))
        return _weighted_mean(cfg, per, labels, layout)
    if cfg.loss == "supervised_sym":
        return _weighted_mean(cfg, _supervised_sym(pred, labels), labels,
                              layout)
    if cfg.loss == "quaternion":
        return data_mean(losses.quaternion_loss(pred[..., -4:],
                                                labels[..., 8:12]), layout)
    if cfg.loss == "quaternion_sym":
        return data_mean(losses.quaternion_loss_sym(pred[..., -4:],
                                                    labels[..., 8:12]),
                         layout)
    if cfg.loss == "supervised_geo":
        per = (_supervised_sym(pred, labels)
               + cfg.geo_weight * losses.rotation_moment_loss(
                   pred[..., 8:12], labels, reduce=False))
        return _weighted_mean(cfg, per, labels, layout)
    if cfg.loss == "keras_chamfer":
        return data_mean(_keras_chamfer(pred, labels), layout)
    if cfg.loss == "implicit_sym":
        impl = _compute_loss(dataclasses.replace(cfg, loss="implicit"), pred,
                             imgs, labels, layout)
        sup = _compute_loss(dataclasses.replace(cfg, loss="supervised_sym"),
                            pred, imgs, labels, layout)
        return impl + cfg.aux_weight * sup
    if cfg.loss == "supervised_gauge":
        per = losses.param_gauge_loss(pred[..., :12], labels, reduce=False)
        return _weighted_mean(cfg, per, labels, layout)
    if cfg.loss == "explicit_sym":
        # the geometry term plus a D2-only anchor: for canonical labels the
        # orbit minimum handles the unobservable flips and the label pins
        # the a1 <-> a2 gauge
        expl = _explicit_geo(cfg, pred, labels, layout)
        cw = None
        if cfg.shape_weight != 1.0:
            cw = pred.new_tensor([1.0, 1.0, 1.0, cfg.shape_weight,
                                  cfg.shape_weight, 1.0, 1.0, 1.0])
        return expl + cfg.gauge_weight * _weighted_mean(
            cfg, _supervised_sym(pred, labels, cw), labels, layout)
    if cfg.loss == "explicit_gauge":
        expl = _explicit_geo(cfg, pred, labels, layout)
        per = losses.param_gauge_loss(pred[..., :12], labels, reduce=False)
        return expl + cfg.gauge_weight * _weighted_mean(cfg, per, labels,
                                                        layout)
    if cfg.loss == "implicit_gauge":
        impl = _compute_loss(dataclasses.replace(cfg, loss="implicit"), pred,
                             imgs, labels, layout)
        per = losses.param_gauge_loss(pred[..., :12], labels, reduce=False)
        return impl + cfg.aux_weight * _weighted_mean(cfg, per, labels,
                                                      layout)
    raise ValueError(f"unknown loss {cfg.loss}")


def _keras_chamfer(pred, labels):
    """The 2019 rotation regime's occupancy-field MSE, both sides in the
    Keras normalization, with the JAX package's repairs for training: the
    field sees the params clamped to the valid box (``jnp.clip``'s
    derivative: 1 inside, 0 outside, 1/2 at a bound) with a normalized
    quaternion, a quadratic penalty pulls out-of-box raw outputs back in
    (against the clamped params with no gradient), and the field is
    capped at 100 (the uncapped float32 square overflows at e = 0.1)."""
    pred12 = pred[..., :12]
    clamped = torch.cat([geometry.clamp_params(pred12)[..., :8],
                         quat.normalize(pred12[..., 8:12])], dim=-1)
    range_penalty = torch.mean((pred12 - clamped.detach()) ** 2)
    return losses.keras_occupancy_mse(
        losses.torch_to_keras_norm(labels[..., :12]),
        losses.torch_to_keras_norm(clamped), clip=100.0) + range_penalty


def zero_frozen_grads(model: torch.nn.Module, cfg: TrainConfig) -> None:
    """With ``cfg.freeze_base``, zero the gradients of ``model.base`` (the
    JAX package's ``freeze_base``): called after the gradients' all-reduce
    and before the update, Adam then leaves the base as it is. Its
    BatchNorm statistics still move: the base stays in train mode."""
    if cfg.freeze_base and hasattr(model, "base"):
        for p in model.base.parameters():
            if p.grad is not None:
                p.grad.zero_()


def make_train_step(state: TrainState, cfg: TrainConfig,
                    layout: Optional[Layout] = None):
    """The train step: model in train mode -> params vector -> loss ->
    backward -> (clip) -> Adam. Returns the loss, detached. With
    ``cfg.remat`` the encoder's activations are recomputed in the backward.

    Over several ranks (``layout``) the step takes this rank's rows and
    returns the global batch's loss; after the backward the gradients are
    averaged over the world, and after the update rank 0's BatchNorm
    statistics are broadcast, so every rank holds the same model. With
    ``cfg.freeze_base`` the base's gradients are zeroed before the update
    (:func:`zero_frozen_grads`).

    ``nan_policy="skip"`` discards the whole update when the loss is not
    finite: the BatchNorm running statistics the forward already moved are
    put back, and no backward or optimizer step runs (parameters and Adam
    moments stay as they were). That check reads the loss on the host
    once per step; the loss is the global one, so every rank skips or
    none does.

    The step marks its phases as spans (:mod:`sqtpu_torch.utils.profiling`):
    ``train.step`` around the whole, and in it ``train.forward``,
    ``train.loss``, ``train.backward`` and ``train.optimizer``, which
    tile it; the recompute of ``remat`` falls in ``train.backward``."""
    model = state.model
    layout = layout or Layout()
    skip_nonfinite = cfg.nan_policy == "skip"

    def step(imgs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        with span("train.step"):
            with span("train.forward"):
                model.train()
                imgs = imgs.to(torch.float32)
                if skip_nonfinite:
                    saved = [b.detach().clone() for b in model.buffers()]
                state.optimizer.zero_grad(set_to_none=True)
                pred = params_vector(model(imgs, remat=cfg.remat))
            with span("train.loss"):
                loss = _compute_loss(cfg, pred, imgs, labels, layout)
            if skip_nonfinite and not bool(torch.isfinite(loss)):
                with torch.no_grad():
                    for b, s in zip(model.buffers(), saved):
                        b.copy_(s)
                return loss.detach()
            with span("train.backward"):
                loss.backward()
                average_gradients(model.parameters(), layout)
                zero_frozen_grads(model, cfg)
            with span("train.optimizer"):
                state.apply_gradients()
                broadcast_state(model.buffers(), layout)
            return loss.detach()

    return step


def make_eval_step(state: TrainState, cfg: TrainConfig,
                   layout: Optional[Layout] = None):
    """Validation: eval mode; the loss and, by the prediction's width, the
    accuracy and the mean rotation error modulo the D2 symmetry, each of
    the global batch over several ranks (``pred`` is this rank's rows'):
    12, the IoU at ``acc_render_size``³ (intersection and union pooled
    over the batch) and the error of ``pred``'s quaternion; 4 (a rotation
    alone), the error of ``pred`` as the accuracy, negated; any other
    (the isometric 8), the parameters' MAE, negated, and no error."""
    model = state.model
    layout = layout or Layout()

    @torch.no_grad()
    def step(imgs: torch.Tensor, labels: torch.Tensor):
        model.eval()
        imgs = imgs.to(torch.float32)
        pred = params_vector(model(imgs))
        loss = _compute_loss(cfg, pred, imgs, labels, layout)
        width = pred.shape[-1]
        if width == 4:
            ang = data_mean(torch.mean(metrics.angle_error_sym(
                labels[..., 8:12], pred)), layout)
            return loss, -ang, ang, pred
        if width != 12:
            acc = -data_mean(losses.param_mae(pred, labels[..., :width]),
                             layout)
            return loss, acc, torch.zeros((), dtype=imgs.dtype,
                                          device=imgs.device), pred
        ang = data_mean(torch.mean(metrics.angle_error_sym(
            labels[..., 8:12], pred[..., 8:12])), layout)
        if layout.data_group is None:
            acc = metrics.iou(labels, pred, cfg.acc_render_size)
        else:
            inter, union = metrics.iou_counts(labels, pred,
                                              cfg.acc_render_size)
            counts = all_reduce_sum(torch.stack([inter.sum(), union.sum()]),
                                    layout.data_group)
            acc = counts[0].to(labels.dtype) / counts[1].to(labels.dtype)
        return loss, acc, ang, pred

    return step


# ---------------------------------------------------------------------------
# Data sources
# ---------------------------------------------------------------------------

class SyntheticResident:
    """A synthetic dataset resident on the device as uint8, rendered once
    in chunks of ``chunk`` with :func:`make_batch`; batches are gathered
    on the device. With ``cfg.data_cache`` it is kept as an ``.npz`` under
    ``data_cache/`` and loaded from there next time."""

    def __init__(self, cfg: TrainConfig, size: int, seed: int,
                 device: torch.device, chunk: int = 256):
        self.cfg = cfg
        # pad to the chunk before the cache lookup, so a cached and a fresh
        # dataset have the same size and the same train/val split
        size = -(-size // chunk) * chunk
        cache = self._cache_path(cfg, size, seed)
        if cache and os.path.exists(cache):
            with np.load(cache) as data:
                self.images = torch.from_numpy(data["images"]).to(device)
                self.labels = torch.from_numpy(data["labels"]).to(device)
            size = int(self.images.shape[0])
            MetricLogger.line(f"loaded synthetic dataset cache {cache}")
        else:
            gen = _generator(device, seed, _DATA_STREAM)
            s = cfg.image_size
            self.images = torch.empty((size, s, s), dtype=torch.uint8,
                                      device=device)
            self.labels = torch.empty((size, 12), dtype=torch.float32,
                                      device=device)
            for i in range(0, size, chunk):
                imgs, lbls = make_batch(gen, chunk, s, cfg.renderer,
                                        iso=cfg.iso)
                # truncation to uint8, as the JAX package's astype
                self.images[i:i + chunk] = (imgs[..., 0] * 255.0).to(
                    torch.uint8)
                self.labels[i:i + chunk] = lbls
            if cache:
                os.makedirs(os.path.dirname(cache), exist_ok=True)
                np.savez(cache, images=self.images.cpu().numpy(),
                         labels=self.labels.cpu().numpy())
        self.size = size
        self.n_train = int(cfg.train_split * size)
        self.n_val = size - self.n_train
        if self.n_val == 0:
            raise ValueError(
                f"train_split={cfg.train_split} leaves no validation "
                f"samples in a {size}-image synthetic dataset")

    @staticmethod
    def _cache_path(cfg: TrainConfig, size: int, seed: int):
        if not cfg.ckpt_dir or not cfg.data_cache:
            return None
        name = (f"synth_torch_{size}_{cfg.image_size}_{cfg.renderer}"
                f"_iso{int(cfg.iso)}_s{seed}.npz")
        return os.path.join("data_cache", name)

    def _gather(self, gen: torch.Generator, lo: int, n: int):
        idx = torch.randint(lo, lo + n, (self.cfg.batch_size,),
                            generator=gen, device=self.images.device)
        imgs = self.images[idx].to(torch.float32) / 255.0
        return imgs[..., None], self.labels[idx]

    def train_batch(self, gen: torch.Generator):
        return self._gather(gen, 0, self.n_train)

    def val_batch(self, gen: torch.Generator):
        return self._gather(gen, self.n_train, self.n_val)


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

def train(cfg: TrainConfig, synthetic_size: Optional[int] = None):
    """Run training per ``cfg``; returns ``(state, history)``. Under
    ``python -m torch.distributed.run`` each process is one rank of a
    ('data', 'grid') layout with ``cfg.n_grid`` ranks on the grid axis
    (the JAX package's ``make_mesh(n_grid=...)``); the process group is
    left on every path out."""
    check_slice(cfg)
    layout = init_layout(cfg.n_grid, resolve_device(cfg.device))
    try:
        return _train(cfg, layout, synthetic_size)
    finally:
        if layout.world > 1:  # the group init_layout joined
            shutdown()


def _train(cfg: TrainConfig, layout: Layout, synthetic_size: Optional[int]):
    device = layout.device
    main = layout.is_main
    logger = MetricLogger(cfg.ckpt_dir or "", "train", quiet=not main)
    nan_guard = NanGuard(cfg.nan_policy)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)  # the initial weights
        model = build_model(cfg.model, cfg.image_size,
                            dtype=MODEL_DTYPES[cfg.dtype])
    if cfg.pretrained:
        # any torchvision-layout resnet18 state_dict: a torchvision .pt,
        # or an encoder exported with export_torchvision_resnet18
        load_torchvision_resnet18(model, load_state_dict_file(
            cfg.pretrained))
        logger.say(f"loaded pretrained encoder from {cfg.pretrained}")
    if cfg.init_weights:
        # full-model warm start from a portable npz; fresh optimizer
        load_weights_npz(cfg.init_weights, model)
        logger.say(f"warm-started all weights from {cfg.init_weights}")
    if cfg.init_base:
        # refine_sq: the base from a resnet_sq file; the corrector keeps
        # its identity init, so step 0 scores like the base model
        warm_start_base(model, cfg.init_base)
        logger.say(f"warm-started base from {cfg.init_base}")
    model.to(device)
    broadcast_state(model.state_dict().values(), layout)
    use_global_batch_stats(model, layout.data_group)
    state = create_train_state(model, cfg)
    n_params = sum(p.numel() for p in model.parameters())
    logger.say(f"model={cfg.model} params={n_params:,} loss={cfg.loss} "
               f"dtype={cfg.dtype} device={device} "
               f"mesh={{'data': {layout.n_data}, "
               f"'grid': {layout.n_grid}}} backend="
               f"{layout.backend or 'none (one rank)'}")

    train_step = make_train_step(state, cfg, layout)
    eval_step = make_eval_step(state, cfg, layout)

    # ----- data: every rank draws the global batch and keeps its rows
    rows = layout.rows(cfg.batch_size)
    if cfg.data == "synthetic":
        size = (synthetic_size or cfg.synthetic_size
                or max(cfg.batch_size * cfg.steps_per_epoch // 4,
                       cfg.batch_size * 4))
        logger.say(f"rendering {size} synthetic depth maps on {device}…")
        # one writer of the cache file; the other ranks render the same data
        dataset = SyntheticResident(
            cfg if main else dataclasses.replace(cfg, data_cache=False),
            size, cfg.seed, device)
        host_dataset = None
    elif cfg.data == "online":
        dataset = host_dataset = None
    else:
        dataset = None
        host_dataset = DepthDataset(cfg.data, parse_csv_torch(cfg.labels_csv),
                                    cfg.train_split)
        logger.say(f"{len(host_dataset)} images from {cfg.data}: "
                   f"{len(host_dataset.train_indices)} train, "
                   f"{len(host_dataset.val_indices)} validation")

    def host_batches(val: bool, epoch: int):
        """The directory's global batches on the device (validation keeps
        its tail batch)."""
        if val:
            it = host_dataset.batches(host_dataset.val_indices,
                                      cfg.batch_size, drop_remainder=False)
        else:
            it = host_dataset.batches(host_dataset.train_indices,
                                      cfg.batch_size, shuffle=cfg.shuffle,
                                      seed=cfg.seed + epoch)
        for imgs, labels in it:
            if imgs.shape[0] % layout.n_data:
                raise ValueError(f"a batch of {imgs.shape[0]} images does "
                                 f"not split over {layout.n_data} data ranks")
            yield (torch.from_numpy(imgs).to(device),
                   torch.from_numpy(labels).to(device))

    def batches(gen: torch.Generator, aug: torch.Generator, n: int,
                val: bool, epoch: int = 0):
        """This rank's rows of each global batch, augmented as the global
        batch is."""
        if host_dataset is not None:
            for imgs, labels in host_batches(val, epoch):
                r = layout.rows(imgs.shape[0])
                yield augment_batch(cfg, aug, imgs)[r], labels[r]
            return
        for _ in range(n):
            if dataset is None:  # renders only this rank's rows
                imgs, labels = make_batch(gen, cfg.batch_size,
                                          cfg.image_size, cfg.renderer,
                                          iso=cfg.iso, rows=rows)
                yield augment_batch(cfg, aug, imgs, rows), labels
                continue
            imgs, labels = (dataset.val_batch(gen) if val
                            else dataset.train_batch(gen))
            yield augment_batch(cfg, aug, imgs)[rows], labels[rows]

    # ----- resume
    history = {"loss": [], "val_loss": [], "val_acc": []}
    scheduler = ReduceLROnPlateau(get_lr(state), cfg.plateau_patience,
                                  cfg.plateau_factor)
    reset_best = False
    start_epoch = 0
    ckpt_path = os.path.join(cfg.ckpt_dir, "best")
    last_path = os.path.join(cfg.ckpt_dir, "last")
    resume_path = last_path if cfg.resume_from == "last" else ckpt_path
    if cfg.continue_training:
        barrier(layout)  # rank 0 may still be writing a checkpoint
    if cfg.continue_training and checkpoint_exists(resume_path):
        logger.say("Continuing with training…")
        saved_cfg = load_config(resume_path, TrainConfig)
        if saved_cfg.model != cfg.model:
            raise ValueError(f"{resume_path} holds a {saved_cfg.model!r} "
                             f"model, this run builds {cfg.model!r}")
        saved_history, saved_epoch = load_checkpoint(resume_path, state,
                                                     scheduler)
        # the checkpoint holds the last completed epoch; resume at the next
        start_epoch = saved_epoch + 1
        history = {"loss": [], "val_loss": [], "val_acc": [],
                   **{k: list(v) for k, v in saved_history.items()}}
        if cfg.reset_lr > 0:
            # a loss-switch fine-tune: a fresh LR and plateau count, and the
            # old best validation loss no longer applies
            set_lr(state, cfg.reset_lr)
            scheduler = ReduceLROnPlateau(cfg.reset_lr,
                                          cfg.plateau_patience,
                                          cfg.plateau_factor)
            reset_best = True
            logger.say(f"reset LR to {cfg.reset_lr:g} on resume")

    finite_vals = [v for v in history.get("val_loss", []) if np.isfinite(v)]
    best_val = None if (reset_best or not finite_vals) else min(finite_vals)
    meter = Throughput()

    # the trace, when asked for, is written on every exit from the run
    with contextlib.ExitStack() as profiling:
        if cfg.profile_dir:
            profiling.enter_context(trace(cfg.profile_dir))

        epoch = last_saved_epoch = start_epoch - 1
        for epoch in range(start_epoch, cfg.max_epochs):
            # Steps run asynchronously; the loss reaches the host every
            # log_interval steps, and once per epoch for all steps.
            losses_dev = []
            meter.reset()
            train_gen = _generator(device, cfg.seed, _TRAIN_STREAM, epoch)
            aug_gen = _generator(device, cfg.seed, _AUG_TRAIN_STREAM, epoch)
            for step_idx, (imgs, labels) in enumerate(
                    batches(train_gen, aug_gen, cfg.steps_per_epoch, val=False,
                            epoch=epoch)):
                loss = train_step(imgs, labels)
                losses_dev.append(loss)
                # the global batch
                meter.update(int(imgs.shape[0]) * layout.n_data)
                if main and step_idx % cfg.log_interval == 0:
                    loss_val = float(loss)
                    nan_guard.check(loss_val)
                    MetricLogger.progress(
                        f"Train Epoch: {epoch} Step: {step_idx} "
                        f"Loss: {loss_val:.6f} ({meter.rate:.0f} imgs/s)")
            if losses_dev:
                epoch_losses = torch.stack(losses_dev).cpu().numpy()  # a fence
                finite = epoch_losses[np.isfinite(epoch_losses)]
                train_loss = (float(finite.mean()) if finite.size
                              else float("nan"))
                if finite.size < epoch_losses.size:
                    logger.say(
                        f"[nan-guard] {epoch_losses.size - finite.size} "
                        f"non-finite step losses this epoch")
            else:
                train_loss = float("nan")
            epoch_rate = meter.rate
            history["loss"].append(train_loss)

            val_losses, val_accs, val_angs = [], [], []
            val_first = None
            val_gen = _generator(device, cfg.seed, _VAL_STREAM)
            val_aug = _generator(device, cfg.seed, _AUG_VAL_STREAM)
            for imgs, labels in batches(val_gen, val_aug, cfg.val_steps,
                                        val=True):
                l, a, ang, pred = eval_step(imgs, labels)
                if val_first is None:
                    val_first = (imgs, pred)
                val_losses.append(l)
                val_accs.append(a)
                val_angs.append(ang)
            if val_losses:
                val_loss = float(torch.stack(val_losses).mean())
                val_acc = float(torch.stack(val_accs).mean())
                val_ang = float(torch.stack(val_angs).mean())
            else:
                val_loss = val_acc = val_ang = float("nan")
            history["val_loss"].append(val_loss)
            history["val_acc"].append(val_acc)
            ang_hist = history.setdefault("val_angle_sym", [])
            while len(ang_hist) < len(history["val_loss"]) - 1:
                ang_hist.append(float("nan"))  # keep every list epoch-aligned
            ang_hist.append(val_ang)

            # (an 8- or 4-parameter prediction is no shape to render)
            if (main and epoch == 0 and cfg.ckpt_dir
                    and cfg.compare_images > 0 and val_first is not None
                    and val_first[1].shape[-1] == 12):
                _save_compare_images(cfg, val_first[0], val_first[1],
                                     os.path.join(cfg.ckpt_dir, "compare"))

            if cfg.lr_schedule == "step2019":
                new_lr = step_schedule_2019(epoch)
            else:
                new_lr = scheduler.step(val_loss)
            if abs(new_lr - get_lr(state)) > 1e-6 * max(new_lr, 1e-12):
                logger.say(f"Reducing learning rate to {new_lr:g}")
                set_lr(state, new_lr)

            # a non-finite val_loss neither becomes the best nor poisons it
            if cfg.ckpt_dir and np.isfinite(val_loss) and (
                    best_val is None or val_loss < best_val):
                best_val = val_loss
                if main:
                    save_checkpoint(ckpt_path, state, history, epoch, cfg,
                                    scheduler)
                saved = " [saved]"
            else:
                saved = ""
            last_every = max(int(cfg.save_last_interval), 1)
            if cfg.ckpt_dir and cfg.save_last and (
                    epoch % last_every == last_every - 1):
                if main:
                    save_checkpoint(last_path, state, history, epoch, cfg,
                                    scheduler)
                last_saved_epoch = epoch
            logger.say(
                f"Epoch {epoch}: loss {train_loss:.6f}  "
                f"val_loss {val_loss:.6f} val_acc {val_acc:.6f}  "
                f"{epoch_rate:.0f} imgs/s{saved}")
            # each rank's kernel launches since its counters were last reset,
            # and its peak device memory
            ranks = gather_objects({
                "launches": launch_counts(),
                "max_memory_mb": (
                    torch.cuda.max_memory_allocated(device) / 2**20
                    if device.type == "cuda" else None)}, layout)
            logger.log(epoch=epoch, loss=train_loss, val_loss=val_loss,
                       val_acc=val_acc, val_angle_sym=val_ang,
                       lr=get_lr(state), imgs_per_sec=epoch_rate, ranks=ranks)

        # 'last' reflects the final state on any exit from the loop
        if (main and cfg.ckpt_dir and cfg.save_last
                and epoch > last_saved_epoch):
            save_checkpoint(last_path, state, history, epoch, cfg,
                            scheduler)
    barrier(layout)  # every rank returns once the checkpoints are written
    return state, history


@torch.no_grad()
def _save_compare_images(cfg: TrainConfig, imgs, pred, out_dir: str):
    """True/pred depth BMP pairs for the first validation samples, as
    ``evaluate --save-pairs`` writes them (the prediction rendered at the
    full sweep, K3 on the card)."""
    os.makedirs(out_dir, exist_ok=True)
    n = min(cfg.compare_images, int(imgs.shape[0]))
    save_pairs(out_dir, 0, imgs[:n, ..., 0], pred[:n], cfg.image_size)
