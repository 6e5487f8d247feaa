"""ResNet-18 backbone and the ResNetSQ regressor in PyTorch.

Counterpart of ``sqtpu/models/resnet.py:24-116``. Public inputs keep the
JAX package's NHWC layout, (B, H, W, 1) or (B, H, W); the model converts
to NCHW inside. Submodule names follow the flax names, so a flat flax
weight file maps onto the ``state_dict`` key by key
(:func:`sqtpu_torch.utils.checkpoint.state_dict_from_flax`).

Padding matches the JAX model: explicit (1, 1) on every 3x3 convolution,
stride 2 included; (3, 3) on the 7x7 stem; the max pool pads (1, 1) with
−inf. BatchNorm follows flax in both modes (:class:`BatchNorm`), and a
model built here starts from flax's initial distribution
(:func:`init_like_flax`).

``dtype`` is flax's: with ``torch.bfloat16`` every convolution and dense
layer of the encoder and of ``fc1``/``fc2`` casts its input and its
parameters to bfloat16 and computes there (:class:`Conv2d`,
:class:`Linear`); BatchNorm reduces and normalizes in float32 and casts
its output back; the heads compute in float32 (flax promotes their
bfloat16 input against float32 kernels). The parameters, their
gradients and the running statistics stay float32, and so do the four
outputs.

``forward(x, remat=True)`` recomputes the encoder's stem and stages during
the backward instead of keeping their activations (the JAX package's
``remat``, ``jax.checkpoint`` of the loss function): memory for operations,
the same numbers. The recompute leaves the BatchNorm running statistics
alone, so they move once per step, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sqtpu_torch.models.heads import (
    PositionHead, Rotation6DHead, RotationHead, ShapeHead, SizeHead,
)

BN_EPS = 1e-5
BN_MOMENTUM = 0.01  # torch convention: 1 - flax's 0.99


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's train-mode semantics: the batch is
    normalized with its biased variance (as torch does), and the running
    variance is updated with that same biased variance, where torch would
    use the unbiased one. Eval mode is torch's own (running statistics).
    ``num_batches_tracked`` is left alone: flax keeps no such counter.
    With ``update_stats`` off (the recompute of a checkpointed stage) the
    running statistics stay as they are.

    With a ``data_group`` (the ranks that hold the other rows of the
    global batch, :func:`use_global_batch_stats`) the train-mode
    statistics are the global batch's, as flax's are under a sharded
    ``jit`` (:class:`_GlobalBatchNorm`), and the running statistics move
    with the global moments."""

    update_stats = True
    data_group = None

    def forward(self, x):
        """Statistics and normalization in the parameters' dtype; the
        output in ``x``'s (flax: float32 reductions, then ``asarray(y,
        dtype)``)."""
        return self._forward(x.to(self.weight.dtype)).to(x.dtype)

    def _forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.data_group is not None:
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias,
                                                  self.eps, self.data_group)
            if self.update_stats:
                self._update_running(mean, var)
            return y
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        if self.update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self._update_running(mean, var)
        return y

    @torch.no_grad()
    def _update_running(self, mean, var):
        self.running_mean.mul_(1.0 - self.momentum).add_(
            mean, alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(
            var, alpha=self.momentum)


def _channel_sum(x: torch.Tensor) -> torch.Tensor:
    """Per-channel sum of an NCHW tensor, accumulated in float64."""
    return x.sum(dim=(0, 2, 3), dtype=torch.float64)


def _per_channel(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.to(like.dtype)[None, :, None, None]


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch normalization over the rows of every rank of a
    group (equal rows each), with the sums over the group taken by
    collectives in the forward and the backward: the per-channel sum,
    then the sum of squared deviations from the global mean (two passes,
    as ``var_mean``), and in the backward the sums of the cotangent and of
    its product with the normalized input. Sums accumulate in float64,
    as ``F.batch_norm`` accumulates them on the CPU: the backward's
    ``dy − mean(dy) − x̂·mean(dy·x̂)`` cancels, and float32 sums left
    1e-2 of the gradient of the first stage's parameters off. The weight
    and bias gradients are this rank's part (the trainer averages the
    parameter gradients over the ranks). Every rank runs the same three
    collectives per layer in the same order, the recompute of a
    checkpointed stage included. Returns y and the global mean and biased
    variance (no gradient)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        import torch.distributed as dist

        n = x.numel() // x.shape[1] * dist.get_world_size(group)
        total = _channel_sum(x)
        dist.all_reduce(total, group=group)
        mean = total / n
        centered = x - _per_channel(mean, x)
        squares = _channel_sum(centered * centered)
        dist.all_reduce(squares, group=group)
        var = squares / n
        invstd = torch.rsqrt(var + eps).to(x.dtype)
        xhat = centered * invstd[None, :, None, None]
        y = xhat * weight[None, :, None, None] + bias[None, :, None, None]
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.n, ctx.group = n, group
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        import torch.distributed as dist

        xhat, weight, invstd = ctx.saved_tensors
        dbias = _channel_sum(dy)
        dweight = _channel_sum(dy * xhat)
        sums = torch.cat([dbias, dweight])
        dist.all_reduce(sums, group=ctx.group)
        c = dbias.shape[0]
        dx = _per_channel(weight * invstd, dy) * (
            dy - _per_channel(sums[:c] / ctx.n, dy)
            - xhat * _per_channel(sums[c:] / ctx.n, dy))
        return (dx, dweight.to(weight.dtype), dbias.to(weight.dtype), None,
                None)


def use_global_batch_stats(model: nn.Module, group) -> None:
    """Give every :class:`BatchNorm` of ``model`` the data group whose
    rows make up the global batch (``None``: this rank's batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.data_group = group


def _bn(features: int) -> BatchNorm:
    return BatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM)


@contextlib.contextmanager
def _running_stats_frozen(module: nn.Module):
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn in bns:
            del bn.update_stats  # back to the class default


def checkpointed(fn, module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` with its activations recomputed in the backward; the
    recompute does not move the BatchNorm statistics of ``module``."""
    return checkpoint(
        fn, x, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(),
                            _running_stats_frozen(module)))


# flax's default kernel init, lecun_normal: a normal truncated at ±2
# standard deviations, scaled so the kept distribution has std
# sqrt(1 / fan_in); this constant is the std of a unit normal so truncated
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_like_flax(model: nn.Module,
                   generator: torch.Generator | None = None) -> nn.Module:
    """Re-initialize ``model`` as flax initializes the JAX model:
    convolution and dense kernels lecun_normal (fan_in = in_channels ·
    kh · kw, or in_features), biases 0, BatchNorm scale 1 and bias 0,
    running mean 0 and variance 1. A layer with a ``kernel_scale`` draws
    its kernel from flax's ``variance_scaling(kernel_scale, "fan_in",
    "truncated_normal")`` instead, and one with a ``flax_bias`` method
    sets its bias with it. Draws from ``generator`` (a CPU generator for
    a model on the CPU), or from torch's global generator when it is
    None."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            scale = getattr(m, "kernel_scale", 1.0)
            std = math.sqrt(scale / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
                if hasattr(m, "flax_bias"):
                    m.flax_bias(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


def _cast(t, dtype):
    return t if t is None or dtype is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``dtype`` when one is given (flax's
    ``dtype``: input, kernel and bias cast to it, the output in it); the
    parameters keep their own dtype."""

    def __init__(self, *args, dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        d = self.compute_dtype
        return self._conv_forward(_cast(x, d), _cast(self.weight, d),
                                  _cast(self.bias, d))


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` when one is given, as
    :class:`Conv2d`."""

    def __init__(self, *args, dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        d = self.compute_dtype
        return F.linear(_cast(x, d), _cast(self.weight, d),
                        _cast(self.bias, d))


class BasicBlock(nn.Module):
    """ResNet v1 basic block (3x3 + 3x3, projection shortcut on stride or
    width change)."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dtype=None):
        super().__init__()
        self.conv1 = Conv2d(in_features, features, 3, stride, padding=1,
                            bias=False, dtype=dtype)
        self.bn1 = _bn(features)
        self.conv2 = Conv2d(features, features, 3, 1, padding=1, bias=False,
                            dtype=dtype)
        self.bn2 = _bn(features)
        self.project = stride != 1 or in_features != features
        if self.project:
            self.downsample_conv = Conv2d(in_features, features, 1, stride,
                                          bias=False, dtype=dtype)
            self.downsample_bn = _bn(features)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x
        if self.project:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNet18(nn.Module):
    """ResNet-18 feature extractor: NCHW grayscale -> (B, 512) after a
    global average pool."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 in_channels: int = 1, dtype=None):
        super().__init__()
        self.conv1 = Conv2d(in_channels, 64, 7, 2, padding=3, bias=False,
                            dtype=dtype)
        self.bn1 = _bn(64)
        self.stages = []  # the blocks of each stage, in order
        cin = 64
        for stage, (n_blocks, width) in enumerate(zip(stage_sizes, widths)):
            blocks = []
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                name = f"layer{stage + 1}_{block}"
                self.add_module(name, BasicBlock(cin, width, stride, dtype))
                blocks.append(getattr(self, name))
                cin = width
            self.stages.append(nn.Sequential(*blocks))
        self.out_features = cin

    def _stem(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf

    def forward(self, x, remat: bool = False):
        """``remat``: recompute the stem and each stage in the backward."""
        parts = [(self._stem, self)] + [(s, s) for s in self.stages]
        for fn, module in parts:
            x = checkpointed(fn, module, x) if remat else fn(x)
        return torch.mean(x, dim=(2, 3))


class ResNetSQ(nn.Module):
    """ResNet18 -> MLP(256, 256) -> four heads. Returns
    ``(size, shape, position, quaternion)``. ``rot6d``: the continuous 6D
    rotation head (:class:`Rotation6DHead`) in place of the normalized
    quaternion; ``dtype``: see the module's docstring."""

    def __init__(self, fcn: int = 256, dtype=None, rot6d: bool = False):
        super().__init__()
        self.encoder = ResNet18(dtype=dtype)
        self.fc1 = Linear(self.encoder.out_features, fcn, dtype=dtype)
        self.fc2 = Linear(fcn, fcn, dtype=dtype)
        self.head_size = SizeHead(fcn)
        self.head_shape = ShapeHead(fcn)
        self.head_position = PositionHead(fcn)
        self.head_rotation = (Rotation6DHead if rot6d else RotationHead)(fcn)
        init_like_flax(self)

    def forward(self, x, remat: bool = False):
        """``x``: (B, H, W, 1) or (B, H, W) depth images in [0, 1];
        ``remat`` recomputes the encoder in the backward."""
        if x.ndim == 3:
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        h = F.leaky_relu(self.fc1(self.encoder(x, remat)), 0.01)
        h = F.leaky_relu(self.fc2(h), 0.01)
        return (self.head_size(h), self.head_shape(h),
                self.head_position(h), self.head_rotation(h))


def params_vector(outputs) -> torch.Tensor:
    """The 4-tuple model output -> the (B, 12) canonical vector; a single
    (B, k) tensor passes through."""
    if isinstance(outputs, (tuple, list)):
        return torch.cat(outputs, dim=-1)
    return outputs
