"""ResNetSQ written plainly: ResNet-18 (widths 64-512), an MLP of 256 and
the four heads, as functions of one flat dict of tensors (float32, or
float64 for a second witness), computing in the dict's dtype.

The dict's keys are the ``state_dict`` keys of the port's model, so both
sides load one set of weights that the benchmark makes or reads. Train
mode normalizes with the batch's biased variance and moves the running
statistics with that same variance and momentum 0.01 (flax's 0.99), as
the JAX package's ``nn.BatchNorm`` does. Padding is explicit: (3, 3) on
the 7x7 stem, (1, 1) on every 3x3 convolution, and the 3x3 max pool pads
with −inf.

``quant`` is applied to the input and the weight of every convolution and
dense layer of the encoder and the MLP (the layers the port computes in a
lower precision when asked): the identity for the reference, an fp8
rounding for the lower-precision control (:func:`fp8_round`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.01
WIDTHS = (64, 128, 256, 512)
BLOCKS = (2, 2, 2, 2)
FCN = 256
HEADS = (("head_size", 3), ("head_shape", 2), ("head_position", 3),
         ("head_rotation", 4))


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude maps to e4m3's largest, 448), as fp8 training scales a
    tensor, and back; the gradient passes straight through."""
    amax = t.detach().abs().amax().clamp(min=1e-12)
    scale = 448.0 / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t).detach()


def _convs():
    """(key prefix, in, out, kernel, stride) of every convolution, and the
    BatchNorm after it (its prefix)."""
    out = [("encoder.conv1", 1, 64, 7, 2, "encoder.bn1")]
    cin = 64
    for stage, (n, width) in enumerate(zip(BLOCKS, WIDTHS)):
        for block in range(n):
            stride = 2 if (stage > 0 and block == 0) else 1
            pre = f"encoder.layer{stage + 1}_{block}"
            out.append((f"{pre}.conv1", cin, width, 3, stride, f"{pre}.bn1"))
            out.append((f"{pre}.conv2", width, width, 3, 1, f"{pre}.bn2"))
            if stride != 1 or cin != width:
                out.append((f"{pre}.downsample_conv", cin, width, 1, stride,
                            f"{pre}.downsample_bn"))
            cin = width
    return out


def spec() -> list:
    """(key, shape, fan_in, kind) of every tensor of the model, in a fixed
    order; kind is ``kernel`` (drawn), ``zeros``, ``ones``."""
    rows = []
    for conv, cin, cout, k, _, bn in _convs():
        rows.append((f"{conv}.weight", (cout, cin, k, k), cin * k * k,
                     "kernel"))
        rows += [(f"{bn}.weight", (cout,), 0, "ones"),
                 (f"{bn}.bias", (cout,), 0, "zeros"),
                 (f"{bn}.running_mean", (cout,), 0, "zeros"),
                 (f"{bn}.running_var", (cout,), 0, "ones")]
    for name, cin, cout in (("fc1", WIDTHS[-1], FCN), ("fc2", FCN, FCN)):
        rows += [(f"{name}.weight", (cout, cin), cin, "kernel"),
                 (f"{name}.bias", (cout,), 0, "zeros")]
    for name, cout in HEADS:
        rows += [(f"{name}.Dense_0.weight", (cout, FCN), FCN, "kernel"),
                 (f"{name}.Dense_0.bias", (cout,), 0, "zeros")]
    return rows


def is_stat(key: str) -> bool:
    return key.endswith("running_mean") or key.endswith("running_var")


def _bn(x, w, prefix, train, new_stats):
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
        with torch.no_grad():
            for leaf, batch in (("running_mean", mean), ("running_var", var)):
                key = f"{prefix}.{leaf}"
                new_stats[key] = ((1.0 - BN_MOMENTUM) * w[key]
                                  + BN_MOMENTUM * batch.detach())
    else:
        mean, var = w[f"{prefix}.running_mean"], w[f"{prefix}.running_var"]
    y = (x - mean[None, :, None, None]) * torch.rsqrt(
        var[None, :, None, None] + BN_EPS)
    return (y * w[f"{prefix}.weight"][None, :, None, None]
            + w[f"{prefix}.bias"][None, :, None, None])


def forward(w: dict, imgs: torch.Tensor, train: bool, quant=identity):
    """(B, H, W, 1) depth images -> ((B, 12) params, the running
    statistics after this batch in train mode, else {})."""
    stats = {}
    convs = {c[0]: c for c in _convs()}

    def conv_bn(x, key):
        _, _, _, k, stride, bn = convs[key]
        x = F.conv2d(quant(x), quant(w[f"{key}.weight"]), None, stride,
                     k // 2)
        return _bn(x, w, bn, train, stats)

    x = imgs.to(w["encoder.conv1.weight"].dtype).permute(0, 3, 1, 2)
    x = F.relu(conv_bn(x, "encoder.conv1"))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for stage, n in enumerate(BLOCKS):
        for block in range(n):
            pre = f"encoder.layer{stage + 1}_{block}"
            y = F.relu(conv_bn(x, f"{pre}.conv1"))
            y = conv_bn(y, f"{pre}.conv2")
            if f"{pre}.downsample_conv" in convs:
                x = conv_bn(x, f"{pre}.downsample_conv")
            x = F.relu(y + x)
    h = x.mean(dim=(2, 3))
    for name in ("fc1", "fc2"):
        h = F.leaky_relu(F.linear(quant(h), quant(w[f"{name}.weight"]),
                                  w[f"{name}.bias"]), 0.01)
    outs = []
    for name, _ in HEADS:
        z = F.linear(h, w[f"{name}.Dense_0.weight"], w[f"{name}.Dense_0.bias"])
        if name == "head_rotation":
            z = z * torch.rsqrt(torch.clamp(torch.sum(z * z, -1, keepdim=True),
                                            min=1e-6))
        else:
            z = torch.sigmoid(z)
        outs.append(z)
    return torch.cat(outs, dim=-1), stats
