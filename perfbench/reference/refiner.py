"""The render-and-compare corrector ``refine_sq`` (``IterativeSQ``) written
plainly, in eval mode, as functions of one flat dict of tensors keyed by
the port's ``state_dict`` names (``base.…`` and ``refine.…``), computing in
the dict's dtype (float32, or float64 for a second witness).

The model (``sqtpu/models/refiner.py``): a ResNetSQ base estimates the
12 parameters; then ``n_refine`` passes of one shared block each render
the detached estimate with the hard ray-caster (unquantized, at the
input's size), stack the input image and the render into two channels,
run a second ResNet-18 over them, an MLP over [features ‖ estimate]
(fc1, fc2, leaky_relu 0.01) to an 11-vector delta, and update the
estimate by :func:`apply_delta`: additive and clipped in a, e and t, a
left-multiplied normalized quaternion dq = normalize([dv, 1]).

Departures from ``sqtpu/models/refiner.py``, each on purpose:

* eval mode only: BatchNorm normalizes with its running statistics; there
  is no train mode, no ``remat`` and no compute dtype below the dict's;
* the in-loop render is the benchmark's frozen plain ray-caster
  (:mod:`perfbench.reference.render`, in blocks of rows), computed in
  float32 from the estimate and cast to the image's dtype, as the
  package casts it; the JAX package renders with its own plain renderer;
* ``renders=``: a pass may take a given render (the program's own, in the
  benchmark's comparison) in place of its own render of its estimate, so
  that a silhouette pixel that two renderers round apart does not turn
  into a gap that has nothing to do with the program's arithmetic;
* ``tf32_on`` computes the convolutions and products in TF32, the
  lower-precision control; off by default, as in
  :func:`perfbench.reference.train.tf32`.

Nothing here imports JAX, the JAX package or the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import geometry, model, render
from perfbench.reference import quaternion as quat
from perfbench.reference.train import RENDER_ROWS, tf32

DELTA = 11
ENCODER_OUT = model.WIDTHS[-1]


def _encoder_convs(prefix: str, in_channels: int):
    """``model._convs()`` for an encoder under ``prefix`` with
    ``in_channels`` input channels."""
    out = []
    for conv, cin, cout, k, stride, bn in model._convs():
        if conv == "encoder.conv1":
            cin = in_channels
        out.append((prefix + conv, cin, cout, k, stride, prefix + bn))
    return out


def spec(fcn: int = model.FCN) -> list:
    """(key, shape, fan_in, kind) of every tensor of ``IterativeSQ``, in
    a fixed order, as :func:`perfbench.reference.model.spec` lists
    ResNetSQ's: the base's under ``base.``, then the block's under
    ``refine.``."""
    rows = [("base." + k, shape, fan, kind)
            for k, shape, fan, kind in model.spec()]
    for conv, cin, cout, k, _, bn in _encoder_convs("refine.", 2):
        rows.append((f"{conv}.weight", (cout, cin, k, k), cin * k * k,
                     "kernel"))
        rows += [(f"{bn}.weight", (cout,), 0, "ones"),
                 (f"{bn}.bias", (cout,), 0, "zeros"),
                 (f"{bn}.running_mean", (cout,), 0, "zeros"),
                 (f"{bn}.running_var", (cout,), 0, "ones")]
    for name, cin, cout in (("fc1", ENCODER_OUT + 12, fcn),
                            ("fc2", fcn, fcn), ("delta", fcn, DELTA)):
        rows += [(f"refine.{name}.weight", (cout, cin), cin, "kernel"),
                 (f"refine.{name}.bias", (cout,), 0, "zeros")]
    return rows


def apply_delta(p: torch.Tensor, delta: torch.Tensor,
                scale: float = 0.2) -> torch.Tensor:
    """(B, 12) estimates updated by (B, 11) deltas [da, de, dt, dv]."""
    d = delta * scale
    da, de, dt, dv = d[..., 0:3], d[..., 3:5], d[..., 5:8], d[..., 8:11]
    a = geometry.clip(p[..., 0:3] + da, geometry.A_MIN, geometry.A_MAX)
    e = geometry.clip(p[..., 3:5] + de, geometry.E_MIN, geometry.E_MAX)
    t = geometry.clip(p[..., 5:8] + dt, geometry.T_MIN, geometry.T_MAX)
    dq = quat.normalize(torch.cat([dv, torch.ones_like(dv[..., :1])], -1))
    q = quat.normalize(quat.multiply(dq, p[..., 8:12]))
    return torch.cat([a, e, t, q], dim=-1)


def encoder(w: dict, x: torch.Tensor, prefix: str) -> torch.Tensor:
    """Eval-mode ResNet-18 under ``prefix`` on (B, C, H, W) -> (B, 512)."""
    convs = {c[0]: c for c in _encoder_convs(prefix, x.shape[1])}

    def conv_bn(h, key):
        _, _, _, k, stride, bn = convs[key]
        h = F.conv2d(h, w[f"{key}.weight"], None, stride, k // 2)
        return model._bn(h, w, bn, False, {})

    x = F.relu(conv_bn(x, prefix + "encoder.conv1"))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for stage, n in enumerate(model.BLOCKS):
        for block in range(n):
            pre = f"{prefix}encoder.layer{stage + 1}_{block}"
            y = F.relu(conv_bn(x, f"{pre}.conv1"))
            y = conv_bn(y, f"{pre}.conv2")
            if f"{pre}.downsample_conv" in convs:
                x = conv_bn(x, f"{pre}.downsample_conv")
            x = F.relu(y + x)
    return x.mean(dim=(2, 3))


def block(w: dict, img2: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """One pass's delta: (B, H, W, 2) images and (B, 12) estimates ->
    (B, 11)."""
    feats = encoder(w, img2.permute(0, 3, 1, 2), "refine.")
    h = torch.cat([feats, p.to(feats.dtype)], dim=-1)
    for name in ("fc1", "fc2"):
        h = F.leaky_relu(F.linear(h, w[f"refine.{name}.weight"],
                                  w[f"refine.{name}.bias"]), 0.01)
    return F.linear(h, w["refine.delta.weight"], w["refine.delta.bias"])


def render_estimate(p: torch.Tensor, image_size: int, n_sweep: int,
                    n_bisect: int) -> torch.Tensor:
    """(B, S, S) unquantized depth maps of (B, 12) estimates by the plain
    ray-caster in float32, in blocks of rows."""
    p = p.detach().float()
    return torch.cat([
        render.render_depth_hard_batch(p[i:i + RENDER_ROWS], image_size,
                                       n_bisect=n_bisect, quantize=False,
                                       n_sweep=n_sweep)
        for i in range(0, p.shape[0], RENDER_ROWS)])


@torch.no_grad()
def forward(w: dict, imgs: torch.Tensor, n_refine: int = 2,
            delta_scale: float = 0.2, n_sweep: int = 48, n_bisect: int = 24,
            renders=None, tf32_on: bool = False):
    """(B, H, W, 1) depth images -> ((B, 12) predictions, the passes).

    The passes are a list of (estimate in, render) pairs, one per pass.
    ``renders`` (a list of (B, H, W) renders, one per pass, or shorter)
    replaces the pass's own render where it holds one."""
    dtype = w["base.encoder.conv1.weight"].dtype
    imgs = imgs.to(dtype)
    base = {k[len("base."):]: v for k, v in w.items()
            if k.startswith("base.")}
    passes = []
    with tf32(tf32_on):
        p = model.forward(base, imgs, False)[0]
        for i in range(n_refine):
            if renders is not None and i < len(renders):
                r = renders[i]
            else:
                r = render_estimate(p, imgs.shape[1], n_sweep, n_bisect)
            passes.append((p, r))
            img2 = torch.cat([imgs, r[..., None].to(dtype)], dim=-1)
            p = apply_delta(p, block(w, img2, p), delta_scale)
    return p, passes
