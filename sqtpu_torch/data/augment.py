"""Depth-map noise models: the sensor-noise protocol of evaluation
(``--noise-*``) and the training-time augmentation (``--augment-*``).

Counterpart of ``sqtpu/data/augment.py``, on [0, 1] orthographic depth
maps whose background is exactly 0:

* ``gaussian``: additive depth noise on object pixels only, clipped into
  [1/510, 1] so an object pixel stays one; the background stays 0;
* ``dropout``: object pixels dropped to 0 with this probability;
* ``salt``: background pixels set to a depth U(1/255, 1) with this
  probability (flying pixels);
* ``quantize``: rounding to the 8-bit lattice (z·255, half to even),
  applied last.

The draws come from an explicit ``torch.Generator`` on the images'
device, so they differ from ``jax.random``'s; the distributions are the
same.
"""

from __future__ import annotations

import torch


def _active(x) -> bool:
    """A Python zero switches a branch off; a tensor magnitude (per-sample
    domain randomization) always runs it, a zero there being a no-op."""
    return not (isinstance(x, (int, float)) and x <= 0.0)


def depth_noise(generator: torch.Generator, imgs: torch.Tensor, *,
                gaussian=0.0, dropout=0.0, salt=0.0,
                quantize: bool = False) -> torch.Tensor:
    """The configured corruptions of a batch of (..., H, W) depth maps.

    Magnitudes are Python floats or tensors that broadcast against
    ``imgs``, such as per-sample (B, 1, 1) magnitudes. Each branch draws
    one tensor of ``imgs``' shape (salt two), in the order gaussian,
    dropout, salt."""
    def draw(normal: bool = False):
        fn = torch.randn if normal else torch.rand
        return fn(imgs.shape, generator=generator, dtype=imgs.dtype,
                  device=imgs.device)

    zero = torch.zeros((), dtype=imgs.dtype, device=imgs.device)
    obj = imgs > 0.0
    out = imgs
    if _active(gaussian):
        noisy = torch.clamp(out + gaussian * draw(normal=True),
                            1.0 / 510.0, 1.0)
        out = torch.where(obj, noisy, out)
    if _active(dropout):
        keep = draw() < 1.0 - dropout
        out = torch.where(obj & ~keep, zero, out)
    if _active(salt):
        hit = draw() < salt
        depth = 1.0 / 255.0 + draw() * (1.0 - 1.0 / 255.0)
        out = torch.where(~obj & hit, depth, out)
    if quantize:
        out = torch.round(out * 255.0) / 255.0
    return out
