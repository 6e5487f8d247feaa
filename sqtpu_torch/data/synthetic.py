"""Random superquadric parameters for the closed-loop evaluation.

Counterpart of ``sample_params`` in ``sqtpu/data/synthetic.py:27-57``:
a ~ U(25, 75)/255, e ~ U(0.1, 1.0), t ~ (128 + U(−40, 40))/255, q
Shoemake-uniform, then the canonical gauge a1 >= a2. The numbers come
from a ``torch.Generator``, so they differ from ``jax.random``'s; the
distribution is the same.
"""

from __future__ import annotations

import torch

from sqtpu_torch.ops import quaternion as quat
from sqtpu_torch.ops.losses import canonicalize_gauge


def _uniform(shape, lo, hi, generator, dtype, device):
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return lo + u * (hi - lo)


def sample_params(batch: int, generator: torch.Generator,
                  dtype=torch.float32, device=None,
                  canonical: bool = True) -> torch.Tensor:
    """(B, 12) random rotation-data parameters in normalized units.

    ``device`` defaults to the generator's device."""
    device = generator.device if device is None else device
    a = _uniform((batch, 3), 25 / 255, 75 / 255, generator, dtype, device)
    e = _uniform((batch, 2), 0.1, 1.0, generator, dtype, device)
    t = (128.0 + _uniform((batch, 3), -40.0, 40.0, generator, dtype,
                          device)) / 255.0
    q = quat.random_uniform((batch,), generator, dtype, device)
    p = torch.cat([a, e, t, q], dim=-1)
    return canonicalize_gauge(p) if canonical else p
