"""Frozen copy of the port's plain ``sqtpu_torch/ops/image.py``, kept
with the benchmark so that a later change to the program cannot move
the reference it is judged by. Its own docstring follows.

Small image ops: the losses' resize and the depth-map filters.

Counterpart of ``sqtpu/ops/image.py``: ``nearest_resize``, ``norm_img``,
``despeckle``, ``median3`` and ``depth_to_points``. The filters work on
(..., H, W) tensors on any device and give the JAX package's bits.
"""

from __future__ import annotations

import numpy as np
import torch


def nearest_resize(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of (..., H, W) to (..., h, w) with
    ``torch.nn.functional.interpolate(mode="nearest")`` semantics: the
    source index is ``floor(dst · src / dst_size)``, in integers."""
    h_in, w_in = img.shape[-2], img.shape[-1]
    h_out, w_out = out_hw
    rows = torch.arange(h_out, device=img.device) * h_in // h_out
    cols = torch.arange(w_out, device=img.device) * w_in // w_out
    return img[..., rows[:, None], cols[None, :]]


def norm_img(img: torch.Tensor) -> torch.Tensor:
    """Min-max normalize to [0, 1] over the whole tensor."""
    img = img - torch.min(img)
    return img / torch.clamp(torch.max(img), min=1e-12)


def _shifted(p: torch.Tensor, h: int, w: int):
    """The nine 3×3-window views of a (..., H+2, W+2) padded tensor, in
    row-major order of the window."""
    return [p[..., di:di + h, dj:dj + w] for di in range(3) for dj in range(3)]


def despeckle(img: torch.Tensor, min_neighbors: int = 2) -> torch.Tensor:
    """Drop isolated object pixels (flying pixels, multipath ghosts): an
    object pixel (depth > 0) stays only if at least ``min_neighbors`` of
    its 8 neighbours are object pixels too. Shape-preserving on
    (..., H, W), on any device."""
    h, w = img.shape[-2], img.shape[-1]
    obj = (img > 0).to(img.dtype)
    cnt = -obj  # subtract the pixel itself, then add the full window
    for v in _shifted(torch.nn.functional.pad(obj, (1, 1, 1, 1)), h, w):
        cnt = cnt + v
    return torch.where((img > 0) & (cnt < min_neighbors),
                       torch.zeros((), dtype=img.dtype, device=img.device),
                       img)


def median3(img: torch.Tensor) -> torch.Tensor:
    """3×3 median filter with zero padding: the 5th of the 9 sorted window
    values (what ``jnp.median`` gives for an odd count). Halves Gaussian
    ranging noise, removes isolated flying pixels and fills isolated
    dropout holes; silhouette pixels with fewer than 5 object neighbours
    erode by at most one pixel. Shape-preserving on (..., H, W)."""
    h, w = img.shape[-2], img.shape[-1]
    p = torch.nn.functional.pad(img, (1, 1, 1, 1))
    stack = torch.stack(_shifted(p, h, w), dim=-1)
    return torch.sort(stack, dim=-1).values[..., 4]


def depth_to_points(img, flip_vertical: bool = True) -> np.ndarray:
    """Nonzero depth pixels of one (H, W) map as an (N, 3) ``(x, y, z)``
    point list: the rows flipped (``flip_vertical``), then (column, row,
    value). Host-side numpy (the output is ragged)."""
    a = img.detach().cpu().numpy() if torch.is_tensor(img) else np.asarray(img)
    if flip_vertical:
        a = a[::-1]
    r, c = np.nonzero(a)
    return np.stack([c, r, a[r, c]], axis=-1)
