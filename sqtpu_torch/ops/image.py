"""Small image ops the losses need.

Counterpart of ``nearest_resize`` in ``sqtpu/ops/image.py:9-26``.
"""

from __future__ import annotations

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
