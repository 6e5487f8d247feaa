"""Direct fitting of superquadrics to depth maps.

Counterpart of ``sqtpu/fit.py``. Only :func:`apply_prefilter`
(``sqtpu/fit.py:217-230``), which the inference surfaces' ``input_filter``
uses, is here; the classical recovery and the test-time refinement
(``image_points``, ``moments_init``, ``lm_fit``, ``recover``,
``refine_params``, ``gd_fit``, ``main``) are ROADMAP.md Slice D and do
not exist in the port yet.
"""

from __future__ import annotations

import torch

from sqtpu_torch.ops.image import despeckle, median3


def apply_prefilter(img: torch.Tensor, prefilter: str) -> torch.Tensor:
    """Depth-map cleanup on (..., H, W): ``"despeckle"`` drops isolated
    object pixels, ``"median"`` is the 3×3 median (it also halves ranging
    noise and fills dropout holes), ``"none"`` (or empty) is the
    identity. Any other name raises ``ValueError``."""
    if prefilter == "despeckle":
        return despeckle(img)
    if prefilter == "median":
        return median3(img)
    if prefilter in ("none", "", None):
        return img
    raise ValueError(f"unknown prefilter {prefilter!r}")
