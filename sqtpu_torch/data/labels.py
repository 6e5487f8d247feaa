"""Label de-normalization, a numpy copy of ``sqtpu/data/labels.py:86``."""

from __future__ import annotations

import numpy as np


def denormalize_torch(p: np.ndarray) -> np.ndarray:
    """[a·255, e, t·255, q]: the reference units printed by the reference's
    single-image test script."""
    p = np.asarray(p)
    out = p.copy()
    out[..., 0:3] = p[..., 0:3] * 255.0
    out[..., 5:8] = p[..., 5:8] * 255.0
    return out
