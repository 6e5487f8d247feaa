"""Dispatch to the hand-written CUDA kernels of the port.

Counterpart of ``sqtpu/ops/kernels/__init__.py``. A CUDA tensor goes to the
kernel, which launches or raises; a CPU tensor goes to the plain PyTorch
version. There is no silent fallback from the card to the plain version.
"""

from sqtpu_torch.ops.kernels.hardrender import (  # noqa: F401
    render_depth_hard_cuda as render_hard_auto,
)
