"""Dispatch to the hand-written CUDA kernels of the port.

Counterpart of ``sqtpu/ops/kernels/__init__.py``. A CUDA tensor goes to the
kernel, which launches or raises; a CPU tensor goes to the plain PyTorch
version. There is no silent fallback from the card to the plain version.

* :func:`render_hard_auto`: the hard ray-cast renderer (K3).
* :func:`implicit_loss_auto`: the implicit loss, forward K1 and backward K2
  for CUDA float32 params (any other dtype on the card raises); the plain
  :func:`sqtpu_torch.ops.losses.implicit_loss` for CPU tensors.
"""

from sqtpu_torch.ops.kernels.hardrender import (  # noqa: F401
    render_depth_hard_cuda as render_hard_auto,
)
from sqtpu_torch.ops.kernels.implicit import (  # noqa: F401
    implicit_loss_cuda as implicit_loss_auto,
)
