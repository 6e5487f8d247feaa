"""Dispatch to the hand-written CUDA kernels of the port.

Counterpart of ``sqtpu/ops/kernels/__init__.py``. A CUDA tensor goes to the
kernel, which launches or raises; a CPU tensor goes to the plain PyTorch
version. There is no silent fallback from the card to the plain version.

* :func:`render_hard_auto`: the hard ray-cast renderer (K3).
* :func:`implicit_loss_auto`: the implicit loss, forward K1 and backward K2
  for CUDA float32 params (any other dtype on the card raises); the plain
  :func:`sqtpu_torch.ops.losses.implicit_loss` for CPU tensors.
* :func:`explicit_loss_auto`: the explicit loss, K4 (fused value and pred
  gradient) or K5 (value alone, when nothing is differentiated) for CUDA
  float32 params (any other dtype on the card raises); the plain
  :func:`sqtpu_torch.ops.losses.explicit_loss` for CPU tensors. No size
  sends the card to the plain loss: the kernels take every N >= 2.
"""

from sqtpu_torch.ops.kernels.hardrender import (  # noqa: F401
    render_depth_hard_cuda as render_hard_auto,
)
from sqtpu_torch.ops.kernels.implicit import (  # noqa: F401
    implicit_loss_cuda as implicit_loss_auto,
)
from sqtpu_torch.ops.kernels.explicit import (  # noqa: F401
    explicit_loss_cuda as explicit_loss_auto,
)
