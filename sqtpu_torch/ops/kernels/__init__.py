"""Dispatch to the hand-written CUDA kernels of the port.

Counterpart of ``sqtpu/ops/kernels/__init__.py``. A CUDA tensor goes to the
kernel, which launches or raises; a CPU tensor goes to the plain PyTorch
version. There is no silent fallback from the card to the plain version.

* :func:`render_hard_auto`: the hard ray-cast renderer (K3).
* :func:`implicit_loss_auto`: the implicit loss, forward K1 and backward K2
  for CUDA float32 params (any other dtype on the card raises); the plain
  :func:`sqtpu_torch.ops.losses.implicit_loss` for CPU tensors.
* :func:`implicit_sums_slab_auto`: the implicit loss's per-sample partial
  sums over a slab of image columns (the grid-sharded loss), K6 (K1/K2
  launched on the slab) for CUDA float32 params (any other dtype on the
  card raises); the plain slab render for CPU tensors. The JAX package
  takes its kernel only for lane-divisible slabs, (n·n_cols) % 128 == 0
  (``sqtpu/parallel/sharded_losses.py:158-160``), and the plain slab
  otherwise; the CUDA kernel takes every slab width, so the port uses K6
  for all of them: the same function by another route.
* :func:`explicit_loss_auto`: the explicit loss, K4 (fused value and pred
  gradient) or K5 (value alone, when nothing is differentiated) for CUDA
  float32 params (any other dtype on the card raises); the plain
  :func:`sqtpu_torch.ops.losses.explicit_loss` for CPU tensors. No size
  sends the card to the plain loss: the kernels take every N >= 2.
* :func:`voxel_iou_cuda`: the voxel IoU's intersection and union counts of
  several pairs of parameter sets at once, K7, for CUDA float32 and
  bfloat16 params or float64 ones; :func:`sqtpu_torch.ops.metrics.iou_counts` and
  ``iou_full`` send CUDA tensors to it and keep the plain grids for CPU
  tensors.

Each kernel's wrapper counts its launches; :func:`launch_counts` reads the
counters and :func:`reset_launches` sets them to 0.
"""

from sqtpu_torch.ops.kernels.hardrender import (  # noqa: F401
    render_depth_hard_cuda as render_hard_auto,
)
from sqtpu_torch.ops.kernels.implicit import (  # noqa: F401
    implicit_loss_cuda as implicit_loss_auto,
    implicit_sums_slab_cuda as implicit_sums_slab_auto,
)
from sqtpu_torch.ops.kernels.explicit import (  # noqa: F401
    explicit_loss_cuda as explicit_loss_auto,
)
from sqtpu_torch.ops.kernels.voxel_iou import voxel_iou_cuda  # noqa: F401
from sqtpu_torch.ops.kernels import explicit, hardrender, implicit, voxel_iou


def launch_counts() -> dict:
    """Launches of every kernel since the last :func:`reset_launches`:
    K3, K1, K2, K4, K5, K6's forward and backward, and K7."""
    return {"K3": hardrender.launches, "K1": implicit.fwd_launches,
            "K2": implicit.bwd_launches, "K4": explicit.fused_launches,
            "K5": explicit.fwd_launches, "K6": implicit.slab_fwd_launches,
            "K6_bwd": implicit.slab_bwd_launches, "K7": voxel_iou.launches}


def reset_launches() -> None:
    hardrender.reset_launches()
    implicit.reset_launches()
    explicit.reset_launches()
    voxel_iou.reset_launches()
