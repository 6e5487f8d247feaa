"""sqtpu_torch: the PyTorch + CUDA port of sqtpu for NVIDIA Hopper (H100).

A package beside the JAX package ``sqtpu``, which stays the reference the
port is held against. It imports torch and numpy, never jax and nothing of
``sqtpu``. Module paths mirror ``sqtpu``'s. Kernels are hand-written CUDA
C++ under ``csrc/``, built with ``nvcc`` at first use into ``build/``.

Ported so far: closed-loop evaluation (:mod:`sqtpu_torch.evaluate`) and
serving (:mod:`sqtpu_torch.serve`) of ResNetSQ, with the hard ray-cast
renderer as the CUDA kernel ``csrc/hardrender.cu``; training of ResNetSQ
(:mod:`sqtpu_torch.train`), self-supervised with the implicit loss
(``csrc/implicit.cu``) and supervised with the explicit loss
(``csrc/explicit.cu``); and training over several ranks with the JAX
package's ('data', 'grid') axes (:mod:`sqtpu_torch.parallel`), the grid
axis through K6, the implicit loss on a column slab; the sensor-noise
protocol (:mod:`sqtpu_torch.data.augment`, the filters of
:mod:`sqtpu_torch.ops.image`), directory datasets and the bulk entry
points (:mod:`sqtpu_torch.predict`, :mod:`sqtpu_torch.generate`,
:mod:`sqtpu_torch.scan`, ``evaluate single``). See ROADMAP.md for the
slices still to port.
"""

__version__ = "0.1.0"
