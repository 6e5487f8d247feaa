"""sqtpu_torch: the PyTorch + CUDA port of sqtpu for NVIDIA Hopper (H100).

A package beside the JAX package ``sqtpu``, which stays the reference the
port is held against. It imports torch and numpy, never jax and nothing of
``sqtpu``. Module paths mirror ``sqtpu``'s. Kernels are hand-written CUDA
C++ under ``csrc/``, built with ``nvcc`` at first use into ``build/``.

Ported so far: closed-loop evaluation (:mod:`sqtpu_torch.evaluate`) and
serving (:mod:`sqtpu_torch.serve`) of ResNetSQ, with the hard ray-cast
renderer as the CUDA kernel ``csrc/hardrender.cu``; and self-supervised
training of ResNetSQ with the implicit loss (:mod:`sqtpu_torch.train`),
with the loss's forward and backward as the CUDA kernels
``csrc/implicit.cu``. See ROADMAP.md for the slices still to port.
"""

__version__ = "0.1.0"
