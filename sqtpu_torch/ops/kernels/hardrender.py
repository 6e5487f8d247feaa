"""The hard ray-cast renderer as a hand-written CUDA kernel.

Counterpart of ``sqtpu/ops/kernels/hardrender.py`` (the Pallas TPU kernel
``_kernel`` launched by ``render_depth_hard_pallas``). The kernel source is
``sqtpu_torch/csrc/hardrender.cu``; it is built with ``nvcc`` at first use
and called through ``ctypes``. The frame scalars are packed here in torch
exactly as the JAX wrapper packs them.

:func:`render_depth_hard_cuda` takes a CUDA tensor to the kernel and a CPU
tensor to the plain version (:func:`sqtpu_torch.ops.render
.render_depth_hard_batch`); on a CUDA tensor it launches the kernel or
raises. Forward only: no gradient flows through a ground-truth render.
"""

from __future__ import annotations

import ctypes

import torch

from sqtpu_torch.ops import geometry
from sqtpu_torch.ops import quaternion as quat
from sqtpu_torch.ops.render import render_depth_hard_batch

PAR_STRIDE = 24  # floats per sample in the packed frame scalars

# Launches of the CUDA kernel since the last reset_launches(); the wrapper
# adds one where it launches and nowhere else.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    from sqtpu_torch.ops.kernels import _build

    lib = _build.load("hardrender")
    if not getattr(lib, "_sqtpu_typed", False):
        fn = lib.sqtpu_hardrender
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.sqtpu_error_string.argtypes = [ctypes.c_int]
        lib.sqtpu_error_string.restype = ctypes.c_char_p
        lib._sqtpu_typed = True
    return lib


def pack_frames(p: torch.Tensor, n_sweep: int) -> torch.Tensor:
    """(B, 12) params -> (B, 24) float32 frame scalars:
    a (0-2), 1/e2 (3), e2/e1 (4), 1/e1 (5), R(q*)·t (6-8), R(q*) (9-17),
    z_hi (18), step (19), zero padding (20-23)."""
    p = p.to(torch.float32)
    b = p.shape[0]
    a, e, t, q = geometry.split_params(p)
    rot = quat.to_matrix(quat.conjugate(q))
    tr = torch.einsum("bij,bj->bi", rot, t)
    _, z_hi, step = geometry.z_support_window(a, rot, t, n_sweep)
    return torch.cat([
        a,
        (1.0 / e[:, 1])[:, None],
        (e[:, 1] / e[:, 0])[:, None],
        (1.0 / e[:, 0])[:, None],
        tr,
        rot.reshape(b, 9),
        z_hi[:, None], step[:, None],
        p.new_zeros((b, PAR_STRIDE - 20)),
    ], dim=-1).contiguous()


def render_depth_hard_cuda(p: torch.Tensor, image_size: int = 256,
                           n_sweep: int = 48, n_bisect: int = 12,
                           quantize: bool = True) -> torch.Tensor:
    """(B, 12) params -> (B, S, S) float32 depth maps, image layout."""
    global launches
    if p.ndim != 2 or p.shape[-1] != geometry.N_PARAMS:
        raise ValueError(f"params must be (B, 12), got {tuple(p.shape)}")
    if not p.is_floating_point():
        raise TypeError(f"params must be floating point, got {p.dtype}")
    if image_size < 2 or n_sweep < 2 or n_bisect < 0:
        raise ValueError(
            f"need image_size >= 2, n_sweep >= 2, n_bisect >= 0; got "
            f"{image_size}, {n_sweep}, {n_bisect}")
    if p.device.type == "cpu":
        return render_depth_hard_batch(p, image_size, n_bisect=n_bisect,
                                       quantize=quantize, n_sweep=n_sweep)
    if p.device.type != "cuda":
        raise ValueError(f"no kernel for device {p.device}")
    b = p.shape[0]
    if not 0 < b <= 65535:
        raise ValueError(f"batch {b} outside the kernel's grid (1..65535)")
    par = pack_frames(p, n_sweep)
    out = torch.empty((b, image_size, image_size), dtype=torch.float32,
                      device=p.device)
    if not (par.is_contiguous() and par.dtype == torch.float32
            and par.shape == (b, PAR_STRIDE)):
        raise RuntimeError("packed frame scalars have the wrong layout")
    lib = _lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.sqtpu_hardrender(par.data_ptr(), out.data_ptr(), b,
                                   image_size, n_sweep, n_bisect,
                                   int(bool(quantize)), stream)
    if err != 0:
        raise RuntimeError("hardrender kernel launch failed: "
                           + lib.sqtpu_error_string(err).decode())
    launches += 1
    return out
