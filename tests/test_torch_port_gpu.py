"""The CUDA kernels K1/K2 of the implicit loss on the card.

Every test here launches a kernel and skips without an NVIDIA GPU. The
file imports neither JAX nor the JAX package, so it runs on a card's host
that has only torch:

    python -m pytest -m gpu tests/test_torch_port_gpu.py

K1/K2 are held against the torch emulation of their algorithm and against
the plain loss (autograd) with the tolerances of
tests/test_torch_port_implicit.py, and must be identical run to run.
"""

import numpy as np
import pytest
import torch

from sqtpu_torch.ops import losses as tlosses
from sqtpu_torch.ops.kernels import implicit as K
from sqtpu_torch.ops.kernels import implicit_loss_auto


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def grad_atol(g: np.ndarray) -> float:
    """1e-6, or 1e-4 of the gradient's largest component where that is
    larger: the fp32 noise floor of the single-sweep backward (see
    tests/test_torch_port_implicit.py)."""
    return max(1e-6, 1e-4 * float(np.abs(g).max()))


def _batch(seed: int, b: int = 2):
    """(B, 12) params of the reference eval distribution and (B, 48, 48)
    noise images, numpy-made."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p = np.concatenate([rng.uniform(25 / 255, 75 / 255, (b, 3)),
                        rng.uniform(0.1, 1.0, (b, 2)),
                        (128.0 + rng.uniform(-40, 40, (b, 3))) / 255.0, q],
                       axis=-1)
    img = rng.uniform(0.05, 0.9, (b, 48, 48))
    return p.astype(np.float32), img.astype(np.float32)


def _torch_value_and_grads(fn, p, img, n, z_window, device="cpu"):
    tp = torch.tensor(p, device=device, requires_grad=True)
    ti = torch.tensor(img, device=device, requires_grad=True)
    loss = fn(ti, tp, n, 1.5, 260.0, z_window=z_window)
    loss.backward()
    return loss.item(), tp.grad.cpu().numpy(), ti.grad.cpu().numpy()


def _plain(img, p, n, tau, sharp, z_window=True):
    return tlosses.implicit_loss(img, p, n, tau, sharp)


@pytest.mark.gpu
@pytest.mark.parametrize("z_window", [True, False])
def test_kernels_match_emulation_and_plain_on_card(cuda_device, z_window):
    p, img = _batch(70, 8)
    K.reset_launches()
    got = _torch_value_and_grads(K.implicit_loss_cuda, p, img, 64, z_window,
                                 cuda_device)
    assert (K.fwd_launches, K.bwd_launches) == (1, 1)
    again = _torch_value_and_grads(K.implicit_loss_cuda, p, img, 64,
                                   z_window, cuda_device)
    for a, b in zip(got, again):  # no atomics: identical run to run
        np.testing.assert_array_equal(a, b)
    for fn in (K.implicit_loss_emulated, _plain):
        want = _torch_value_and_grads(fn, p, img, 64, z_window, cuda_device)
        assert got[0] == pytest.approx(want[0], rel=1e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=5e-3,
                                   atol=grad_atol(want[1]))
        np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=0)


@pytest.mark.gpu
def test_dispatch_on_card(cuda_device):
    p, img = _batch(71, 4)
    tp = torch.tensor(p, device=cuda_device)
    ti = torch.tensor(img, device=cuda_device)
    K.reset_launches()
    with torch.no_grad():
        implicit_loss_auto(ti, tp, 64)
    assert (K.fwd_launches, K.bwd_launches) == (1, 0)
    with pytest.raises(TypeError):
        implicit_loss_auto(ti.double(), tp.double(), 64)
    with pytest.raises(ValueError):
        implicit_loss_auto(ti.cpu(), tp, 64)


@pytest.mark.gpu
def test_refused_launch_raises(cuda_device, monkeypatch):
    """A launcher that reports a CUDA error (here a stand-in returning
    cudaErrorInvalidConfiguration) makes the wrapper raise and count
    nothing."""
    lib = K._lib()

    class Refusing:
        sqtpu_implicit_blocks = lib.sqtpu_implicit_blocks
        sqtpu_error_string = lib.sqtpu_error_string

        @staticmethod
        def sqtpu_implicit_fwd(*args):
            return 9

    monkeypatch.setattr(K, "_lib", lambda: Refusing)
    p, img = _batch(72, 2)
    par = K.pack_params(torch.tensor(p, device=cuda_device), 16)
    img_xy = K.image_plane(torch.tensor(img, device=cuda_device), 16)
    K.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        K.cuda_fwd(img_xy, par, 16, 16, 1.5, 260.0)
    assert K.fwd_launches == 0
