"""The emulation of the kernels K1/K2 of the implicit loss against the JAX
package's Pallas kernels. The CUDA kernels themselves are tested on the
card by tests/test_torch_port_gpu.py.

On the CPU the emulation of the kernels' algorithm
(``sqtpu_torch.ops.kernels.implicit.emulate_fwd/emulate_bwd``) is held
against ``sqtpu.ops.kernels.implicit.implicit_loss_pallas`` run by Pallas
in interpret mode, with the JAX package's own kernel tolerances
(tests/test_pallas_kernel.py:46, 58, 61-73, 119): value relative 1e-5,
12-param gradient rtol 5e-3, image gradient rtol 1e-4 on noise images (the
image gradient is sign(img − depth)·g, and noise keeps img − depth away
from the ties where fp32 may flip a sign), and zero gradient for
clamped-out parameters.

The gradient's absolute tolerance is 1e-6 or 1e-4 of the gradient's
largest component, whichever is larger. The single-sweep backward
recovers W_j as a difference of sums of up to n transmittances, so in
fp32 each implementation sits up to ~5e-5 of that scale from the fp64
result (measured on six seeds at n = 16 and 32, both sweeps); near-zero
components that cancel then differ by a few 1e-6 between two fp32
implementations. :func:`test_emulation_matches_pallas_interpret` also
holds both against the fp64 emulation, which equals autograd of the plain
loss to fp64 noise (tests/test_torch_port_loss.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sqtpu.ops.kernels import implicit as jimplicit
from sqtpu_torch.ops.kernels import implicit as K

from test_torch_port_gpu import _batch, _torch_value_and_grads, grad_atol
from test_torch_port_ops import _few_torch_threads  # noqa: F401


def _jax_value_and_grads(p, img, n, z_window):
    def f(pp, im):
        return jimplicit.implicit_loss_pallas(im, pp, n, 1.5, 260.0,
                                              z_window=z_window)

    v, (gp, gi) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(p),
                                                        jnp.asarray(img))
    return float(v), np.asarray(gp), np.asarray(gi)


@pytest.mark.parametrize("n,z_window", [(16, True), (16, False),
                                        (32, True), (32, False)])
def test_emulation_matches_pallas_interpret(monkeypatch, n, z_window):
    monkeypatch.setenv("SQTPU_PALLAS_INTERPRET", "1")
    p, img = _batch(50 + n + int(z_window))
    want = _jax_value_and_grads(p, img, n, z_window)
    got = _torch_value_and_grads(K.implicit_loss_emulated, p, img, n,
                                 z_window)
    atol = grad_atol(want[1])
    assert got[0] == pytest.approx(want[0], rel=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=5e-3, atol=atol)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=0)
    assert np.abs(want[2]).sum() > 0 and np.abs(want[1]).sum() > 0
    # both fp32 results against the fp64 emulation
    exact = _torch_value_and_grads(K.implicit_loss_emulated, p.astype(
        np.float64), img.astype(np.float64), n, z_window)
    for fp32 in (got, want):
        assert fp32[0] == pytest.approx(exact[0], rel=1e-5)
        np.testing.assert_allclose(fp32[1], exact[1], rtol=5e-3, atol=atol)


def test_emulation_respects_the_clamp_like_pallas(monkeypatch):
    monkeypatch.setenv("SQTPU_PALLAS_INTERPRET", "1")
    p, img = _batch(60)
    p[0, 0] = 1.5   # a1 above the clamp's maximum
    p[1, 3] = 0.05  # e1 below the clamp's minimum
    want = _jax_value_and_grads(p, img, 16, True)
    got = _torch_value_and_grads(K.implicit_loss_emulated, p, img, 16, True)
    assert want[1][0, 0] == 0.0 and want[1][1, 3] == 0.0
    assert got[1][0, 0] == 0.0 and got[1][1, 3] == 0.0
    np.testing.assert_allclose(got[1], want[1], rtol=5e-3,
                               atol=grad_atol(want[1]))
