"""The redesigned K1/K2 (the implicit loss's forward and backward) and with
them K6 (K1/K2 on a column slab): their algorithm, proven on the CPU
through the torch emulation. The CUDA kernels are held against this
emulation on the card by tests/test_torch_port_gpu.py and chip_smoke.py.

* The emulation (per-sample reciprocals, body coordinates linear in z, 11
  running sums a pixel, the exact-zero cull) with the cull and without it
  against the JAX package's Pallas kernels in interpret mode, on the whole
  plane and on slabs, with the tolerances of
  tests/test_torch_port_implicit.py and tests/test_torch_port_parallel.py
  (value relative 1e-5, the params' gradient rtol 5e-3 with
  ``grad_atol``, the image gradient rtol 1e-4 on noise images).
* The cull skips only exact zeros: on params at the clamp's extremes (a =
  0.05, e = 0.1 and 1), shapes cut by the image border and slabs of 10
  columns at several x0, every point it skips has occupancy exactly 0.0
  in float32, and the sweep with the cull equals the sweep without it bit
  for bit in the sums, Tacc, the params' gradient and the image gradient.
* Rows, sharpnesses and τ the proof does not cover sweep their whole
  window, and so does a pixel whose cotangent or Tacc is not finite: a
  NaN cotangent or image pixel gives the same NaNs with the cull as
  without it.
* The sources: the chain of csrc/sq_field.cuh, no float atomics, no fast
  intrinsics.
"""

import functools
import math
import os

import numpy as np
import pytest
import torch

from sqtpu_torch.ops.kernels import _build
from sqtpu_torch.ops.kernels import implicit as K
from sqtpu_torch.ops.kernels.sq_field import _occupancy, cull_sound

from test_torch_port_gpu import _batch, _torch_value_and_grads, grad_atol
from test_torch_port_implicit import _jax_value_and_grads
from test_torch_port_ops import _few_torch_threads  # noqa: F401
from test_torch_port_parallel import _jax_slab, _port_slab, _slab
from test_torch_port_redesign import _extreme_batch

TAU, SHARP = 1.5, 260.0
UNCUT = K._Impl(functools.partial(K.emulate_fwd, cull=False),
                functools.partial(K.emulate_bwd, cull=False))


def _uncut_loss(img, pred_p, n, tau, sharp, z_window=True):
    return K._sweep_loss(UNCUT, img, pred_p, n, tau, sharp, z_window,
                         K.Z_MARGIN)


def _uncut_slab(img_slab, pred_p, x0, n, tau, sharp, z_window=True):
    return K._slab_sums(UNCUT, img_slab, pred_p, x0, n, tau, sharp,
                        z_window, K.Z_MARGIN)


@pytest.mark.parametrize("n,z_window", [(16, True), (16, False),
                                        (32, True), (32, False)])
def test_cut_and_uncut_emulations_match_pallas_interpret(monkeypatch, n,
                                                         z_window):
    monkeypatch.setenv("SQTPU_PALLAS_INTERPRET", "1")
    p, img = _batch(150 + n + int(z_window), 3)
    want = _jax_value_and_grads(p, img, n, z_window)
    cut = _torch_value_and_grads(K.implicit_loss_emulated, p, img, n,
                                 z_window)
    uncut = _torch_value_and_grads(_uncut_loss, p, img, n, z_window)
    for a, b in zip(cut, uncut):
        np.testing.assert_array_equal(a, b)
    assert cut[0] == pytest.approx(want[0], rel=1e-5)
    np.testing.assert_allclose(cut[1], want[1], rtol=5e-3,
                               atol=grad_atol(want[1]))
    np.testing.assert_allclose(cut[2], want[2], rtol=1e-4, atol=0)
    assert np.abs(want[1]).sum() > 0 and np.abs(want[2]).sum() > 0


@pytest.mark.parametrize("n,n_cols,z_window", [(16, 8, True),
                                               (32, 8, False)])
def test_slab_cut_and_uncut_emulations_match_pallas_interpret(
        monkeypatch, n, n_cols, z_window):
    monkeypatch.setenv("SQTPU_PALLAS_INTERPRET", "1")
    p, img = _batch(160 + n + int(z_window))
    full = _slab(img, n)
    g = np.random.default_rng(n).uniform(0.5, 1.5, p.shape[0]).astype(
        np.float32)
    for x0 in range(0, n, n_cols):
        cols = np.ascontiguousarray(full[:, :, x0:x0 + n_cols])
        want = _jax_slab(cols, p, x0, n, z_window, g)
        cut = _port_slab(K.implicit_sums_slab_emulated, cols, p, x0, n,
                         z_window, g)
        uncut = _port_slab(_uncut_slab, cols, p, x0, n, z_window, g)
        for a, b in zip(cut, uncut):
            np.testing.assert_array_equal(a, b, err_msg=f"x0={x0}")
        np.testing.assert_allclose(cut[0], want[0], rtol=1e-5, atol=0,
                                   err_msg=f"x0={x0}")
        np.testing.assert_allclose(cut[1], want[1], rtol=5e-3,
                                   atol=grad_atol(want[1]),
                                   err_msg=f"x0={x0}")
        np.testing.assert_allclose(cut[2], want[2], rtol=1e-4, atol=0,
                                   err_msg=f"x0={x0}")


def _extreme_plane(seed: int, n: int, n_cols: int, x0: int, z_window: bool):
    """The clamp's extremes and shapes cut by the cube (the true rows of
    ``_extreme_batch``) and noisy predictions near them (its pred rows),
    packed for a slab of ``n_cols`` columns from x0, with noise images."""
    true, pred = _extreme_batch(seed)
    p = torch.tensor(np.concatenate([true, pred]))
    img = torch.tensor(np.random.default_rng(seed).uniform(
        0.05, 0.9, (p.shape[0], 48, 48)).astype(np.float32))
    plane = K.image_plane(img, n).reshape(-1, n, n)
    img_xy = plane[:, x0:x0 + n_cols].reshape(p.shape[0], -1).contiguous()
    return img_xy, K.pack_params(p, n, z_window, x0=x0)


@pytest.mark.parametrize("n,n_cols,x0,z_window,sharp", [
    (16, 16, 0, True, SHARP), (32, 32, 0, False, SHARP),
    (32, 32, 0, True, 30.0), (32, 10, 0, True, SHARP),
    (32, 10, 11, False, SHARP), (32, 10, 22, True, SHARP),
    (16, 10, 6, True, 60.0)])
def test_cull_skips_only_exact_zeros(n, n_cols, x0, z_window, sharp):
    img_xy, par = _extreme_plane(95 + n + x0, n, n_cols, x0, z_window)
    assert bool(cull_sound(par).all())
    cut = K._rays(par, n, n_cols, TAU, sharp, True)
    full = K._rays(par, n, n_cols, TAU, sharp, False)
    skipped = 0
    for j in range(n):
        in_window = (full.a <= j) & (j <= full.b)
        swept = (cut.a <= j) & (j <= cut.b)
        assert not bool((swept & ~in_window).any())
        occ = _occupancy(K._field_at(cut, K._zval(j, cut.sw.inv, par))["F"],
                         sharp)
        assert bool((occ[in_window & ~swept] == 0.0).all()), f"plane {j}"
        skipped += int((in_window & ~swept).sum())
    window = K.window_points(par, n, n_cols)
    assert K.cull_points(par, n, n_cols, TAU, sharp) == window - skipped
    assert skipped > 0.3 * window
    g = torch.linspace(0.5, 1.5, par.shape[0])
    with_cull = K.emulate_fwd(img_xy, par, n, n_cols, TAU, sharp)
    without = K.emulate_fwd(img_xy, par, n, n_cols, TAU, sharp, cull=False)
    with_cull += K.emulate_bwd(img_xy, par, with_cull[1], g, n, n_cols, TAU,
                               sharp)
    without += K.emulate_bwd(img_xy, par, without[1], g, n, n_cols, TAU,
                             sharp, cull=False)
    for a, b in zip(with_cull, without):  # sums, Tacc, dpar, dimg
        assert torch.equal(a, b)
    assert float(with_cull[2].abs().max()) > 0


def test_rows_the_proof_does_not_cover_sweep_fully():
    """A row outside the proof's range (an exponent above 1, a size below
    0.05, a non-finite value), a sharpness or τ outside it, and a pixel
    whose cotangent or Tacc is not finite sweep the whole window."""
    p, _ = _batch(96, 5)
    par = K.pack_params(torch.tensor(p), 16)
    par[0, 3] = 1.5
    par[1, 0] = 0.04
    par[2, 9] = float("nan")
    assert cull_sound(par).tolist() == [False, False, False, True, True]
    full = K._rays(par, 16, 16, TAU, SHARP, False)
    cut = K._rays(par, 16, 16, TAU, SHARP, True)
    assert torch.equal(cut.a[:3], full.a[:3])
    assert torch.equal(cut.b[:3], full.b[:3])
    assert int((cut.b[3:] - cut.a[3:]).sum()) < int(
        (full.b[3:] - full.a[3:]).sum())
    for tau, sharp in ((TAU, math.inf), (TAU, 0.0), (TAU, -5.0),
                       (math.nan, SHARP), (math.inf, SHARP), (-1.0, SHARP)):
        r = K._rays(par, 16, 16, tau, sharp, True)
        assert torch.equal(r.a, full.a) and torch.equal(r.b, full.b)
    finite = torch.ones_like(full.a, dtype=torch.bool)
    finite[3, :40] = False
    r = K._rays(par, 16, 16, TAU, SHARP, True, finite)
    assert torch.equal(r.a[3, :40], full.a[3, :40])
    assert torch.equal(r.b[3, :40], full.b[3, :40])
    assert torch.equal(r.a[4], cut.a[4]) and torch.equal(r.b[4], cut.b[4])


def _same_nans(a: torch.Tensor, b: torch.Tensor) -> None:
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_nan_cotangent_or_image_pixel_keeps_its_nans():
    """A NaN cotangent (sample 0) or image pixel (sample 1, a pixel off the
    shape, which the cull would skip whole) makes NaN gradients through
    NaN·0 on the uncut sweep; the cull keeps them."""
    n = 16
    p, img = _batch(97, 3)
    par = K.pack_params(torch.tensor(p), n)
    img_xy = K.image_plane(torch.tensor(img), n)
    img_xy[1, 0] = float("nan")
    r = K._rays(par, n, n, TAU, SHARP, True)
    assert int(r.b[1, 0]) < int(r.a[1, 0])  # nothing swept by a live pixel
    g = torch.tensor([float("nan"), 1.0, 0.5])
    out = {}
    for cull in (True, False):
        sums, tacc = K.emulate_fwd(img_xy, par, n, n, TAU, SHARP, cull=cull)
        out[cull] = (sums, tacc) + K.emulate_bwd(img_xy, par, tacc, g, n, n,
                                                 TAU, SHARP, cull=cull)
    for a, b in zip(out[True], out[False]):
        _same_nans(a, b)
    sums, tacc, dpar, dimg = out[True]
    assert torch.isnan(sums).tolist() == [False, True, False]
    assert bool(torch.isfinite(tacc).all())
    assert torch.isnan(dpar[:, :K.N_PAR]).all(dim=-1).tolist() == [
        True, True, False]
    assert bool(torch.isnan(dimg[0]).all())
    assert int(torch.isnan(dimg[1:]).sum()) == 1


# ---- the sources -----------------------------------------------------------

def _src(name: str) -> str:
    return open(os.path.join(_build.CSRC_DIR, name)).read()


def test_redesigned_implicit_sources():
    src, header = _src("implicit.cu"), _src("sq_field.cuh")
    k1 = src[src.index("implicit_fwd_kernel("):src.index(
        "implicit_bwd_kernel(")]
    k2 = src[src.index("implicit_bwd_kernel("):]
    assert "field_terms_lin(" in src and "field_terms(" not in src
    for kernel in (k1, k2):
        assert "field_at(" in kernel and "sweep_range(" in kernel
    assert "sep_grad_step(" in k2 and "sep_finish(" in k2
    # the skip of gF = ±0 only where the row's proof makes it exact
    assert "if (gF != 0.0f || s.bb == 0.0f) sep_grad_step(" in k2
    assert "box_planes(" in src and "cull_sound(" in src
    # the cull is on unless a build turns it off (the uncut A/B build)
    assert "#define SQTPU_IMPLICIT_CULL 1" in src
    assert "const bool ok = SQTPU_IMPLICIT_CULL && " in src
    assert src.count("__launch_bounds__(kThreads, kMinBlocks)") == 2
    assert "int sqtpu_implicit_blocks(" in src
    for text in (src, header):
        assert "frame_grad_step(" not in text
        for banned in ("atomicAdd", "__expf", "__logf"):
            assert banned not in text
