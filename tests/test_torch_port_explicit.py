"""The explicit-loss kernels K4/K5: their emulation against the JAX
package's Pallas kernels, the wrapper's torch side, dispatch and checks,
and the shared CUDA sources. The CUDA kernels themselves are tested on the
card by tests/test_torch_port_gpu.py.

On the CPU the emulation of the kernels' algorithm
(``sqtpu_torch.ops.kernels.explicit.emulate_fwd/emulate_fused``) is held
against ``sqtpu.ops.kernels.explicit.explicit_loss_pallas`` run by Pallas
in interpret mode, with the JAX package's own kernel tolerances
(tests/test_pallas_explicit.py:46-49, 86-92): value relative 1e-5 on the
full sweep and 1e-3 windowed; the 12-param gradient rtol 5e-3 with atol
1e-6 on the full sweep and 5e-4 windowed. In fp64 the emulation equals
autograd of the plain loss to 1e-10 (full sweep: the same points, the same
arithmetic).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu.ops.kernels import explicit as jexplicit
from sqtpu.ops.kernels import implicit as jimplicit
from sqtpu_torch.ops import losses as tlosses
from sqtpu_torch.ops.kernels import _build, explicit_loss_auto
from sqtpu_torch.ops.kernels import launch_counts, reset_launches
from sqtpu_torch.ops.kernels import explicit as KE

from test_torch_port_ops import _few_torch_threads, random_params  # noqa: F401


def _batch(seed: int, b: int = 2, dtype=np.float32):
    """(B, 12) true params of the reference eval distribution and a
    prediction near them, numpy-made."""
    true = random_params(seed, b, np.float64)
    pred = true + 0.02 * np.random.default_rng(seed + 1).normal(
        size=true.shape)
    return true.astype(dtype), pred.astype(dtype)


def _torch_value_and_grad(fn, true, pred, n, **kw):
    tp = torch.tensor(pred, requires_grad=True)
    loss = fn(torch.tensor(true), tp, n, **kw)
    loss.backward()
    return loss.item(), tp.grad.numpy()


def _jax_value_and_grad(true, pred, n, **kw):
    v, g = jax.value_and_grad(
        lambda pp: jexplicit.explicit_loss_pallas(jnp.asarray(true), pp, n,
                                                  **kw))(jnp.asarray(pred))
    return float(v), np.asarray(g)


@pytest.mark.parametrize("n,z_window,sharp", [
    (8, False, 5.0), (8, True, 5.0), (8, False, 20.0), (8, True, 20.0),
    (16, False, 5.0), (16, True, 5.0), (16, False, 20.0), (16, True, 20.0)])
def test_emulation_matches_pallas_interpret(monkeypatch, n, z_window, sharp):
    monkeypatch.setenv("SQTPU_PALLAS_INTERPRET", "1")
    true, pred = _batch(60 + n + int(z_window) + int(sharp))
    want = _jax_value_and_grad(true, pred, n, z_window=z_window, sharp=sharp)
    got = _torch_value_and_grad(KE.explicit_loss_emulated, true, pred, n,
                                z_window=z_window, sharp=sharp)
    rel, atol = (1e-3, 5e-4) if z_window else (1e-5, 1e-6)
    assert got[0] == pytest.approx(want[0], rel=rel)
    np.testing.assert_allclose(got[1], want[1], rtol=5e-3, atol=atol)
    assert np.abs(want[1]).max() > 0
    if not z_window:  # both fp32 results against the plain fp64 loss
        exact = _torch_value_and_grad(
            lambda t, p, n, **kw: tlosses.explicit_loss(t, p, n, sharp=sharp),
            true.astype(np.float64), pred.astype(np.float64), n)
        for fp32 in (got, want):
            assert fp32[0] == pytest.approx(exact[0], rel=1e-5)
            np.testing.assert_allclose(fp32[1], exact[1], rtol=5e-3,
                                       atol=1e-6)


@pytest.mark.parametrize("z_window", [False, True])
def test_per_sample_values_match_pallas(monkeypatch, z_window):
    monkeypatch.setenv("SQTPU_PALLAS_INTERPRET", "1")
    true, pred = _batch(70, 4)
    want = np.asarray(jexplicit.explicit_loss_pallas(
        jnp.asarray(true), jnp.asarray(pred), 16, reduce=False,
        z_window=z_window))
    with torch.no_grad():
        got = KE.explicit_loss_emulated(torch.tensor(true),
                                        torch.tensor(pred), 16, reduce=False,
                                        z_window=z_window).numpy()
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=1e-3 if z_window else 1e-5)


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("sharp", [5.0, 20.0])
def test_fp64_emulation_equals_autograd_of_the_plain_loss(n, sharp):
    true, pred = _batch(71 + n, 3, np.float64)
    got = _torch_value_and_grad(KE.explicit_loss_emulated, true, pred, n,
                                z_window=False, sharp=sharp)
    want = _torch_value_and_grad(
        lambda t, p, n: tlosses.explicit_loss(t, p, n, sharp=sharp),
        true, pred, n)
    assert got[0] == pytest.approx(want[0], rel=1e-10)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-10,
                               atol=1e-10 * np.abs(want[1]).max())


def test_true_side_gets_no_gradient():
    true, pred = _batch(72)
    tt = torch.tensor(true, requires_grad=True)
    tp = torch.tensor(pred, requires_grad=True)
    KE.explicit_loss_emulated(tt, tp, 8).backward()
    assert tt.grad is None or not tt.grad.any()
    assert tp.grad.abs().max() > 0


def test_clamped_out_params_get_zero_gradient():
    true, pred = _batch(73)
    pred[0, 0] = 1.5   # a1 above the clamp's maximum
    pred[1, 3] = 0.05  # e1 below the clamp's minimum
    _, g = _torch_value_and_grad(KE.explicit_loss_emulated, true, pred, 16)
    assert g[0, 0] == 0.0 and g[1, 3] == 0.0


def test_windowed_per_sample_values_ignore_batch_order():
    true, pred = _batch(74, 4)
    perm = np.array([2, 0, 3, 1])
    with torch.no_grad():
        fwd = KE.explicit_loss_emulated(torch.tensor(true), torch.tensor(pred),
                                        16, reduce=False)
        shuf = KE.explicit_loss_emulated(torch.tensor(true[perm]),
                                         torch.tensor(pred[perm]), 16,
                                         reduce=False)
    np.testing.assert_allclose(shuf.numpy(), fwd.numpy()[perm], rtol=1e-6)


# ---- the wrapper's torch side against the JAX wrapper's --------------------

@pytest.mark.parametrize("sharp", [5.0, 20.0])
def test_window_and_packing_match_jax(sharp):
    true, pred = _batch(75, 16)
    pred[0, 0], pred[1, 3] = 1.5, 0.05  # outside the clamp box
    margin = KE.default_margin(sharp)
    assert margin == max(jexplicit.Z_MARGIN * jexplicit.SHARP / sharp, 0.02)
    for n in (16, 128):
        jlo, jhi = jexplicit.z_window_indices(jnp.asarray(true),
                                              jnp.asarray(pred), n, margin)
        tlo, thi = KE.z_window_indices(torch.from_numpy(true),
                                       torch.from_numpy(pred), n, margin)
        np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
        assert (thi >= tlo).all() and thi.max() <= n and tlo.min() >= 0
        par_t, par_p = KE.pack_params(torch.from_numpy(true),
                                      torch.from_numpy(pred), n, True, margin)
        np.testing.assert_allclose(par_t.numpy(), np.asarray(
            jimplicit._frame_params(jnp.asarray(true))), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(par_p[:, :17].numpy(), np.asarray(
            jimplicit._frame_params(jnp.asarray(pred)))[:, :17], rtol=1e-6,
            atol=1e-7)
        assert torch.equal(par_p[:, 17], tlo) and torch.equal(par_p[:, 18], thi)
        assert not par_p[:, 19:].any() and not par_t[:, 17:].any()
    _, full = KE.pack_params(torch.from_numpy(true), torch.from_numpy(pred),
                             32, False)
    assert (full[:, 17] == 0).all() and (full[:, 18] == 32).all()
    assert KE.window_points(full, 32) == 16 * 33 ** 3


def test_loss_only_sweep_where_nothing_is_differentiated():
    """The wrapper takes K5's path (``fwd``) unless grad mode is on and
    pred needs a gradient; then K4's (``fused``)."""
    calls = []

    def record(name, impl):
        def fn(*args):
            calls.append(name)
            return impl(*args)
        return fn

    impl = KE._Impl(record("fwd", KE.emulate_fwd),
                    record("fused", KE.emulate_fused))
    true, pred = (torch.tensor(x) for x in _batch(76))
    runs = {}
    with torch.no_grad():
        runs["no_grad"] = KE._sweep_loss(impl, true,
                                         pred.clone().requires_grad_(), 8,
                                         True, True, None, 5.0)
    runs["constant"] = KE._sweep_loss(impl, true, pred, 8, True, True, None,
                                      5.0)
    p = pred.clone().requires_grad_()
    runs["grad"] = KE._sweep_loss(impl, true, p, 8, True, True, None, 5.0)
    runs["grad"].backward()
    assert calls == ["fwd", "fwd", "fused"]
    assert runs["no_grad"].item() == runs["constant"].item()
    # K5 is K4's sweep without the gradient: the same points, the same
    # arithmetic in the same order, so the same sum to the bit.
    assert runs["grad"].item() == runs["constant"].item()
    assert p.grad.abs().max() > 0


# ---- dispatch and the kernels' checks ------------------------------------

def test_cpu_tensor_goes_to_the_plain_loss():
    true, pred = (torch.tensor(x) for x in _batch(77))
    reset_launches()
    got = explicit_loss_auto(true, pred, 8, sharp=20.0)
    want = tlosses.explicit_loss(true, pred, 8, sharp=20.0)
    assert torch.equal(got, want)
    per = explicit_loss_auto(true, pred, 8, reduce=False, z_window=False)
    assert torch.equal(per, tlosses.explicit_loss(true, pred, 8, False))
    assert not any(launch_counts().values())


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "cpu", "size",
                                 "batch"])
def test_kernels_reject_bad_operands(bad):
    """The launchers' checks raise before any library is loaded: here on
    the CPU, where there is none."""
    true, pred = (torch.tensor(x) for x in _batch(78))
    par_t, par_p = KE.pack_params(true, pred, 8)
    n, err = 8, ValueError
    if bad == "dtype":
        par_p, err = par_p.double(), TypeError
    elif bad == "shape":
        par_t = par_t[:, :-1]
    elif bad == "strided":
        par_t = torch.zeros((2, 48))[:, ::2]
    elif bad == "size":
        n = 1
    elif bad == "batch":
        par_t, par_p = par_t[:0], par_p[:0]
    reset_launches()
    with pytest.raises(err):
        KE.cuda_fwd(par_t, par_p, n, 5.0)
    with pytest.raises(err):
        KE.cuda_fused(par_t, par_p, n, 5.0)
    assert not any(launch_counts().values())


def test_wrapper_rejects_bad_input():
    true, pred = (torch.tensor(x) for x in _batch(79))
    with pytest.raises(ValueError):
        explicit_loss_auto(true[:, :11], pred[:, :11], 8)
    with pytest.raises(ValueError):
        explicit_loss_auto(true[:1], pred, 8)
    with pytest.raises(ValueError):
        explicit_loss_auto(true, pred, 1)
    with pytest.raises(ValueError):
        explicit_loss_auto(true.to("meta"), pred.to("meta"), 8)


# ---- the CUDA sources ----------------------------------------------------

def _src(name: str) -> str:
    return open(os.path.join(_build.CSRC_DIR, name)).read()


def test_source_is_plain_c_and_names_the_tpu_kernels():
    src = _src("explicit.cu")
    assert 'extern "C"' in src and "torch/extension.h" not in src
    for fn in ("int sqtpu_explicit_fwd(", "int sqtpu_explicit_fused(",
               "int sqtpu_explicit_blocks("):
        assert fn in src
    assert "sqtpu/ops/kernels/explicit.py::_fused_kernel" in src
    assert "sqtpu/ops/kernels/explicit.py::_fwd_kernel" in src
    assert "atomicAdd" not in src  # deterministic reductions


def test_field_chain_is_shared_not_copied():
    header = _src("sq_field.cuh")
    for name in ("explicit.cu", "implicit.cu"):
        src = _src(name)
        assert '#include "sq_field.cuh"' in src
        for fn in ("field_terms_lin(const Recip&", "sep_grad_step(SepAcc&",
                   "box_planes(const Recip&", "bool cull_sound(",
                   "sum_partials(const float*", "struct Recip"):
            assert fn not in src and fn in header


def test_library_path_follows_the_included_header(tmp_path, monkeypatch):
    assert _build.source_files("explicit") == [
        os.path.join(_build.CSRC_DIR, f) for f in ("explicit.cu",
                                                   "sq_field.cuh")]
    before = {n: _build.library_path(n) for n in ("explicit", "implicit",
                                                   "hardrender")}
    fake = tmp_path / "csrc"
    fake.mkdir()
    for f in os.listdir(_build.CSRC_DIR):
        (fake / f).write_text(_src(f))
    monkeypatch.setattr(_build, "CSRC_DIR", str(fake))
    assert {n: _build.library_path(n) for n in before} == before
    (fake / "sq_field.cuh").write_text(_src("sq_field.cuh") + "\n// edited\n")
    after = {n: _build.library_path(n) for n in before}
    assert after["explicit"] != before["explicit"]
    assert after["implicit"] != before["implicit"]
    assert after["hardrender"] == before["hardrender"]
