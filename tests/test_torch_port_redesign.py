"""The redesigned K4 and K5 (explicit loss: fused value and gradient, and
the value alone) and K3 (hard ray-cast renderer): their algorithms, proven
on the CPU through the torch emulation of each. The CUDA kernels are held
against these emulations on the card by tests/test_torch_port_gpu.py and
chip_smoke.py.

* K4's emulation (per-sample reciprocals, body coordinates linear in z,
  11 running sums a column, the exact-zero cull) against the JAX package's
  Pallas ``_fused_kernel`` in interpret mode, with the tolerances of
  tests/test_torch_port_explicit.py (value relative 1e-5 on the full
  sweep, 1e-3 windowed; gradient rtol 5e-3 with atol 1e-6 full, 5e-4
  windowed).
* The cull is sound: on params at the clamp's extremes (e = 0.1 and 1,
  a = 0.05, shapes on the faces and corners of the unit cube), every point
  it skips has both occupancies exactly 0.0 in float32, and K4's and K5's
  sweeps with the cull equal their sweeps without it bit for bit. K5 is
  K4's body without the gradient: its sums are K4's, bit for bit.
* K3's interval sweep equals the full sweep bit for bit in float32, over
  a few hundred shapes at 64² (the clamp's extremes, shapes cut by the
  image border, exponents outside the range the kernel's proof covers),
  and equals the plain renderer on the recorded truths of
  ``runs/eval_c4c3`` within the renderer's bound: fewer than 0.1% of
  pixels off by more than one gray level.
"""

import os

import numpy as np
import pytest
import torch

from sqtpu_torch.ops.kernels import _build
from sqtpu_torch.ops.kernels import explicit as KE
from sqtpu_torch.ops.kernels import hardrender as H
from sqtpu_torch.ops.kernels.sq_field import _sweep_setup, _zval
from sqtpu_torch.ops.render import render_depth_hard_batch

from test_torch_port_explicit import (
    _batch, _jax_value_and_grad, _torch_value_and_grad,
)
from test_torch_port_ops import (  # noqa: F401
    _few_torch_threads, levels_off, random_params,
)

TRUTHS = os.path.join(os.path.dirname(_build.PKG_DIR), "runs", "eval_c4c3",
                      "accs.npz")


# ---- K4 ------------------------------------------------------------------

@pytest.mark.parametrize("n,z_window,sharp", [
    (16, False, 5.0), (16, True, 5.0), (16, False, 20.0), (16, True, 20.0),
    (32, False, 5.0), (32, True, 5.0), (32, False, 20.0), (32, True, 20.0)])
def test_redesigned_emulation_matches_pallas_interpret(monkeypatch, n,
                                                       z_window, sharp):
    monkeypatch.setenv("SQTPU_PALLAS_INTERPRET", "1")
    true, pred = _batch(90 + n + int(z_window) + int(sharp))
    want = _jax_value_and_grad(true, pred, n, z_window=z_window, sharp=sharp)
    got = _torch_value_and_grad(KE.explicit_loss_emulated, true, pred, n,
                                z_window=z_window, sharp=sharp)
    rel, atol = (1e-3, 5e-4) if z_window else (1e-5, 1e-6)
    assert got[0] == pytest.approx(want[0], rel=rel)
    np.testing.assert_allclose(got[1], want[1], rtol=5e-3, atol=atol)
    assert np.abs(want[1]).max() > 0


def _extreme_batch(seed: int):
    """(24, 12) true params at the clamp's extremes and on the edges of the
    unit cube, and a prediction near them (its quaternions not unit)."""
    rng = np.random.default_rng(seed)
    true = random_params(seed, 24)
    true[0::4, 0:3] = 0.05                      # the smallest size
    true[1::4, 3:5] = 0.1                       # the boxiest shape
    true[2::4, 3:5] = 1.0                       # the roundest
    true[3::4, 3:5] = (0.1, 1.0)
    true[0:8, 5:8] = [[i >> 2 & 1, i >> 1 & 1, i & 1] for i in range(8)]
    true[8:16, 5:8] = rng.integers(0, 2, (8, 3)) * rng.uniform(0.8, 1.0,
                                                               (8, 1))
    true[16:, 0:3] = rng.uniform(0.3, 1.0, (8, 3))   # large, cut by the cube
    pred = true + 0.03 * rng.normal(size=true.shape)
    return true.astype(np.float32), pred.astype(np.float32)


CULL_SETTINGS = [(16, 20.0, True), (32, 20.0, True), (32, 20.0, False),
                 (32, 5.0, True), (16, 60.0, False)]


@pytest.mark.parametrize("n,sharp,z_window,kernel", [
    pytest.param(*c, "K4", id="-".join(map(str, c))) for c in CULL_SETTINGS
] + [pytest.param(*c, "K5", id="K5-" + "-".join(map(str, c)))
     for c in CULL_SETTINGS])
def test_k4_cull_skips_only_exact_zeros(n, sharp, z_window, kernel):
    """K4's and K5's sweeps with the cull equal their uncut sweeps bit for
    bit; K5's sums are K4's."""
    true, pred = (torch.tensor(x) for x in _extreme_batch(91 + n))
    par_t, par_p = KE.pack_params(true, pred, n, z_window,
                                  KE.default_margin(sharp))
    assert bool(KE.cull_sound(par_t).all())
    assert int(KE.cull_sound(par_p).sum()) >= 20
    col = KE._columns(par_t, par_p, n, sharp, cull=True)
    sw = _sweep_setup(par_p, n + 1, n + 1)
    culled_points = 0
    for j in range(int(sw.lo.min()), int(sw.hi.max()) + 1):
        culled = ((sw.lo <= j) & (j <= sw.hi)
                  & ~((col.j0 <= j) & (j <= col.j1)))
        z = _zval(j, sw.inv, par_p)
        for k, origin in ((col.kt, col.origin_t), (col.kp, col.origin_p)):
            occ = KE._occupancy(KE._field_terms_lin(
                k, *[o + c * z for o, c in zip(origin, k.c)])["F"], sharp)
            assert bool((occ[culled] == 0.0).all())
        culled_points += int(culled.sum())
    window = KE.window_points(par_p, n)
    assert KE.cull_points(par_t, par_p, n, sharp) == window - culled_points
    if sharp >= 20.0:
        assert culled_points > 0.1 * window
    fn = KE.emulate_fused if kernel == "K4" else KE.emulate_fwd
    with_cull = fn(par_t, par_p, n, sharp)
    without = fn(par_t, par_p, n, sharp, cull=False)
    if kernel == "K5":
        assert torch.equal(with_cull, KE.emulate_fused(par_t, par_p, n,
                                                       sharp)[0])
        with_cull, without = (with_cull,), (without,)
    for a, b in zip(with_cull, without):
        assert torch.equal(a, b)


def test_k4_cull_off_where_the_rows_prove_nothing():
    """A row outside the proof's range (an exponent above 1, a size below
    0.05, a non-finite value) sweeps its whole window."""
    true, pred = (torch.tensor(x) for x in _batch(92, 4))
    par_t, par_p = KE.pack_params(true, pred, 16)
    assert bool(KE.cull_sound(par_p).all())
    par_p[0, 3] = 1.5
    par_p[1, 0] = 0.04
    par_p[2, 9] = float("nan")
    assert KE.cull_sound(par_p).tolist() == [False, False, False, True]
    col = KE._columns(par_t, par_p, 16, 20.0, cull=True)
    full = KE._columns(par_t, par_p, 16, 20.0, cull=False)
    assert torch.equal(col.j0[:3], full.j0[:3])
    assert torch.equal(col.j1[:3], full.j1[:3])
    assert int((col.j1[3] - col.j0[3]).sum()) < int(
        (full.j1[3] - full.j0[3]).sum())


# ---- K3 ------------------------------------------------------------------

def _render_batch(seed: int, b: int = 300) -> torch.Tensor:
    """(B, 12) shapes for the renderer: the eval distribution, the clamp's
    extremes, large shapes cut by the image border, and exponents outside
    the range the kernel's interval covers (which then sweep fully)."""
    rng = np.random.default_rng(seed)
    p = random_params(seed, b)
    p[0:60, 0:3] = rng.uniform(0.3, 1.0, (60, 3))          # cut by the border
    p[60:120, 5:8] = rng.uniform(-0.2, 1.2, (60, 3))       # off-centre
    p[120:160, 0:3] = 0.05
    p[160:200, 3:5] = rng.choice([0.1, 1.0], (40, 2))
    p[200:210, 3:5] = rng.uniform(0.004, 0.02, (10, 2))    # 1/e up to 250
    p[210:220, 3] = rng.uniform(120.0, 200.0, 10)          # 1/e1 < 0.01
    p[220:230, 4] = rng.uniform(120.0, 200.0, 10)
    return torch.tensor(p.astype(np.float32))


@pytest.mark.parametrize("n_sweep,n_bisect", [(64, 16), (48, 12)])
def test_k3_interval_sweep_equals_full_sweep(n_sweep, n_bisect):
    par = H.pack_frames(_render_batch(93 + n_sweep), n_sweep)
    got, tests = H.emulate_hardrender(par, 64, n_sweep, n_bisect)
    want, tests_full = H.emulate_hardrender(par, 64, n_sweep, n_bisect,
                                            interval=False)
    assert torch.equal(got, want)
    assert (got > 0).float().mean() > 0.05
    assert bool((tests <= tests_full).all())
    assert int(tests.sum()) < 0.3 * int(tests_full.sum())
    # exponents above 100 take the full sweep: their ranges are [0, n)
    j0, j1 = H.slab_range(par, 64, n_sweep)
    assert bool((j0[210:230] == 0).all() and (j1[210:230] == n_sweep - 1)
                .all())
    unq, _ = H.emulate_hardrender(par, 64, n_sweep, n_bisect, False)
    unq_full, _ = H.emulate_hardrender(par, 64, n_sweep, n_bisect, False,
                                       interval=False)
    assert torch.equal(unq, unq_full)


@pytest.mark.parametrize("n_sweep,n_bisect", [(64, 16), (48, 12)])
def test_k3_emulation_matches_plain_on_recorded_truths(n_sweep, n_bisect):
    with np.load(TRUTHS) as d:
        p = torch.tensor(d["true_params"][:48].astype(np.float32))
    got, _ = H.emulate_hardrender(H.pack_frames(p, n_sweep), 128, n_sweep,
                                  n_bisect)
    want = render_depth_hard_batch(p, 128, n_bisect=n_bisect, quantize=True,
                                   n_sweep=n_sweep)
    assert got.shape == want.shape == (48, 128, 128)
    assert levels_off(got.numpy(), want.numpy()) < 1e-3
    assert float(got.max()) > 0.3


def test_k3_inside_tests_count_the_full_sweep_as_before():
    """The full sweep's count is the first port's (a pixel that first hits
    at slab j makes j + 1 + n_bisect tests, a miss n_sweep), the bound's
    yardstick; the interval's count is far below it."""
    par = H.pack_frames(_render_batch(94)[60:68], 48)
    depth, full = H.emulate_hardrender(par, 32, 48, 12, interval=False)
    misses = int((depth == 0).sum())
    assert int(full.sum()) >= misses * 48
    assert int(H.emulate_hardrender(par, 32, 48, 12)[1].sum()) < int(
        full.sum())


# ---- the sources -----------------------------------------------------------

def _src(name: str) -> str:
    return open(os.path.join(_build.CSRC_DIR, name)).read()


def test_redesigned_sources():
    explicit, header, render = (_src(f) for f in (
        "explicit.cu", "sq_field.cuh", "hardrender.cu"))
    k4 = explicit[explicit.index("void explicit_body("):]  # K4's body
    assert "int sqtpu_explicit_fused_blocks(" in explicit
    assert "__launch_bounds__(kThreads, kFusedMinBlocks)" in explicit
    assert "sep_grad_step(" in k4 and "field_terms_lin(" in k4
    assert "frame_grad_step(" not in k4
    for fn in ("Recip make_recip(", "Terms field_terms_lin(",
               "void sep_grad_step(", "void sep_finish("):
        assert fn in header
    assert "slab_range(" in render and "sqtpu_hardrender(" in render
    for src in (explicit, header, render):
        assert "atomicAdd" not in src and "__expf" not in src


def test_k5_is_k4s_body_without_the_gradient():
    """K4 and K5 instantiate one templated body; K5 no longer divides at
    every point (no ``field_terms(``), and the cull can be built out."""
    explicit, header = _src("explicit.cu"), _src("sq_field.cuh")
    body = explicit[explicit.index("void explicit_body("):
                    explicit.index("explicit_fused_kernel(")]
    assert "template <bool kGrad>" in explicit
    assert "field_terms_lin(" in body and "if constexpr (kGrad)" in body
    assert "sep_grad_step(" in body and "box_planes(" in body
    entries = {}
    for name in ("explicit_fused_kernel(", "explicit_fwd_kernel("):
        i = explicit.index(name)
        entries[name] = explicit[i:explicit.index("\n}\n", i)]
        assert "__global__" in explicit[i - 80:i]
    assert "explicit_body<true>(" in entries["explicit_fused_kernel("]
    assert "explicit_body<false>(" in entries["explicit_fwd_kernel("]
    assert "field_terms(" not in explicit and "field_terms(" not in header
    for gone in ("Column column(", "blocks_per_sample(", "load_frame("):
        assert gone not in explicit and gone not in header
    assert "#define SQTPU_EXPLICIT_CULL 1" in explicit
    assert "SQTPU_EXPLICIT_CULL && sharp > 0.0f" in body
    assert "return column_blocks(n);" in explicit.split(
        "int sqtpu_explicit_blocks(")[1].split("\n")[0]
