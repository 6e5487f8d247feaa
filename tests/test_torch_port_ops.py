"""Parity of the port's geometry, renderer, gauge and metrics with the JAX
package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its ``sqtpu_torch`` counterpart. Tolerances: fp64 rtol 1e-10 for the
closed-form geometry (both sides do the same arithmetic; only libm
rounding differs); the renderer's own bound for depth maps, fewer than
0.1% of pixels off by more than one gray level
(``sqtpu/ops/geometry.py:400-402``), since a grazing ray can flip between
slabs when the last bit of a coordinate differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu.ops import geometry as jgeom
from sqtpu.ops import losses as jlosses
from sqtpu.ops import metrics as jmetrics
from sqtpu.ops import quaternion as jquat
from sqtpu.ops import render as jrender
from sqtpu_torch.data.synthetic import sample_params
from sqtpu_torch.ops import geometry as tgeom
from sqtpu_torch.ops import losses as tlosses
from sqtpu_torch.ops import metrics as tmetrics
from sqtpu_torch.ops import quaternion as tquat
from sqtpu_torch.ops import render as trender


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes on one host: a torch
    pool of one thread per core in each of them oversubscribes the cores
    and every worker slows down many times over. Two threads in each port
    test module (the others import this fixture)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


RTOL = 1e-10


def random_params(seed: int, b: int, dtype=np.float64) -> np.ndarray:
    """(B, 12) params from the reference eval distribution, numpy-made."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([
        rng.uniform(25 / 255, 75 / 255, (b, 3)),
        rng.uniform(0.1, 1.0, (b, 2)),
        (128.0 + rng.uniform(-40, 40, (b, 3))) / 255.0,
        q,
    ], axis=-1).astype(dtype)


def levels_off(a: np.ndarray, b: np.ndarray) -> float:
    """Fraction of pixels whose gray levels differ by more than one."""
    return float((np.abs(np.rint(a * 255) - np.rint(b * 255)) > 1).mean())


def close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def p64():
    return random_params(0, 6)


# ---- quaternion ------------------------------------------------------

@pytest.mark.parametrize("fn", ["multiply", "conjugate", "to_matrix",
                                "to_magnitude"])
def test_quaternion_matches_jax(fn):
    rng = np.random.default_rng(1)
    q1, q2 = rng.normal(size=(2, 5, 4))
    tf, jf = getattr(tquat, fn), getattr(jquat, fn)
    if fn == "multiply":
        got = tf(torch.from_numpy(q1), torch.from_numpy(q2))
        want = jf(jnp.asarray(q1), jnp.asarray(q2))
    else:
        got, want = tf(torch.from_numpy(q1)), jf(jnp.asarray(q1))
    close(got, want)


def test_random_uniform_is_unit_and_seeded():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    q = tquat.random_uniform((1000,), g1, torch.float64)
    assert q.shape == (1000, 4)
    np.testing.assert_allclose(q.norm(dim=-1).numpy(), 1.0, rtol=1e-12)
    assert torch.equal(q, tquat.random_uniform((1000,), g2, torch.float64))
    # Shoemake-uniform: each component has mean 0 and variance 1/4
    assert float(q.mean(dim=0).abs().max()) < 0.05
    np.testing.assert_allclose(q.var(dim=0).numpy(), 0.25, atol=0.03)


# ---- geometry --------------------------------------------------------

def test_split_and_clamp_params(p64):
    p = p64.copy()
    p[0, 0], p[1, 3], p[2, 5] = 2.0, 0.01, -0.2
    got = tgeom.clamp_params(torch.from_numpy(p))
    close(got, jgeom.clamp_params(jnp.asarray(p)))
    for tpart, jpart in zip(tgeom.split_params(torch.from_numpy(p)),
                            jgeom.split_params(jnp.asarray(p))):
        close(tpart, jpart)


@pytest.mark.parametrize("kind", ["explicit", "implicit", "iou"])
@pytest.mark.parametrize("n", [17, 32, 64, 128])
def test_make_axis_is_bit_exact(kind, n):
    for jd, td in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        got = tgeom.make_axis(n, kind, td).numpy()
        np.testing.assert_array_equal(got, np.asarray(jgeom.make_axis(n, kind,
                                                                      jd)))


@pytest.mark.parametrize("guard", [True, False])
def test_power_chain_matches_jax(guard):
    rng = np.random.default_rng(2)
    x2, y2, z2 = rng.uniform(0, 2, (3, 50)) ** 2
    x2[:5] = 0.0  # exact zeros exercise the 1e-4 guard
    y2[3:8] = 0.0
    e1, e2 = 0.37, 0.81
    got = tgeom._power_chain(*(torch.from_numpy(v) for v in (x2, y2, z2)),
                             torch.tensor(e1, dtype=torch.float64),
                             torch.tensor(e2, dtype=torch.float64),
                             guard=guard)
    want = jgeom._power_chain(jnp.asarray(x2), jnp.asarray(y2),
                              jnp.asarray(z2), jnp.asarray(e1),
                              jnp.asarray(e2), guard=guard)
    close(got, want)


@pytest.mark.parametrize("guard", [True, False])
def test_field_grid_matches_jax(p64, guard):
    ax = jgeom.make_axis(16, "implicit", jnp.float64)
    want = jax.vmap(lambda pi: jgeom.field_grid(ax, ax, ax, pi,
                                                guard=guard))(
        jnp.asarray(p64))
    tax = tgeom.make_axis(16, "implicit", torch.float64)
    got = tgeom.field_grid(tax, tax, tax, torch.from_numpy(p64), guard=guard)
    assert got.shape == (6, 16, 16, 16)
    close(got, want)
    single = tgeom.field_grid(tax, tax, tax, torch.from_numpy(p64[0]),
                              guard=guard)
    close(single, want[0])


def test_rotated_frame_and_z_support_window(p64):
    a, e, tr, rot = tgeom.rotated_frame(torch.from_numpy(p64))
    ja, je, jtr, jrot = jax.vmap(jgeom._rotated_frame)(jnp.asarray(p64))
    close(tr, jtr)
    close(rot, jrot)
    for n_sweep in (48, 64):
        got = tgeom.z_support_window(a, rot, torch.from_numpy(p64[:, 5:8]),
                                     n_sweep)
        want = jgeom.z_support_window(ja, jrot, jnp.asarray(p64[:, 5:8]),
                                      n_sweep)
        for g, w in zip(got, want):
            close(g, w)


# ---- gauge -----------------------------------------------------------

def test_flip_orbit_and_gauge_orbit(p64):
    q = p64[:, 8:12]
    close(tlosses._flip_orbit(torch.from_numpy(q)),
          jlosses._flip_orbit(jnp.asarray(q)))
    close(tlosses.param_gauge_orbit(torch.from_numpy(p64)),
          jlosses.param_gauge_orbit(jnp.asarray(p64)))


def test_canonicalize_gauge(p64):
    p = p64.copy()
    p[:3, [0, 1]] = p[:3, [1, 0]]  # make sure both branches are taken
    got = tlosses.canonicalize_gauge(torch.from_numpy(p))
    close(got, jlosses.canonicalize_gauge(jnp.asarray(p)))
    assert bool((got[:, 0] >= got[:, 1]).all())


# ---- the plain renderer (the plain version of K3) --------------------

@pytest.mark.parametrize("n_sweep,n_bisect", [(64, 16), (48, 12)])
def test_plain_render_matches_jax(n_sweep, n_bisect):
    p = random_params(4, 4, np.float32)
    want = np.asarray(jrender.render_depth_hard_batch(
        jnp.asarray(p), 64, n_bisect=n_bisect, quantize=True,
        n_sweep=n_sweep))
    got = trender.render_depth_hard_batch(
        torch.from_numpy(p), 64, n_bisect=n_bisect, quantize=True,
        n_sweep=n_sweep).numpy()
    assert got.shape == want.shape == (4, 64, 64)
    assert levels_off(got, want) < 1e-3
    assert got.max() > 0.3  # something was rendered
    single = trender.render_depth_hard(torch.from_numpy(p[1]), 64,
                                       n_bisect=n_bisect, quantize=True,
                                       n_sweep=n_sweep).numpy()
    np.testing.assert_array_equal(single, got[1])


def test_plain_render_unquantized_is_continuous():
    p = torch.from_numpy(random_params(5, 2, np.float32))
    img = trender.render_depth_hard_batch(p, 32, n_bisect=12, n_sweep=48)
    img = img.numpy()
    assert img.min() >= 0 and img.max() <= 1
    assert ((img * 255) % 1 > 1e-3).any()  # not on the gray-level lattice
    assert (img == 0).any()                # background


def test_plain_render_matches_pallas_interpret(monkeypatch):
    """The plain version against the TPU kernel itself, run by Pallas in
    interpret mode on the CPU."""
    monkeypatch.setenv("SQTPU_PALLAS_INTERPRET", "1")
    from sqtpu.ops.kernels.hardrender import render_depth_hard_pallas

    p = random_params(6, 3, np.float32)
    want = np.asarray(render_depth_hard_pallas(
        jnp.asarray(p), 32, n_sweep=48, n_bisect=12, quantize=True))
    got = trender.render_depth_hard_batch(
        torch.from_numpy(p), 32, n_bisect=12, quantize=True,
        n_sweep=48).numpy()
    assert levels_off(got, want) < 1e-3
    assert got.max() > 0.3


# ---- metrics ---------------------------------------------------------

def test_iou_full_matches_jax():
    t = random_params(7, 5)
    p = t + np.random.default_rng(8).normal(0, 0.02, t.shape)
    p[:, 8:12] /= np.linalg.norm(p[:, 8:12], axis=-1, keepdims=True)
    want = np.asarray(jmetrics.iou_full(jnp.asarray(t), jnp.asarray(p), 32))
    got = tmetrics.iou_full(torch.from_numpy(t), torch.from_numpy(p), 32)
    assert got.shape == (5, 7)
    close(got, want)
    assert 0.3 < want[:, 1].mean() < 1.0  # a real overlap, not degenerate


@pytest.mark.parametrize("reduce", [True, False])
def test_iou_matches_jax(reduce):
    t, p = random_params(9, 20), random_params(10, 20)  # > one chunk
    want = jmetrics.iou(jnp.asarray(t), jnp.asarray(p), 24, reduce=reduce)
    close(tmetrics.iou(torch.from_numpy(t), torch.from_numpy(p), 24,
                       reduce=reduce), want)
    one = tmetrics.iou(torch.from_numpy(t), torch.from_numpy(t), 24)
    assert float(one) == 1.0


def test_angle_errors_gauge_and_mae():
    t, p = random_params(11, 8), random_params(12, 8)
    tt, tp = torch.from_numpy(t), torch.from_numpy(p)
    jt, jp = jnp.asarray(t), jnp.asarray(p)
    close(tmetrics.angle_error(tt[:, 8:], tp[:, 8:]),
          jmetrics.angle_error(jt[:, 8:], jp[:, 8:]))
    close(tmetrics.angle_error_sym(tt[:, 8:], tp[:, 8:]),
          jmetrics.angle_error_sym(jt[:, 8:], jp[:, 8:]))
    close(tmetrics.angle_error_gauge(tt, tp),
          jmetrics.angle_error_gauge(jt, jp))
    aligned, swapped = tmetrics.gauge_align(tt, tp)
    jal, jsw = jmetrics.gauge_align(jt, jp)
    close(aligned, jal)
    np.testing.assert_array_equal(swapped.numpy(), np.asarray(jsw))
    close(tmetrics.param_mae(tp, tt), jmetrics.param_mae(jp, jt))


# ---- synthetic parameters, held by their distribution ----------------

def test_sample_params_distribution():
    g = torch.Generator().manual_seed(0)
    p = sample_params(4000, g).numpy()
    assert p.shape == (4000, 12) and p.dtype == np.float32
    a, e, t, q = p[:, :3], p[:, 3:5], p[:, 5:8], p[:, 8:]
    assert a.min() >= 25 / 255 - 1e-6 and a.max() <= 75 / 255 + 1e-6
    assert e.min() >= 0.1 and e.max() <= 1.0
    assert t.min() >= 88 / 255 - 1e-6 and t.max() <= 168 / 255 + 1e-6
    assert (a[:, 0] >= a[:, 1]).all()          # canonical gauge
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-5)
    # the ranges are covered, not just respected
    assert a[:, 2].min() < 27 / 255 and a[:, 2].max() > 73 / 255
    assert abs(float(e.mean()) - 0.55) < 0.02
    assert abs(float(t.mean()) - 128 / 255) < 0.01
    raw = sample_params(4000, torch.Generator().manual_seed(0),
                        canonical=False).numpy()
    assert 0.4 < (raw[:, 0] >= raw[:, 1]).mean() < 0.6
    np.testing.assert_array_equal(
        tlosses.canonicalize_gauge(torch.from_numpy(raw)).numpy(), p)
