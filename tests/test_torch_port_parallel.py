"""The port's column-slab loss K6 and its grid-sharded and data-parallel
implicit losses on the CPU, against the JAX package's.

* The emulation of K6 (K1/K2 launched on a column slab,
  ``implicit_sums_slab_emulated``) against
  ``sqtpu.ops.kernels.implicit.implicit_sums_pallas_slab`` run by Pallas
  in interpret mode, at n 16 and 32, slabs of n/2 and n/4 columns, at
  every x0, with and without the z window, with the tolerances of
  tests/test_torch_port_implicit.py: per-sample sums relative 1e-5, the
  params' gradient rtol 5e-3 with atol 1e-6 or 1e-4 of the gradient's
  scale, the image gradient rtol 1e-4 on noise images. The Pallas kernel
  takes a slab only when n·n_cols is a multiple of 128; the 16 × 4 slab is
  held against the JAX package's plain slab render
  (``sharded_losses.py:175-186``) with the same tolerances.
* The plain slab sums add up to the whole plane's (fp64, relative
  1e-12), and the card's dispatch sends a CPU tensor to them.
* ``implicit_loss_gridsharded`` over two gloo ranks spawned by
  ``sqtpu_torch.parallel.dryrun``, 'grid' 1×2 and 'data' 2×1, and
  ``implicit_loss_dp`` 2×1, in fp64, against the JAX package's
  ``implicit_loss_gridsharded`` on the conftest's 8-device CPU mesh and
  against ``losses.implicit_loss``: value relative 1e-12, gradient rtol
  1e-9 with atol 1e-12, as tests/test_parallel.py:37-56 hold the JAX one.
* ``check_slice`` takes ``n_grid=2`` and refuses a layout that the world
  size, the render size or the batch does not fit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sqtpu.ops import geometry as jgeometry
from sqtpu.ops import losses as jlosses
from sqtpu.ops.kernels import implicit as jimplicit
from sqtpu.ops.render import depth_from_axes as jdepth_from_axes
from sqtpu.parallel.mesh import make_mesh
from sqtpu.parallel.sharded_losses import (
    implicit_loss_gridsharded as jax_gridsharded,
)
from sqtpu_torch.ops import losses as tlosses
from sqtpu_torch.ops.image import nearest_resize
from sqtpu_torch.ops.kernels import implicit as K
from sqtpu_torch.ops.kernels import implicit_sums_slab_auto
from sqtpu_torch.ops.kernels import launch_counts, reset_launches
from sqtpu_torch.ops.render import render_depth_soft_batch
from sqtpu_torch.parallel import dryrun
from sqtpu_torch.utils.config import TrainConfig, check_slice

from test_torch_port_gpu import _batch, _params, grad_atol
from test_torch_port_ops import _few_torch_threads  # noqa: F401

TAU, SHARP = 1.5, 260.0


def _slab(img: np.ndarray, n: int) -> np.ndarray:
    """(B, H, W) images -> (B, n, n) resized to the lattice, numpy."""
    return nearest_resize(torch.from_numpy(img), (n, n)).numpy()


def _jax_slab(img_slab, p, x0, n, z_window, g):
    """Σ g·sums of the JAX slab and its gradients: the Pallas kernel where
    it takes the slab, else the plain slab render."""
    n_cols = img_slab.shape[-1]

    def f(pp, im):
        if (n * n_cols) % jimplicit.LANES == 0:
            sums = jimplicit.implicit_sums_pallas_slab(
                im, pp, jnp.asarray(x0, jnp.int32), n, TAU, SHARP,
                z_window=z_window)
        else:
            ax = jgeometry.make_axis(n, "implicit", dtype=pp.dtype)
            d = jax.vmap(lambda pi: jdepth_from_axes(
                ax[x0:x0 + n_cols], ax, ax, jgeometry.clamp_params(pi),
                TAU, SHARP, n))(pp)
            sums = jnp.sum(jnp.abs(im - d), axis=(1, 2))
        return jnp.sum(sums * g), sums

    (_, sums), (gp, gi) = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(p), jnp.asarray(img_slab))
    return np.asarray(sums), np.asarray(gp), np.asarray(gi)


def _port_slab(fn, img_slab, p, x0, n, z_window, g, dtype=torch.float32):
    tp = torch.tensor(p, dtype=dtype, requires_grad=True)
    ti = torch.tensor(img_slab, dtype=dtype, requires_grad=True)
    sums = fn(ti, tp, x0, n, TAU, SHARP, z_window=z_window)
    torch.sum(sums * torch.tensor(g, dtype=dtype)).backward()
    return sums.detach().numpy(), tp.grad.numpy(), ti.grad.numpy()


@pytest.mark.parametrize("n,n_cols", [(16, 8), (16, 4), (32, 16), (32, 8)])
@pytest.mark.parametrize("z_window", [True, False])
def test_slab_emulation_matches_pallas_interpret(monkeypatch, n, n_cols,
                                                 z_window):
    monkeypatch.setenv("SQTPU_PALLAS_INTERPRET", "1")
    p, img = _batch(200 + n + n_cols + int(z_window))
    full = _slab(img, n)
    g = np.random.default_rng(n * n_cols).uniform(0.5, 1.5, p.shape[0])
    g = g.astype(np.float32)
    moved = 0.0
    for x0 in range(0, n, n_cols):
        cols = np.ascontiguousarray(full[:, :, x0:x0 + n_cols])
        want = _jax_slab(cols, p, x0, n, z_window, g)
        got = _port_slab(K.implicit_sums_slab_emulated, cols, p, x0, n,
                         z_window, g)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=0,
                                   err_msg=f"x0={x0}")
        np.testing.assert_allclose(got[1], want[1], rtol=5e-3,
                                   atol=grad_atol(want[1]),
                                   err_msg=f"x0={x0}")
        np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=0,
                                   err_msg=f"x0={x0}")
        assert np.abs(want[2]).sum() > 0
        moved += np.abs(want[1]).sum()
    assert moved > 0  # a slab the shape does not reach has no gradient


def test_plain_slab_sums_add_up_to_the_plane():
    p = _params(np.random.default_rng(210), 3).astype(np.float64)
    p = torch.from_numpy(p)
    _, img = _batch(211, 3)
    small = nearest_resize(torch.from_numpy(img).double(), (16, 16))
    plane = K.implicit_sums_slab_plain(small, p, 0, 16)
    loss = tlosses.implicit_loss(torch.from_numpy(img).double(), p, 16)
    torch.testing.assert_close(plane.mean() / 256, loss, rtol=1e-12, atol=0)
    for n_cols in (8, 4, 5):
        parts = sum(K.implicit_sums_slab_plain(small[:, :, x0:x0 + n_cols],
                                               p, x0, 16)
                    for x0 in range(0, 16, n_cols))
        torch.testing.assert_close(parts, plane, rtol=1e-12, atol=0)


def test_slab_dispatch_and_checks_on_cpu():
    p = torch.from_numpy(_params(np.random.default_rng(212), 2))
    cols = torch.rand((2, 16, 4), generator=torch.Generator().manual_seed(0))
    reset_launches()
    got = implicit_sums_slab_auto(cols, p, 4, 16)
    torch.testing.assert_close(got, K.implicit_sums_slab_plain(cols, p, 4,
                                                               16))
    assert not any(launch_counts().values())
    for bad_x0 in (-1, 13):
        with pytest.raises(ValueError, match="not a slab"):
            implicit_sums_slab_auto(cols, p, bad_x0, 16)
    with pytest.raises(ValueError, match="slab must be"):
        implicit_sums_slab_auto(cols[:, :8], p, 0, 16)
    with pytest.raises(ValueError, match="params"):
        implicit_sums_slab_auto(cols, p[:, :8], 0, 16)


# ---- the grid-sharded and data-parallel losses over two ranks --------------

@pytest.fixture(scope="module")
def fp64_batch():
    """(B=4) fp64 params and soft-rendered 32² depth maps of the shifted
    params, as tests/test_parallel.py makes them."""
    p = _params(np.random.default_rng(213), 4).astype(np.float64)
    imgs = render_depth_soft_batch(torch.from_numpy(np.roll(p, 1, axis=0)),
                                   32).numpy()
    return imgs, p


LAYOUTS = [("grid", 1, 2), ("grid", 2, 1), ("dp", 2, 1)]


@pytest.fixture(scope="module")
def port_losses(fp64_batch):
    """The port's losses of each of LAYOUTS on two spawned gloo ranks."""
    plan = [(n_grid, dryrun.loss_job, {"batch": fp64_batch, "n": 16,
                                       "kind": kind})
            for kind, _, n_grid in LAYOUTS]
    return dryrun.spawn(2, plan)


@pytest.mark.parametrize("i", range(len(LAYOUTS)),
                         ids=[f"{k}_{d}x{g}" for k, d, g in LAYOUTS])
def test_sharded_losses_match_jax(fp64_batch, port_losses, i):
    imgs, p = fp64_batch
    kind, n_data, n_grid = LAYOUTS[i]
    mesh = make_mesh(n_data=n_data, n_grid=n_grid)
    jimgs, jp = jnp.asarray(imgs), jnp.asarray(p)
    want_plain, g_plain = jax.jit(jax.value_and_grad(
        lambda pp: jlosses.implicit_loss(jimgs, pp, 16, TAU, SHARP)))(jp)
    want_grid, g_grid = jax.jit(jax.value_and_grad(
        lambda pp: jax_gridsharded(jimgs, pp, mesh, 16, TAU, SHARP,
                                   use_pallas=False)))(jp)
    grad = np.zeros_like(p)
    for rank in port_losses:
        r = rank[i]
        assert r["loss"] == pytest.approx(float(want_grid), rel=1e-12)
        assert r["loss"] == pytest.approx(float(want_plain), rel=1e-12)
        grad[slice(*r["rows"])] = r["grad"]
    for want in (g_grid, g_plain):
        np.testing.assert_allclose(grad, np.asarray(want), rtol=1e-9,
                                   atol=1e-12)


# ---- the layout gate -------------------------------------------------------

def test_check_slice_takes_the_grid_axis(monkeypatch):
    for world in (2, 4):
        monkeypatch.setenv("WORLD_SIZE", str(world))
        check_slice(TrainConfig(n_grid=2, device="cpu"))
    check_slice(TrainConfig(n_grid=1, batch_size=32, device="cpu"))


@pytest.mark.parametrize("cfg,world,match", [
    (dict(n_grid=2), 3, "not a multiple of n_grid"),
    (dict(n_grid=2), 1, "not a multiple of n_grid"),
    (dict(n_grid=3, render_size=64), 3, "render_size 64 must divide"),
    (dict(n_grid=1, batch_size=6), 4, "batch_size 6 must divide"),
    (dict(n_grid=2, batch_size=3), 4, "batch_size 3 must divide")])
def test_check_slice_refuses_layouts_that_do_not_fit(monkeypatch, cfg,
                                                     world, match):
    monkeypatch.setenv("WORLD_SIZE", str(world))
    with pytest.raises(ValueError, match=match):
        check_slice(TrainConfig(device="cpu", **cfg))


def test_check_slice_reads_the_launchers_world(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="world size 3"):
        check_slice(TrainConfig(n_grid=2, device="cpu"))
    monkeypatch.setenv("WORLD_SIZE", "2")
    check_slice(TrainConfig(n_grid=2, device="cpu"))


def test_refine_layout_is_a_later_slice():
    """The refine-dp layout, ported with Slice D (its gate runs in
    tests/test_torch_port_parallel_dryrun.py): data-parallel explicit_sym
    on the JAX dryrun's corrector (one pass, 8 slabs), the base from the
    c4 artifact, the corrector at its identity init."""
    import torch

    from sqtpu_torch.models import IterativeSQ

    n_grid, spec = dryrun._layout_spec("refine-dp", 2, torch.device("cpu"))
    cfg = spec["cfg"]
    assert n_grid == 1 and cfg.model == "refine_sq" and cfg.use_pallas
    assert cfg.loss == "explicit_sym" and "dp_seed" in spec
    model = dryrun.build_resnet(spec["weights"], torch.device("cpu"),
                                cfg.model)
    assert isinstance(model, IterativeSQ)
    assert (model.n_refine, model.n_sweep) == (1, 8)
    base = dryrun.build_resnet(spec["weights"], torch.device("cpu"))
    for k, v in base.state_dict().items():
        assert torch.equal(model.base.state_dict()[k], v), k
    assert torch.count_nonzero(model.refine.delta.weight) == 0
