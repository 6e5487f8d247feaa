"""The implicit loss of the port on the CPU: the soft renderer and the plain
loss against the JAX package, the kernels' torch side (frame scalars, z
window, image relayout) against the JAX wrapper's, the emulation of the
kernels' algorithm against autograd of the plain loss, the dispatch and
the wrapper's checks, and the synthetic batches.

Inputs are made with numpy from a seed and handed to both packages. fp64
comparisons use rtol 1e-10 for values and 1e-8 for gradients (the same
arithmetic, libm rounding and summation order only); the fp32 frame
scalars rtol 1e-6 (one einsum in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu.ops import image as jimage
from sqtpu.ops import losses as jlosses
from sqtpu.ops import render as jrender
from sqtpu.ops.kernels import implicit as jimplicit
from sqtpu_torch.data.synthetic import make_batch
from sqtpu_torch.ops import image as timage
from sqtpu_torch.ops import losses as tlosses
from sqtpu_torch.ops import render as trender
from sqtpu_torch.ops.kernels import _build, implicit_loss_auto
from sqtpu_torch.ops.kernels import launch_counts, reset_launches
from sqtpu_torch.ops.kernels import implicit as K
from sqtpu_torch.ops.kernels import sq_field as SF

from test_torch_port_ops import _few_torch_threads, random_params  # noqa: F401


def _img(seed: int, b: int, s: int, dtype=np.float64) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0.05, 0.9, (b, s, s)).astype(
        dtype)


# ---- image and soft render ------------------------------------------------

@pytest.mark.parametrize("src,dst", [((256, 256), (64, 64)),
                                     ((64, 48), (16, 16)),
                                     ((37, 53), (16, 24)),
                                     ((16, 16), (32, 32))])
def test_nearest_resize_is_bit_exact(src, dst):
    img = np.random.default_rng(0).uniform(size=(2,) + src)
    want = np.asarray(jimage.nearest_resize(jnp.asarray(img), dst))
    got = timage.nearest_resize(torch.from_numpy(img), dst).numpy()
    np.testing.assert_array_equal(got, want)


def _soft_render_record(request, p, got, want) -> str:
    """What a miss of ``test_soft_render_matches_jax`` leaves behind: the
    pixels off, their values, the JAX field along their rays, the test
    files this worker ran before, and the process state a file could
    change (torch's default dtype and flags, the main thread's
    flush-to-zero and denormals-are-zero modes, the JAX config)."""
    from sqtpu.ops import geometry as jgeometry

    tol = 1e-14 + 1e-10 * np.abs(want)
    bad = np.argwhere(np.abs(got - want) > tol)
    ax = jgeometry.make_axis(16, "implicit", dtype=jnp.float64)
    lines = []
    for b, i, j in bad[:8]:
        field = np.asarray(jgeometry.field_grid(
            ax, ax, ax, jgeometry.clamp_params(jnp.asarray(p[b])),
            guard=True))
        lines.append(f"  pixel ({b}, {i}, {j}): got {got[b, i, j]!r} want "
                     f"{want[b, i, j]!r}; field along the ray (both "
                     f"orientations) {field[j, 15 - i, :].tolist()} / "
                     f"{field[i, j, :].tolist()}")
    ran = sorted({item.nodeid.split("::")[0] for item in request.session.items
                  if getattr(item, "funcargs", {}) is None})
    tiny = np.float64(2.2250738585072014e-308)
    state = {
        "worker": os.environ.get("PYTEST_XDIST_WORKER", "main"),
        "files_run_before": ran,
        "torch_default_dtype": str(torch.get_default_dtype()),
        "torch_deterministic": torch.are_deterministic_algorithms_enabled(),
        "torch_threads": torch.get_num_threads(),
        "ftz": bool(tiny * np.float64(0.5) == 0.0),
        "daz": bool(np.float64(5e-324) * np.float64(1.0) == 0.0),
        "jax": {k: getattr(jax.config, k) for k in (
            "jax_enable_x64", "jax_default_matmul_precision",
            "jax_platforms", "jax_compilation_cache_dir")},
    }
    return (f"{len(bad)} pixels off:\n" + "\n".join(lines)
            + f"\nprocess state: {state}")


def test_soft_render_matches_jax(request):
    p = random_params(30, 3)
    want = np.asarray(jax.vmap(
        lambda pi: jrender.render_depth_soft(pi, 16, 1.5, 260.0))(
            jnp.asarray(p)))
    got = trender.render_depth_soft_batch(torch.from_numpy(p), 16, 1.5,
                                          260.0).numpy()
    assert got.shape == (3, 16, 16)
    try:
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)
    except AssertionError as exc:
        raise AssertionError(
            f"{exc}\n{_soft_render_record(request, p, got, want)}") from None
    one = trender.render_depth_soft(torch.from_numpy(p[1]), 16).numpy()
    np.testing.assert_allclose(one, want[1], rtol=1e-10, atol=1e-14)
    assert (got > 0.1).any() and (got.min() >= 0.0)


@pytest.mark.parametrize("reduce", [True, False])
def test_plain_loss_value_and_gradient_match_jax(reduce):
    p, img = random_params(31, 3), _img(31, 3, 40)

    def jloss(pp):
        out = jlosses.implicit_loss(jnp.asarray(img), pp, 16, 1.5, 260.0,
                                    reduce)
        return jnp.sum(out * jnp.arange(1, out.size + 1))

    want_v = np.asarray(jlosses.implicit_loss(jnp.asarray(img),
                                              jnp.asarray(p), 16, 1.5,
                                              260.0, reduce))
    want_g = np.asarray(jax.grad(jloss)(jnp.asarray(p)))
    tp = torch.tensor(p, requires_grad=True)
    out = tlosses.implicit_loss(torch.from_numpy(img), tp, 16, 1.5, 260.0,
                                reduce)
    torch.sum(out * torch.arange(1, out.numel() + 1)).backward()
    np.testing.assert_allclose(out.detach().numpy(), want_v, rtol=1e-10)
    np.testing.assert_allclose(tp.grad.numpy(), want_g, rtol=1e-8,
                               atol=1e-14)


def test_plain_loss_takes_nchw_images():
    p, img = random_params(32, 2), _img(32, 2, 32)
    t = torch.from_numpy(img)
    a = tlosses.implicit_loss(t, torch.from_numpy(p), 16)
    b = tlosses.implicit_loss(t[:, None], torch.from_numpy(p), 16)
    assert torch.equal(a, b)


# ---- the kernels' torch side against the JAX wrapper -----------------------

def test_frame_params_and_window_match_jax():
    p = random_params(33, 16, np.float32)
    p[0, 0], p[1, 3] = 1.5, 0.05          # outside the clamp box
    want = np.asarray(jimplicit._frame_params(jnp.asarray(p)))
    got = SF.frame_params(torch.from_numpy(p))
    assert got.shape == (16, SF.PAR_STRIDE) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    for n in (16, 64):
        jlo, jhi = jimplicit.z_window_indices(jnp.asarray(p), n)
        tlo, thi = K.z_window_indices(torch.from_numpy(p), n)
        np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
        assert (thi >= tlo).all() and thi.max() <= n - 1 and tlo.min() >= 0


@pytest.mark.parametrize("z_window", [True, False])
def test_pack_params_slots(z_window):
    p = torch.from_numpy(random_params(34, 4, np.float32))
    par = K.pack_params(p, 32, z_window, x0=5)
    assert par.shape == (4, 24) and par.is_contiguous()
    torch.testing.assert_close(par[:, :17], SF.frame_params(p)[:, :17],
                               rtol=0, atol=0)
    if z_window:
        lo, hi = K.z_window_indices(p, 32)
        assert torch.equal(par[:, SF.SLOT_JLO], lo)
        assert torch.equal(par[:, SF.SLOT_JHI], hi)
    else:
        assert (par[:, SF.SLOT_JLO] == 0).all()
        assert (par[:, SF.SLOT_JHI] == 31).all()
    assert (par[:, SF.SLOT_X0] == 5).all() and (par[:, 20:] == 0).all()


def test_image_plane_matches_jax_relayout():
    img = _img(35, 3, 64, np.float32)
    small = jimage.nearest_resize(jnp.asarray(img), (16, 16))
    want = np.asarray(jnp.flip(small, axis=-2).transpose(0, 2, 1).reshape(
        3, 256))
    got = K.image_plane(torch.from_numpy(img)[:, None], 16)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


# ---- the emulation against autograd of the plain loss ----------------------

def test_emulation_matches_autograd_of_plain_loss_fp64():
    """The analytic backward (W_j = Tacc − V + T_j, the 17-term chain)
    against autograd, full sweep in fp64: agreement to fp64 noise proves
    the backward's algebra."""
    p, img = random_params(36, 3), _img(36, 3, 40)
    tp = torch.tensor(p, requires_grad=True)
    ti = torch.tensor(img, requires_grad=True)
    got = K.implicit_loss_emulated(ti, tp, 16, z_window=False)
    got.backward()
    rp = torch.tensor(p, requires_grad=True)
    ri = torch.tensor(img, requires_grad=True)
    want = tlosses.implicit_loss(ri, rp, 16)
    want.backward()
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-12)
    np.testing.assert_allclose(tp.grad.numpy(), rp.grad.numpy(), rtol=1e-9,
                               atol=1e-14)
    np.testing.assert_allclose(ti.grad.numpy(), ri.grad.numpy(), rtol=1e-12,
                               atol=0)
    assert np.abs(ri.grad.numpy()).sum() > 0


def test_emulation_window_is_close_to_full_sweep_fp64():
    p, img = random_params(37, 4), _img(37, 4, 64)
    vals, grads = [], []
    for z_window in (True, False):
        tp = torch.tensor(p, requires_grad=True)
        loss = K.implicit_loss_emulated(torch.from_numpy(img), tp, 32,
                                        z_window=z_window)
        loss.backward()
        vals.append(loss.item())
        grads.append(tp.grad.numpy())
    np.testing.assert_allclose(vals[0], vals[1], rtol=1e-5)
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-4, atol=1e-7)


def test_emulation_slab_sums_add_up_to_the_plane():
    """x offset and column count (the slab mode K6 will use): the partial
    sums of two column slabs add up to the full plane's."""
    p = torch.from_numpy(random_params(38, 2, np.float32))
    n = 16
    img_xy = K.image_plane(torch.from_numpy(_img(38, 2, 32, np.float32)), n)
    full, _ = K.emulate_fwd(img_xy, K.pack_params(p, n), n, n, 1.5, 260.0)
    parts = []
    for x0, cols in ((0, 6), (6, 10)):
        par = K.pack_params(p, n, x0=x0)
        parts.append(K.emulate_fwd(img_xy[:, x0 * n:(x0 + cols) * n]
                                   .contiguous(), par, n, cols, 1.5,
                                   260.0)[0])
    torch.testing.assert_close(parts[0] + parts[1], full, rtol=1e-6,
                               atol=0)


# ---- dispatch and the wrapper's checks -------------------------------------

def test_cpu_tensor_goes_to_plain_loss():
    p = torch.from_numpy(random_params(39, 3, np.float32))
    img = torch.from_numpy(_img(39, 3, 32, np.float32))
    reset_launches()
    got = implicit_loss_auto(img, p, 16, 1.5, 260.0)
    assert torch.equal(got, tlosses.implicit_loss(img, p, 16, 1.5, 260.0))
    # float64 on the CPU is the plain loss too; only the card needs float32
    got64 = implicit_loss_auto(img.double(), p.double(), 16)
    assert got64.dtype == torch.float64
    assert not any(launch_counts().values())


@pytest.mark.parametrize("bad", ["1d", "width", "batch", "channels", "size"])
def test_loss_rejects_bad_shapes(bad):
    p = torch.from_numpy(random_params(40, 2, np.float32))
    img = torch.zeros((2, 32, 32))
    n = 16
    if bad == "1d":
        p = p[0]
    elif bad == "width":
        p = p[:, :11]
    elif bad == "batch":
        img = img[:1]
    elif bad == "channels":
        img = torch.zeros((2, 3, 32, 32))
    else:
        n = 1
    with pytest.raises(ValueError):
        implicit_loss_auto(img, p, n)


@pytest.mark.parametrize("bad", ["float64", "shape", "strided", "cpu",
                                 "size", "batch"])
def test_kernel_wrapper_checks_operands(bad):
    """What the wrappers check before any launch; all of it raises here on
    the CPU, where the last check refuses the device."""
    p = torch.from_numpy(random_params(41, 2, np.float32))
    n = 16
    img_xy = torch.zeros((2, n * n))
    par = K.pack_params(p, n)
    err = ValueError
    if bad == "float64":
        par, err = par.double(), TypeError
    elif bad == "shape":
        img_xy = img_xy[:, :-1]
    elif bad == "strided":
        img_xy = torch.zeros((2, 2 * n * n))[:, ::2]
    elif bad == "size":
        n = 1
    elif bad == "batch":
        par = par[:0]
    with pytest.raises(err):
        K.cuda_fwd(img_xy, par, n, n, 1.5, 260.0)
    with pytest.raises(err):
        K.cuda_bwd(img_xy, par, img_xy, torch.zeros(par.shape[0]), n, n,
                   1.5, 260.0)
    assert not any(launch_counts().values())


def test_source_is_plain_c_and_names_the_tpu_kernels():
    src = open(os.path.join(_build.CSRC_DIR, "implicit.cu")).read()
    assert 'extern "C"' in src and "torch/extension.h" not in src
    for fn in ("int sqtpu_implicit_fwd(", "int sqtpu_implicit_bwd(",
               "int sqtpu_implicit_blocks("):
        assert fn in src
    assert "sqtpu/ops/kernels/implicit.py::_fwd_kernel" in src
    assert "sqtpu/ops/kernels/implicit.py::_bwd_kernel" in src
    assert "atomicAdd" not in src  # deterministic reductions


def test_build_all_starts_every_source(monkeypatch):
    seen = []
    monkeypatch.setattr(_build, "build", lambda name: seen.append(name))
    _build.build_all(["hardrender", "implicit"])
    assert sorted(seen) == ["hardrender", "implicit"]

    def fail(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(_build, "build", fail)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build_all(["implicit"])


# ---- synthetic batches -------------------------------------------------------

@pytest.mark.parametrize("renderer", ["hard", "soft"])
def test_make_batch_renders_its_labels(renderer):
    gen = torch.Generator()
    gen.manual_seed(3)
    imgs, labels = make_batch(gen, 2, 32, renderer)
    assert imgs.shape == (2, 32, 32, 1) and labels.shape == (2, 12)
    if renderer == "hard":
        want = trender.render_depth_hard_batch(labels, 32, n_bisect=12,
                                               quantize=True, n_sweep=48)
    else:
        want = trender.render_depth_soft_batch(labels, 32, 1.5, 260.0)
    assert torch.equal(imgs[..., 0], want)
    assert float(imgs.max()) > 0.3


def test_make_batch_options_outside_the_slice():
    """``iso`` runs since Slice F (the fixed isometric view); an unknown
    renderer raises."""
    gen = torch.Generator()
    imgs, labels = make_batch(gen, 2, 32, iso=True)
    assert imgs.shape == (2, 32, 32, 1)
    torch.testing.assert_close(labels[:, 8:], torch.tensor(
        [[1.0, 1.0, 1.0, 0.0]] * 2) / 3.0 ** 0.5)
    with pytest.raises(ValueError):
        make_batch(gen, 2, 32, renderer="scanner")
