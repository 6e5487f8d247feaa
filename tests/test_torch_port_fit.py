"""The port's direct fitting (``sqtpu_torch.fit``) against the JAX
package's ``sqtpu.fit`` on the CPU in float64, and its CLI.

Seeded inputs: the first recorded truths of ``runs/eval_c4c3`` rendered
by the port's plain renderer (both packages fit the same images), starts
perturbed from the truths with numpy's generator. Tolerances:

* ``moments_init`` rtol 1e-10 after the eigenvector sign rule: each
  eigenvector's largest component positive. torch's and jaxlib's LAPACK
  pick other signs for some samples (16 of the first 64 truths at n=32);
  with the rule applied to both they agree on all. An eigenvector's sign
  turns the superquadric by 180° about one of its axes, its own symmetry,
  so where the signs differ ``recover`` agrees with the JAX package's up
  to that symmetry: a, e, t rtol 1e-8, the quaternion rtol 1e-8 against
  the nearest of ±q·f over the four flips f;
* one LM iteration and 30 at n = 32 on 8 truths, residual ``sb`` and
  ``radial``, ``robust_c`` 0 and 4.685 (the robust cases on an even count
  of points, where the IRLS median averages the two middle values):
  params rtol 1e-8 with atol 1e-9 (1e-8 of the params' unit scale: a
  component near 0 is held to the vector's scale; measured: 6.9e-11 on
  a component of 1.7e-3), the costs rtol 1e-6;
* ``refine_params`` ``lm``, ``gd`` (10 Adam steps, n = 16) and ``lm+gd``
  (its 50 Adam steps at lr 1e-3): 1e-8. The two packages' implicit-loss
  gradients differ by 1e-13 to 6e-12 relative (the soft render summed in
  another order); Adam near a zero gradient component multiplies that by
  ~10^2.3 every 10 steps at the default lr 3e-3, so after lm+gd's 50
  steps one of these samples sits 1.5e-3 from the JAX package's (the
  JAX package on another machine would scatter as much): lm+gd's own
  steps are held at lr 1e-3, where the 50 steps stay within 1e-9;
* ``recover_multiview`` on one identity view against ``recover``: 1e-10,
  on tests/test_multiview.py:161-169's own shape (the lift (x − c) + c
  rounds, and LM carries that to 4e-11 in the JAX package and 7e-10 in
  the port on the first recorded truth);
* ``gd_fit`` with SGD and Adam from a given start: 1e-8.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu import fit as jfit
from sqtpu.ops import geometry as jgeo
from sqtpu.ops import quaternion as jquat
from sqtpu.utils import config as jconfig
from sqtpu_torch import fit as tfit
from sqtpu_torch.ops import render as trender
from sqtpu_torch.utils.config import FitConfig

from test_torch_port_ops import _few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRUTHS = os.path.join(ROOT, "runs", "eval_c4c3", "accs.npz")
# the SQ's D2 symmetry: the identity and the 180° turns about its axes
FLIPS = np.asarray([[0, 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]],
                   np.float64)


@pytest.fixture(scope="module")
def case():
    """8 truths, their 128² depth maps and starts near them, fp64."""
    with np.load(TRUTHS) as d:
        p = d["true_params"][:8].astype(np.float64)
    imgs = trender.render_depth_hard_batch(
        torch.from_numpy(p), 128, n_bisect=16, quantize=True,
        n_sweep=64).numpy()
    rng = np.random.default_rng(7)
    p0 = p + rng.normal(scale=0.02, size=p.shape)
    p0[:, 3:5] = np.clip(p0[:, 3:5], 0.12, 1.0)
    p0[:, 8:] /= np.linalg.norm(p0[:, 8:], axis=-1, keepdims=True)
    return p, imgs, p0


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _even_mask(mask: np.ndarray) -> np.ndarray:
    """The mask with its first point dropped where its count is odd."""
    mask = mask.copy()
    for m in mask:
        if int(m.sum()) % 2:
            m[np.flatnonzero(m)[0]] = 0.0
    assert all(int(m.sum()) % 2 == 0 for m in mask)
    return mask


def test_nanmedian_averages_the_middle_pair():
    x = torch.tensor([[1.0, np.nan, 3.0, 2.0], [4.0, 1.0, np.nan, 7.0],
                      [np.nan] * 4, [5.0, 2.0, 8.0, 1.0]])
    got = tfit.nanmedian(x).numpy()
    want = np.asarray(jnp.nanmedian(jnp.asarray(x.numpy()), axis=-1))
    np.testing.assert_array_equal(got[[0, 1, 3]], want[[0, 1, 3]])
    assert got[3] == 3.5 and np.isnan(got[2]) and np.isnan(want[2])
    assert tfit.nanmedian(x[3:]).item() != torch.nanmedian(x[3]).item()


def test_image_points_match_jax(case):
    _, imgs, _ = case
    pts, mask = tfit.image_points(_t(imgs), 32)
    for i in range(2):
        jp, jm = jfit.image_points(jnp.asarray(imgs[i]), 32)
        np.testing.assert_array_equal(pts[i].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(mask[i].numpy(), np.asarray(jm))


def _jax_canonical_moments(pts, mask):
    """The JAX package's moments_init (sqtpu/fit.py:132-144) with the
    port's eigenvector sign rule applied to jnp.linalg.eigh's vectors."""
    w = mask / jnp.maximum(jnp.sum(mask), 1.0)
    mean = jnp.sum(pts * w[:, None], axis=0)
    centered = pts - mean
    cov = (centered * w[:, None]).T @ centered
    eigval, R = jnp.linalg.eigh(cov)
    lead = jnp.take_along_axis(R, jnp.argmax(jnp.abs(R), axis=0)[None],
                               axis=0)
    R = jnp.where(lead < 0, -R, R)
    R = jnp.where(jnp.linalg.det(R) < 0, -R, R)
    a0 = jnp.clip(jnp.sqrt(jnp.maximum(3.0 * eigval, 1e-8)), jgeo.A_MIN,
                  jgeo.A_MAX)
    return jnp.concatenate([a0, jnp.ones(2, pts.dtype),
                            jnp.clip(mean, 0.0, 1.0), jquat.from_matrix(R)])


def test_moments_init_matches_jax_after_the_sign_rule(case):
    _, imgs, _ = case
    pts, mask = tfit.image_points(_t(imgs), 32)
    got = tfit.moments_init(pts, mask).numpy()
    want = np.stack([np.asarray(_jax_canonical_moments(
        jnp.asarray(pts[i].numpy()), jnp.asarray(mask[i].numpy())))
        for i in range(8)])
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)
    raw = np.stack([np.asarray(jfit.moments_init(
        jnp.asarray(pts[i].numpy()), jnp.asarray(mask[i].numpy())))
        for i in range(8)])
    np.testing.assert_allclose(got[:, :8], raw[:, :8], rtol=1e-10)
    _assert_same_up_to_flips(got, raw, 1e-10)


def _assert_same_up_to_flips(got: np.ndarray, want: np.ndarray, rtol):
    """Quaternions equal up to the D2 flips and the sign: each row of
    ``got`` against the nearest of ±want·f."""
    for g, w in zip(got, want):
        orbit = np.asarray(jquat.multiply(jnp.asarray(w[8:12])[None],
                                          jnp.asarray(FLIPS)))
        orbit = np.concatenate([orbit, -orbit])
        best = orbit[np.argmin(np.abs(orbit - g[8:12]).max(-1))]
        np.testing.assert_allclose(g[8:12], best, rtol=rtol,
                                   atol=min(rtol, 1e-9))


def _jax_lm(pts, mask, p0, iters, robust_c, residual):
    fn = jax.vmap(lambda x, m, p: jfit.lm_fit(
        x, m, p, iters, robust_c=robust_c, residual=residual))
    p, hist = fn(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(p0))
    return np.asarray(p), np.asarray(hist)


@pytest.mark.parametrize("iters", [1, 30])
@pytest.mark.parametrize("residual,robust_c", [
    ("sb", 0.0), ("sb", 4.685), ("radial", 0.0), ("radial", 4.685)])
def test_lm_fit_matches_jax(case, iters, residual, robust_c):
    _, imgs, p0 = case
    pts, mask = tfit.image_points(_t(imgs), 32)
    pts, mask = pts.numpy(), mask.numpy()
    if robust_c:
        mask = _even_mask(mask)
    want_p, want_h = _jax_lm(pts, mask, p0, iters, robust_c, residual)
    got_p, got_h = tfit.lm_fit(_t(pts), _t(mask), _t(p0), iters,
                               robust_c=robust_c, residual=residual)
    assert got_h.shape == (8, iters)
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=1e-8, atol=1e-9)
    # the costs: the IRLS weights (1 - u²)² near u = 1 magnify the params'
    # last bits (measured 4.0e-8 at 30 robust iterations)
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=1e-6,
                               atol=1e-14)
    assert np.all(got_h.numpy()[:, -1] < got_h.numpy()[:, 0] + 1e-15)


def test_lm_jacobian_is_forward_mode_of_the_residuals(case):
    """The batched jacfwd equals a central difference of the residuals."""
    _, imgs, p0 = case
    pts, mask = tfit.image_points(_t(imgs[:2]), 16)
    p = _t(p0[:2])
    J = torch.func.vmap(torch.func.jacfwd(
        lambda q, x, m: tfit._residuals(q, x, m, "sb")))(p, pts, mask)
    h = 1e-6
    for k in (0, 3, 6, 9):
        dp = torch.zeros_like(p)
        dp[:, k] = h
        fd = (tfit._residuals(p + dp, pts, mask, "sb")
              - tfit._residuals(p - dp, pts, mask, "sb")) / (2 * h)
        np.testing.assert_allclose(J[..., k].numpy(), fd.numpy(),
                                   atol=1e-6 * float(fd.abs().max()) + 1e-9)


@pytest.mark.parametrize("residual,robust_c,prefilter", [
    ("sb", 0.0, "none"), ("radial", 4.685, "median")])
def test_recover_matches_jax_up_to_the_symmetry(case, residual, robust_c,
                                               prefilter):
    _, imgs, _ = case
    want = np.stack([np.asarray(jfit.recover(
        jnp.asarray(im), 32, 30, robust_c=robust_c, prefilter=prefilter,
        residual=residual)[0]) for im in imgs])
    got, hist = tfit.recover(_t(imgs), 32, 30, robust_c=robust_c,
                             prefilter=prefilter, residual=residual)
    assert hist.shape == (8, 30)
    np.testing.assert_allclose(got[:, :8].numpy(), want[:, :8], rtol=1e-8,
                               atol=1e-9)
    _assert_same_up_to_flips(got.numpy(), want, 1e-8)


@pytest.mark.parametrize("method", ["lm", "gd", "lm+gd"])
def test_refine_params_matches_jax(case, method):
    _, imgs, p0 = case
    steps = 10 if method == "gd" else 5
    lr = 1e-3 if method == "lm+gd" else 3e-3
    want = np.asarray(jfit.refine_params(
        jnp.asarray(imgs[:4]), jnp.asarray(p0[:4]), method, steps, 16, lr))
    got = tfit.refine_params(_t(imgs[:4]), _t(p0[:4]), method, steps, 16,
                             lr)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-9)
    assert not np.allclose(got.numpy(), p0[:4])


def test_refine_gd_sweeps_the_full_lattice(case, monkeypatch):
    """``refine_params("gd")`` differentiates the full-lattice implicit
    loss, as ``sqtpu/fit.py:332`` does: through K1/K2's emulation (what
    the card computes) it passes ``z_window=False`` at every step and sits
    on the plain refinement. At the gd setting (64³, τ 1.5, sharpness
    260) a z-window moves the loss's value and gradient by float noise
    only (float64: ≤ 1.4e-13 of a sample's largest gradient component on
    c4's estimates of the first 125 truths, the full sweep's emulation
    as much; ``python tests/torch_port_pins.py gd_window``), so the route
    is what is pinned, and the window's gap is held below 1e-11."""
    from sqtpu_torch.ops import losses as tlosses
    from sqtpu_torch.ops.kernels import implicit as tK

    _, imgs, p0 = case
    x, q = _t(imgs[:4]), _t(p0[:4])
    steps, n = 5, 64
    want = tfit.refine_params(x, q, "gd", steps, n, 1e-3)
    seen = []

    def emulated(*args, z_window=True, **kw):
        seen.append(z_window)
        return tK.implicit_loss_emulated(*args, z_window=z_window, **kw)

    monkeypatch.setattr(tfit, "implicit_loss_auto", emulated)
    got = tfit.refine_params(x, q, "gd", steps, n, 1e-3)
    assert seen == [False] * steps
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-8,
                               atol=1e-9)
    assert not np.allclose(got.numpy(), p0[:4])

    def grad(fn):
        p = q.clone().requires_grad_(True)
        fn(p).sum().backward()
        return p.grad

    plain = grad(lambda p: tlosses.implicit_loss(x, p, n, reduce=False))
    window = grad(lambda p: tK.implicit_loss_emulated(
        x, p, n, z_window=True, reduce=False))
    gap = ((window - plain).abs().amax(1) / plain.abs().amax(1)).max()
    assert float(gap) < 1e-11


def test_multiview_identity_view_is_recover():
    q = jquat.random_uniform(jax.random.split(jax.random.PRNGKey(5), 1)[0],
                             (), jnp.float64)
    sq = np.concatenate([[60 / 255, 40 / 255, 75 / 255, 0.5, 0.9,
                          130 / 255, 120 / 255, 140 / 255], np.asarray(q)])
    ident = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float64)
    img = trender.render_depth_view(_t(sq), ident, 64)
    single, _ = tfit.recover(img, n_points=32, iters=40)
    multi, hist = tfit.recover_multiview(img, ident, n_points=32, iters=40)
    assert multi.shape == (12,) and hist.shape == (40,)
    np.testing.assert_allclose(multi.numpy(), single[0].numpy(), rtol=1e-10,
                               atol=1e-12)


def test_multiview_matches_jax(case):
    """Three posed views (tests/test_multiview.py:172-190) through both
    packages, the same images: the same fit up to the symmetry, and an
    IoU above the JAX test's 0.85."""
    from sqtpu_torch.ops.metrics import iou

    p = case[0][1]
    cams = np.asarray([[0.0, 0.0, 0.0, 1.0],
                       [0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4)],
                       [np.sin(np.pi / 4), 0.0, 0.0, np.cos(np.pi / 4)]])
    views = trender.render_depth_view(_t(p), _t(cams), 64)
    want, _ = jfit.recover_multiview(jnp.asarray(views.numpy()),
                                     jnp.asarray(cams), n_points=32,
                                     iters=40)
    got, _ = tfit.recover_multiview(views, _t(cams), n_points=32, iters=40)
    np.testing.assert_allclose(got[:8].numpy(), np.asarray(want)[:8],
                               rtol=1e-8, atol=1e-9)
    _assert_same_up_to_flips(got[None].numpy(), np.asarray(want)[None],
                             1e-8)
    assert float(iou(_t(p)[None], got[None], 64)) > 0.85


@pytest.mark.parametrize("loss,optimizer", [
    ("explicit", "sgd"), ("implicit", "adam"), ("leastsquares", "adam")])
def test_gd_fit_matches_jax(case, loss, optimizer):
    p, imgs, p0 = case
    kw = dict(loss=loss, optimizer=optimizer, steps=8, render_size=16,
              learning_rate=1e-2 if optimizer == "sgd" else 3e-3)
    target_img = imgs[0] if loss != "explicit" else None
    want, want_h = jfit.gd_fit(
        jconfig.FitConfig(**kw), target_params=jnp.asarray(p[0]),
        target_image=None if target_img is None else jnp.asarray(
            target_img), p0=jnp.asarray(p0[0]))
    got, got_h = tfit.gd_fit(
        FitConfig(device="cpu", **kw), target_params=_t(p[0]),
        target_image=None if target_img is None else _t(target_img),
        p0=_t(p0[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8,
                               atol=1e-9)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               rtol=1e-8, atol=1e-14)


def test_fit_config_has_the_jax_fields():
    jfields = {f.name: f.default for f in dataclasses.fields(
        jconfig.FitConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(FitConfig)}
    assert set(tfields) == set(jfields) | {"device"}
    assert {k: tfields[k] for k in jfields} == jfields


@pytest.mark.parametrize("argv,min_iou", [
    (["--optimizer", "lm"], 0.4),
    (["--optimizer", "lm", "--n-views", "4"], 0.85),
    (["--optimizer", "adam", "--loss", "implicit", "--steps", "30",
      "--render-size", "16"], 0.0),
    (["--optimizer", "sgd", "--loss", "explicit", "--steps", "10",
      "--render-size", "16"], 0.0)])
def test_fit_cli_on_cpu(argv, min_iou, capsys):
    p_fit, hist, iou = tfit.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "IoU" in out and "true:" in out
    assert p_fit.shape == (12,) and torch.isfinite(p_fit).all()
    assert np.isfinite(hist).all() and iou >= min_iou
    # the truth and the start do not depend on the device
    true_p, p0 = tfit.draw_truth_and_start(FitConfig())
    assert true_p.dtype == torch.float32 and p0.shape == (12,)
    assert torch.equal(true_p, tfit.draw_truth_and_start(FitConfig(
        device="cuda"))[0])


# ---- the entry points with refine and classical ------------------------------

WEIGHTS = os.path.join(ROOT, "artifacts", "resnet_sq_c4_fp16.npz")
C4R1 = os.path.join(ROOT, "artifacts", "refine_sq_c4r1_fp16.npz")
REFINE = dict(refine_steps=3, refine_size=16)


def _eval_inputs(accs):
    """The eval's images of its truths (the plain renderer at the eval
    setting, as eval_random renders them on the CPU)."""
    from sqtpu_torch.evaluate import EVAL_BISECT, EVAL_SWEEP

    with np.load(accs) as d:
        truths, preds = d["true_params"], d["pred_params"]
    imgs = trender.render_depth_hard_batch(
        torch.from_numpy(truths), 256, n_bisect=EVAL_BISECT, quantize=True,
        n_sweep=EVAL_SWEEP)
    return imgs, preds


@pytest.mark.parametrize("option", [
    {"refine": "lm"}, {"refine": "gd"}, {"refine": "lm+gd"},
    {"model": "classical"},
    {"model": "classical", "refine_robust_c": 4.685,
     "refine_filter": "median", "refine_residual": "radial"},
    {"model": "refine_sq", "ckpt_dir": C4R1},
    {"model": "refine_sq", "ckpt_dir": C4R1, "refine": "lm"}],
    ids=["lm", "gd", "lm+gd", "classical", "classical_robust", "refine_sq",
         "refine_sq_lm"])
def test_eval_random_runs_slice_d(option, tmp_path):
    """``eval_random`` n=2 with each Slice D option: its predictions are
    the model's (or the classical solve's) refined by ``refine_params``
    with the run's knobs, on the images it rendered."""
    from sqtpu_torch.evaluate import (
        classical_recover_fn, eval_random, load_eval_state, predict,
        refine_fn,
    )
    from sqtpu_torch.utils.config import EvalConfig

    cfg = EvalConfig(**{"ckpt_dir": WEIGHTS, **option}, n=2, batch_size=2,
                     acc_render_size=16, device="cpu",
                     out_dir=str(tmp_path), **REFINE)
    res = eval_random(cfg)
    assert np.isfinite(res["full_iou_mean"])
    imgs, preds = _eval_inputs(tmp_path / "accs.npz")
    with torch.inference_mode():
        if cfg.model == "classical":
            base = classical_recover_fn(cfg)(imgs)
        else:
            base = predict(load_eval_state(cfg, torch.device("cpu")),
                           imgs[..., None])
        want = refine_fn(cfg)(imgs, base).numpy()
    np.testing.assert_allclose(preds, want, rtol=0, atol=1e-6)
    if cfg.refine != "none":
        assert np.abs(want - base.numpy()).max() > 1e-5


def test_predict_serve_and_single_run_slice_d(tmp_path_factory):
    """``predict`` and ``SQServer`` with ``refine lm``, ``evaluate
    single`` with ``--model classical``: each gives ``refine_params`` of
    the model's prediction (or the classical solve) on its images."""
    import threading

    from sqtpu_torch.data.bmp import read_bmp, write_bmp
    from sqtpu_torch.evaluate import eval_single, load_eval_state, predict
    from sqtpu_torch.predict import predict_files
    from sqtpu_torch.serve import ServeClient, SQServer
    from sqtpu_torch.utils.config import (
        EvalConfig, PredictConfig, ServeConfig,
    )

    with np.load(TRUTHS) as d:
        truths = torch.from_numpy(d["true_params"][:3])
    imgs = trender.render_depth_hard_batch(truths, 256, n_bisect=16,
                                           quantize=True, n_sweep=64)
    d = tmp_path_factory.mktemp("bmps")
    files = []
    for i, im in enumerate(imgs):
        files.append(str(d / f"{i}.bmp"))
        write_bmp(files[-1], np.rint(im.numpy() * 255).astype(np.uint8))
    x = torch.from_numpy(np.stack([read_bmp(f) for f in files]).astype(
        np.float32) / 255.0)
    model = load_eval_state(EvalConfig(ckpt_dir=WEIGHTS), torch.device("cpu"))
    with torch.inference_mode():
        want = tfit.refine_params(x, predict(model, x[..., None]), "lm",
                                  **{"steps": 3, "n": 16}).numpy()
    got = predict_files(PredictConfig(ckpt_dir=WEIGHTS, refine="lm",
                                      batch_size=4, device="cpu", **REFINE),
                        files)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    sock = str(tmp_path_factory.mktemp("sq") / "s.sock")
    server = SQServer(ServeConfig(ckpt_dir=WEIGHTS, socket=sock,
                                  batch_size=2, device="cpu", refine="lm",
                                  **REFINE))
    acceptor = threading.Thread(target=server.serve_forever, daemon=True)
    acceptor.start()
    assert server.ready.wait(30)
    with ServeClient(sock, timeout_s=60) as c:
        for i in range(2):
            resp = c.predict(files[i])
            np.testing.assert_allclose(resp["params"], want[i], atol=1e-5)
        c.shutdown()
    acceptor.join(timeout=10)
    assert server.alive_threads() == []

    cfg = EvalConfig(model="classical", device="cpu", **REFINE)
    single = eval_single(cfg, files[0])
    with torch.inference_mode():
        solve = tfit.recover(x[:1], n_points=16, iters=3)[0][0].numpy()
    np.testing.assert_allclose(single, solve, rtol=0, atol=1e-6)
