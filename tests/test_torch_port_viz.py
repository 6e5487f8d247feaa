"""The port's diagnostics (``sqtpu_torch.viz``) and the geometry and
quaternion helpers they need, against the JAX package's on the CPU in
float64; the fit's loss over the full lattice.

Inputs come from numpy generators with fixed seeds. Tolerances:

* ``slerp`` (its generic, dot < 0 and dot > 0.9995 branches),
  ``to_axis_angle``, ``to_euler`` and the seven geometry functions: rtol
  1e-12 (the same formulas; transcendental functions of two libraries);
* ``surface_angles``: the JAX package's ``jnp.arange`` to the bit, count
  included, in float32 and float64 (at n = 61 both give n + 1 angles);
* ``slerp_sweep`` at n = 16, render size 16: the angles and the explicit
  and quaternion losses 1e-10; the implicit loss 1e-8 (the soft render is
  summed in another order, ROADMAP.md Queue 3 item 1); the IoUs equal;
* ``turntable`` at 32², 4 views: the renderer's bound
  (``sqtpu/ops/geometry.py:400-402``), under 0.1% of pixels off by more
  than one gray level;
* ``fit_view``'s frames, 3 segments of 30 steps at N = 16, against the
  JAX package's ``gd_fit`` run in the same segments from the same start:
  rtol 1e-8 (the fit tests' bound, ``test_torch_port_fit.py``), the
  implicit fit with SGD (Adam is chaotic there, ROADMAP.md Queue 3);
* ``plot_grad_flow`` and ``plot_history``: the JAX package's names and
  numbers, and its dict, exactly.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu import fit as jfit
from sqtpu import viz as jviz
from sqtpu.ops import geometry as jgeo
from sqtpu.ops import quaternion as jquat
from sqtpu.utils import config as jconfig
from sqtpu_torch import fit as tfit
from sqtpu_torch import viz as tviz
from sqtpu_torch.ops import geometry as tgeo
from sqtpu_torch.ops import losses as tlosses
from sqtpu_torch.ops import quaternion as tquat
from sqtpu_torch.ops.kernels import explicit as KE
from sqtpu_torch.ops.kernels import implicit as KI
from sqtpu_torch.ops.render import render_depth_hard_batch
from sqtpu_torch.utils.config import FitConfig

from test_torch_port_ops import _few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12
# tests/test_tools.py:170-180's shape, and its fit's truth and start
SWEEP_P = np.array([0.18, 0.11, 0.26, 0.65, 0.15, 0.5, 0.5, 0.5,
                    -0.45, -0.24, 0.78, -0.35])
FIT_TRUE = np.array([0.18, 0.22, 0.15, 0.5, 0.7, 0.5, 0.45, 0.55,
                     0.2, -0.1, 0.3, 0.92])
FIT_DELTA = np.array([0.05, -0.04, 0.03, 0.1, -0.1, 0.04, -0.05, 0.03,
                      0, 0, 0, 0])


def _unit(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _close(got, want, rtol=RTOL, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def shape():
    """A superquadric and its surface angles, fp64."""
    rng = np.random.default_rng(0)
    p = np.r_[rng.uniform(0.1, 0.3, 3), rng.uniform(0.1, 1.0, 2),
              rng.uniform(0.3, 0.7, 3), _unit(rng.normal(size=4))]
    eta = rng.uniform(-np.pi / 2, np.pi / 2, (5, 7))
    omega = rng.uniform(-np.pi, np.pi, (5, 7))
    # exact zeros of the trigonometric terms: sgn(0) = 0, |0|^e = 0
    eta[0, 0], omega[0, 1], omega[0, 2] = 0.0, np.pi / 2, 0.0
    return p, eta, omega


# ---------------------------------------------------------------------------
# quaternion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("branch", ["generic", "antipodal", "parallel"])
def test_slerp_matches_jax(branch):
    rng = np.random.default_rng(1)
    q0, q1 = _unit(rng.normal(size=4)), _unit(rng.normal(size=4))
    q1 = q1 if np.dot(q0, q1) > 0 else -q1
    if branch == "antipodal":  # dot < 0: q1 is flipped
        q1 = -q1
    elif branch == "parallel":  # dot > 0.9995: the normalized lerp
        q1 = _unit(q0 + 1e-3 * rng.normal(size=4))
        assert np.dot(q0, q1) > 0.9995
    t = np.linspace(0.0, 1.0, 9)
    want = jquat.slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(t))
    got = tquat.slerp(_t(q0), _t(q1), _t(t))
    assert got.shape == (9, 4)
    _close(got, want)


@pytest.mark.parametrize("fn", ["to_axis_angle", "to_euler"])
def test_angle_conversions_match_jax(fn):
    q = _unit(np.random.default_rng(2).normal(size=(6, 4)))
    want = getattr(jquat, fn)(jnp.asarray(q))
    _close(getattr(tquat, fn)(_t(q)), want)
    if fn == "to_euler":  # the reference's quirk: theta is π
        np.testing.assert_allclose(np.asarray(want)[:, 1], np.pi)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

GEOMETRY = ["_spow", "surface_point", "surface_point_body", "surface_normal",
            "surface_normal_body", "map_eta_omega", "sample_surface",
            "pose_matrix", "pose_inverse"]


@pytest.mark.parametrize("fn", GEOMETRY)
def test_geometry_matches_jax(fn, shape):
    p, eta, omega = shape
    name, _, frame = fn.partition("_body")
    frame = "body" if fn.endswith("_body") else "world"
    if fn == "_spow":
        x = np.r_[-2.0, -0.5, 0.0, 0.3, 1.7]
        want = jgeo._spow(jnp.asarray(x), 0.4)
        got = tgeo._spow(_t(x), 0.4)
        assert float(got[2]) == 0.0
    elif name in ("surface_point", "surface_normal"):
        want = getattr(jgeo, name)(jnp.asarray(p), jnp.asarray(eta),
                                   jnp.asarray(omega), frame)
        got = getattr(tgeo, name)(_t(p), _t(eta), _t(omega), frame)
    elif fn == "map_eta_omega":
        pts = np.asarray(jgeo.surface_point(jnp.asarray(p), jnp.asarray(eta),
                                            jnp.asarray(omega)))
        want = np.stack(jgeo.map_eta_omega(jnp.asarray(pts),
                                           jnp.asarray(p)))
        got = torch.stack(tgeo.map_eta_omega(_t(pts), _t(p)))
    elif fn == "sample_surface":
        want = jgeo.sample_surface(jnp.asarray(p), 61, 16, jnp.float64)
        got = tgeo.sample_surface(_t(p), 61, 16, torch.float64)
    elif fn == "pose_matrix":
        pb = np.stack([p, np.r_[p[:8], _unit(p[8:] + 0.3)]])
        want = jgeo.pose_matrix(jnp.asarray(pb))
        got = tgeo.pose_matrix(_t(pb))
    else:
        m = np.asarray(jgeo.pose_matrix(jnp.asarray(p)))
        want = jgeo.pose_inverse(jnp.asarray(m))
        got = tgeo.pose_inverse(_t(m))
        _close(got @ _t(m), np.eye(4), atol=1e-15)
    assert tuple(got.shape) == np.asarray(want).shape
    _close(got, want, atol=1e-300)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [2, 17, 61, 64, 122, 197, 244])
def test_surface_angles_match_jax_to_the_bit(dtype, n):
    theta, gamma = tgeo.surface_angles(n, n, getattr(torch, dtype))
    jd = getattr(jnp, dtype)
    want_t = np.asarray(jnp.arange(-jnp.pi, jnp.pi, 2 * jnp.pi / n, dtype=jd))
    want_g = np.asarray(jnp.arange(-jnp.pi / 2, jnp.pi / 2, jnp.pi / n,
                                   dtype=jd))
    for got, want in ((theta, want_t), (gamma, want_g)):
        assert got.dtype == getattr(torch, dtype)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    if n in (61, 122, 197, 244):  # the float step's count
        assert theta.shape[0] == n + 1


def test_sample_surface_float32_angles(shape):
    """float32 angles with float64 params: the JAX package's promotion,
    its count, its values within float32's rounding of cos and sin."""
    p = shape[0]
    want = np.asarray(jgeo.sample_surface(jnp.asarray(p), 61, 16))
    got = tgeo.sample_surface(_t(p), 61, 16)
    assert got.dtype == torch.float64 and got.shape == want.shape
    _close(got, want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# viz: the numbers
# ---------------------------------------------------------------------------

def _sweep_inputs():
    p = SWEEP_P.copy()
    p[8:] = _unit(p[8:])
    q1 = _unit(np.random.default_rng(3).normal(size=4))
    return p, np.array([0.0, 0.0, 0.0, 1.0]), q1


@pytest.mark.parametrize("loss", ["explicit", "implicit", "quaternion"])
def test_slerp_sweep_matches_jax(loss, tmp_path):
    p, q0, q1 = _sweep_inputs()
    want = jviz.slerp_sweep(jnp.asarray(p), jnp.asarray(q0), jnp.asarray(q1),
                            loss, n=16, render_size=16)
    png = str(tmp_path / "sweep.png")
    got = tviz.slerp_sweep(_t(p), _t(q0), _t(q1), loss, n=16,
                           render_size=16, out_png=png)
    assert os.path.getsize(png) > 0
    assert all(g.shape == (16,) for g in got)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-10)
    np.testing.assert_allclose(got[1], want[1],
                               rtol=1e-8 if loss == "implicit" else 1e-10)
    np.testing.assert_array_equal(got[2], want[2])


def test_slerp_sweep_rejects_an_unknown_loss():
    p, q0, q1 = _sweep_inputs()
    with pytest.raises(ValueError):
        tviz.slerp_sweep(_t(p), _t(q0), _t(q1), "chamfer", n=4)


def test_implicit_wrapper_reduce_false_on_cpu():
    """``implicit_loss_cuda(reduce=False)`` on the CPU is the plain loss's
    per-sample values, and its mean the reduced loss."""
    rng = np.random.default_rng(4)
    p = np.c_[rng.uniform(0.1, 0.3, (3, 3)), rng.uniform(0.2, 1.0, (3, 2)),
              rng.uniform(0.35, 0.65, (3, 3)), _unit(rng.normal(size=(3, 4)))]
    img = render_depth_hard_batch(_t(p), 64, quantize=True)
    pred = _t(p + rng.normal(scale=0.02, size=p.shape))
    got = KI.implicit_loss_cuda(img, pred, 16, reduce=False)
    want = tlosses.implicit_loss(img, pred, 16, reduce=False)
    assert got.shape == (3,)
    assert torch.equal(got, want)
    _close(torch.mean(got), KI.implicit_loss_cuda(img, pred, 16))


def test_turntable_matches_jax(tmp_path):
    p = SWEEP_P.copy()
    p[8:] = _unit(p[8:])
    want = jviz.turntable(jnp.asarray(p), str(tmp_path / "j.png"), 4, 32)
    png = str(tmp_path / "t.png")
    got = tviz.turntable(_t(p), png, 4, 32)
    assert os.path.getsize(png) > 0
    assert got.shape == want.shape == (4, 32, 32)
    off = np.abs(np.round(got * 255) - np.round(want * 255)) > 1
    assert off.mean() < 1e-3
    assert got.max() > 0.3  # it rendered something


def _fit_case():
    p = FIT_TRUE.copy()
    p[8:] = _unit(p[8:])
    return p, p + FIT_DELTA


@pytest.mark.parametrize("loss,optimizer,lr", [("explicit", "adam", 5e-3),
                                               ("implicit", "sgd", 1e-3)])
def test_fit_view_frames_match_jax_segments(loss, optimizer, lr, tmp_path):
    """The explicit fit with tests/test_tools.py:27-41's Adam at 5e-3; the
    implicit fit with the default SGD: Adam at 5e-3 carries the two soft
    renders' 1e-13 gap to 8.6e-4 in 30 steps (ROADMAP.md Queue 3, ``gd``
    refinement), SGD keeps it at 4.5e-12."""
    p, p0 = _fit_case()
    kw = dict(loss=loss, render_size=16, steps=90, learning_rate=lr,
              optimizer=optimizer)
    img = render_depth_hard_batch(_t(p)[None], 256, n_bisect=12,
                                  quantize=True, n_sweep=256)[0]
    png = str(tmp_path / "fit.png")
    frames = tviz.fit_view(FitConfig(device="cpu", **kw), _t(p), png,
                           n_frames=3, p0=_t(p0), target_image=img)
    assert os.path.getsize(png) > 0
    seg = jconfig.FitConfig(**{**kw, "steps": 30})
    jp = jnp.asarray(p0)
    for frame in frames:
        jp, hist = jfit.gd_fit(seg, target_params=jnp.asarray(p),
                               target_image=jnp.asarray(img.numpy()), p0=jp)
        np.testing.assert_allclose(frame, np.asarray(jp), rtol=1e-8,
                                   atol=1e-12)


def test_fit_animation_writes_its_frames(tmp_path):
    p, p0 = _fit_case()
    cfg = FitConfig(loss="explicit", render_size=16, steps=40,
                    learning_rate=5e-3, optimizer="adam", device="cpu")
    html = str(tmp_path / "fit.html")
    last = tviz.fit_animation(cfg, _t(p), html, n_frames=4, p0=_t(p0))
    _, want, steps = tviz.fit_frames(cfg, _t(p), 4, _t(p0))
    assert last == want and steps == 10
    text = open(html).read()
    assert text.count("iVBOR") == 4  # four base64 PNGs
    assert last[-1] < last[0]


def test_fit_loss_is_the_full_lattice():
    """The fit's explicit loss is the plain loss over the whole (N+1)³
    lattice, as ``sqtpu/fit.py:42`` computes. The z-window the kernels can
    sweep instead (the emulation shows what K4 computes with it) drops
    the tails: at the fit's N = 32 and sharpness 5, from the truth + 0.02,
    its gradient sits ≥ 1e-4 of the largest component off the plain
    loss's on one of ``draw_truth_and_start``'s seeds 0-3 (measured
    5.7e-4, seed 0); over the full sweep it sits on it."""
    worst = 0.0
    for seed in range(4):
        cfg = FitConfig(seed=seed, device="cpu")
        tp = tfit.draw_truth_and_start(cfg)[0].double()
        start = (tp + 0.02)[None]

        def grad(fn):
            p = start.clone().requires_grad_(True)
            loss = fn(p)
            loss.backward()
            return loss.detach(), p.grad

        plain = grad(lambda p: tlosses.explicit_loss(tp[None], p, 32))
        closure = grad(tfit._loss_closure(cfg, target_params=tp))
        window = grad(lambda p: KE.explicit_loss_emulated(tp[None], p, 32))
        full = grad(lambda p: KE.explicit_loss_emulated(tp[None], p, 32,
                                                        z_window=False))
        scale = plain[1].abs().max()
        assert torch.equal(closure[0], plain[0])
        assert torch.equal(closure[1], plain[1])
        _close(full[0], plain[0], rtol=1e-10)
        assert float((full[1] - plain[1]).abs().max() / scale) < 1e-8
        worst = max(worst, float((window[1] - plain[1]).abs().max() / scale))
    assert worst >= 1e-4


# ---------------------------------------------------------------------------
# viz: gradient flow, history, plots
# ---------------------------------------------------------------------------

def test_grad_flow_matches_jax(tmp_path):
    """tests/test_tools.py:186-196's tree, and a module's gradients."""
    tree = {"layer1": {"kernel": np.ones((3, 3)) * 0.1,
                       "bias": np.ones((3,))},
            "layer2": {"kernel": np.ones((3, 3)) * 0.01}}
    want = jviz.plot_grad_flow(
        jax.tree_util.tree_map(jnp.asarray, tree), str(tmp_path / "j.png"))
    png = str(tmp_path / "t.png")
    got = tviz.plot_grad_flow(jax.tree_util.tree_map(_t, tree), png)
    assert os.path.getsize(png) > 0
    assert got[0] == want[0] == ["layer1/kernel", "layer2/kernel"]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])

    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 1))
    net(torch.ones(2, 3)).sum().backward()
    names, means, maxs = tviz.grad_flow(net)
    assert names == ["0/weight", "1/weight"]
    np.testing.assert_array_equal(
        maxs[1], net[1].weight.grad.abs().max().numpy())


def test_plot_history_matches_jax(tmp_path):
    """A port checkpoint's sidecar and a metrics JSONL."""
    from sqtpu_torch.training.state import create_train_state
    from sqtpu_torch.utils.checkpoint import save_checkpoint
    from sqtpu_torch.utils.config import TrainConfig

    history = {"train_loss": [0.5, 0.3, float("nan")],
               "val_loss": [0.6, 0.4, 0.35], "val_acc": [0.2, 0.5, 0.6]}
    state = create_train_state(torch.nn.Linear(2, 2), TrainConfig())
    ckpt = tmp_path / "run"
    save_checkpoint(str(ckpt / "last"), state, history, 3)
    jsonl = tmp_path / "train_metrics.jsonl"
    with open(jsonl, "w") as f:
        for i in range(3):
            f.write(json.dumps({"epoch": i, "train_loss": 1.0 / (i + 1),
                                "val_angle": 10.0 - i, "note": "x"}) + "\n")
    for src in (str(ckpt), str(jsonl)):
        want = jviz.plot_history(src, str(tmp_path / "j.png"))
        png = str(tmp_path / "t.png")
        got = tviz.plot_history(src, png)
        assert got == want and os.path.getsize(png) > 0
    with pytest.raises(FileNotFoundError):
        tviz.read_history(str(tmp_path))


@pytest.mark.parametrize("mode", tviz.PLOT_RENDER_MODES)
def test_voxel_scatter_writes_every_mode(mode, tmp_path):
    p = _fit_case()[0]
    png = str(tmp_path / f"vox_{mode}.png")
    tviz.voxel_scatter(_t(p), png, n=12, mode=mode)
    assert os.path.getsize(png) > 0


def test_voxel_field_matches_jax_and_bad_mode_raises(tmp_path):
    p = _fit_case()[0]
    f, grid = tviz.voxel_field(_t(p), 12)
    ax = jgeo.make_axis(12, "iou", dtype=jnp.float64)
    want = jgeo.field_grid(ax, ax, ax, jnp.asarray(p), guard=False)
    _close(f, want, rtol=1e-12)
    assert grid[0].shape == (12, 12, 12)
    with pytest.raises(ValueError, match="not in"):
        tviz.voxel_scatter(_t(p), str(tmp_path / "bad.png"), mode="solid")
    assert not os.path.exists(tmp_path / "bad.png")


def test_depth_grid_and_points_write(tmp_path):
    p = _fit_case()[0]
    img = render_depth_hard_batch(_t(p)[None], 64, quantize=True)
    tviz.depth_grid([img[0]], [img[0].numpy()], str(tmp_path / "grid.png"))
    tviz.plot_points(tgeo.sample_surface(_t(p), 16, 8),
                     str(tmp_path / "pts.png"), lims=(0.0, 1.0))
    assert os.path.getsize(tmp_path / "grid.png") > 0
    assert os.path.getsize(tmp_path / "pts.png") > 0


def test_importing_viz_loads_no_matplotlib():
    """The card's host has no matplotlib: the module imports without it
    and only the drawing reaches for it."""
    code = ("import sys, sqtpu_torch.viz, sqtpu_torch.tools.roofline_explicit,"
            " sqtpu_torch.tools.serve_bench, sqtpu_torch.tools.probe_keras2019;"
            " print(sorted(m for m in sys.modules"
            " if m.split('.')[0] in ('matplotlib', 'jax', 'sqtpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"
