"""Slice F1 of the port on the CPU, against the JAX package: the 2019
losses and the ``keras_chamfer`` branch, the isometric data, the width-8
and width-4 evaluation protocols, the validation step's width branches,
and one train step of each Keras path (the 2019 nets and
``generic_sq``).

The 2019 losses in float64: values rtol 1e-10, gradients rtol 1e-8 with
atol 1e-12 of their scale (``test_torch_port_supervised.py``'s bounds).

A train step: the port's float32 step from weights made by flax's
``init`` and carried across, on one batch, against the JAX package's
computation of the same step in float64 (``use_pallas=False``; the JAX
package's own float32 step sits 1.7% of the largest gradient off its
float64 one in the first layer, by flax's one-pass batch variance, where
the port's sits 5e-6 off): the loss relative 1e-5, each tensor's gradient
within 2e-3 of its largest value or 1e-4 of the model's largest gradient,
whichever is larger (the second for the conv biases before a train-mode
BatchNorm, whose gradient is zero up to float32 rounding: measured up to
4.4e-5 of the model's largest), the BatchNorm statistics rtol 1e-5
(``test_torch_port_train.py``'s bounds). The validation step in float32
from the same init against the JAX package's: predictions atol 1e-5,
loss, accuracy and angle rel 1e-4.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu.data import synthetic as jsyn
from sqtpu.models import build_model as flax_build_model
from sqtpu.models import params_vector as flax_params_vector
from sqtpu.ops import losses as jlosses
from sqtpu.ops import render as jrender
from sqtpu.training import loop as jloop
from sqtpu.utils import config as jconfig
from sqtpu_torch.data import synthetic as tsyn
from sqtpu_torch.evaluate import eval_random
from sqtpu_torch.models import build_model
from sqtpu_torch.ops import losses as tlosses
from sqtpu_torch.training import loop as tloop
from sqtpu_torch.training.state import create_train_state
from sqtpu_torch.utils.checkpoint import _flax_name
from sqtpu_torch.utils.config import EvalConfig, TrainConfig

from test_torch_port_keras import carry, f64, to_torch_layout
from test_torch_port_ops import (  # noqa: F401
    _few_torch_threads, levels_off, random_params,
)
from test_torch_port_supervised import _check
from test_torch_port_weights import _flat_stats, _images

STEP_LOSS_RTOL, STEP_GRAD_SCALE, STEP_STATS_RTOL = 1e-5, 2e-3, 1e-5


# ---- the 2019 losses and the keras_chamfer branch ------------------------

def _keras_params(seed: int, b: int) -> np.ndarray:
    """Keras-normalized params, sample 0 at e1 = 0.1, e2 = 1 and a small
    size, where E's exponent passes the cap and the field the clip."""
    p = random_params(seed, b)
    p[:, 0:3] = p[:, 0:3] * 5.1 - 0.5
    p[0, 0:3] = [-0.48, -0.48, -0.3]
    p[0, 3:5] = [0.1, 1.0]
    return p


def test_keras_field_matches_jax_and_reaches_the_cap():
    p = _keras_params(60, 3)
    size = 24
    got = _check(lambda q: tlosses._keras_field(q, size),
                 lambda q: jax.vmap(lambda r: jlosses._keras_field(
                     r, size))(q), p)
    assert got.shape == (3, size, size, size)
    exponents = []
    exp = torch.exp
    with mock.patch.object(torch, "exp", lambda t: exponents.append(
            float(t.max())) or exp(t)):
        tlosses._keras_field(torch.from_numpy(p), size)
    assert exponents == [80.0]      # E's exponent reached its cap


def test_torch_to_keras_norm_matches_jax():
    p = random_params(61, 4)
    _check(tlosses.torch_to_keras_norm, jlosses.torch_to_keras_norm, p)


@pytest.mark.parametrize("clip", [0.0, 100.0])
def test_keras_occupancy_mse_matches_jax(clip):
    t = _keras_params(62, 3)
    pred = t + 0.02 * np.random.default_rng(63).normal(size=t.shape)
    _check(lambda a, b: tlosses.keras_occupancy_mse(a, b, 16, clip),
           lambda a, b: jlosses.keras_occupancy_mse(a, b, 16, clip), t, pred)


def test_keras_quaternion_loss_matches_jax():
    a, b = random_params(64, 5)[:, 8:], random_params(65, 5)[:, 8:]
    _check(tlosses.keras_quaternion_loss, jlosses.keras_quaternion_loss,
           a, b)


def test_keras_chamfer_branch_matches_jax():
    """The branch at 64³ with raw outputs outside the valid box, e at its
    lower bound 0.1 and an unnormalized quaternion: the clamp, the range
    penalty and the clip at 100 all active."""
    labels = random_params(66, 2)
    pred = labels + 0.05 * np.random.default_rng(67).normal(size=(2, 12))
    pred[0, 0], pred[0, 3], pred[1, 6] = 1.3, 0.1, -0.2
    pred[1, 8:] *= 1.7
    imgs = np.zeros((2, 8, 8, 1))
    jcfg = jconfig.TrainConfig(loss="keras_chamfer")
    tcfg = TrainConfig(loss="keras_chamfer", device="cpu")
    _check(lambda q: tloop._compute_loss(tcfg, q, torch.from_numpy(imgs),
                                         torch.from_numpy(labels)),
           lambda q: jloop._compute_loss(jcfg, q, jnp.asarray(imgs),
                                         jnp.asarray(labels)), pred)


# ---- the isometric data ----------------------------------------------------

def test_iso_sample_params_structure():
    """q is the JAX package's fixed (1,1,1,0)/√3 to the bit; the sizes
    are the reference's independent draws (no gauge canonicalization)."""
    gen = torch.Generator().manual_seed(0)
    p = tsyn.sample_params(512, gen, iso=True).numpy()
    want_q = np.asarray(jsyn.sample_params(jax.random.PRNGKey(0), 2,
                                           iso=True))[0, 8:]
    np.testing.assert_array_equal(p[:, 8:], np.broadcast_to(want_q, (512, 4)))
    assert (p[:, 0] < p[:, 1]).mean() > 0.3     # not canonicalized
    assert p[:, :3].min() >= 25 / 255 and p[:, :3].max() <= 75 / 255
    assert p[:, 3:5].min() >= 0.1 and p[:, 3:5].max() <= 1.0
    rot = tsyn.sample_params(512, torch.Generator().manual_seed(0)).numpy()
    assert (rot[:, 0] >= rot[:, 1]).all()       # rotation data are


def test_iso_make_batch_renders_the_iso_view():
    gen = torch.Generator().manual_seed(1)
    imgs, labels = tsyn.make_batch(gen, 3, 64, iso=True)
    assert imgs.shape == (3, 64, 64, 1) and labels.shape == (3, 12)
    want = np.asarray(jax.vmap(lambda q: jrender.render_depth_hard(
        q, 64, n_bisect=12, quantize=True, n_sweep=48))(
            jnp.asarray(labels.numpy())))
    assert levels_off(imgs[..., 0].numpy(), want) < 1e-3
    assert float(imgs.max()) > 0.3


# ---- evaluation protocols and the validation step's widths ---------------

def _eval(tmp_path, **kw):
    cfg = EvalConfig(ckpt_dir=str(tmp_path / "none"), n=4, batch_size=2,
                     acc_render_size=16, image_size=64, device="cpu",
                     out_dir=str(tmp_path), **kw)
    res = eval_random(cfg)
    with np.load(tmp_path / "accs.npz") as d:
        return res, {k: d[k] for k in d.files}


def test_eval_width8_pads_the_view_quaternion(tmp_path):
    res, got = _eval(tmp_path, model="keras_iso", iso=True)
    np.testing.assert_array_equal(got["pred_params"][:, 8:],
                                  got["true_params"][:, 8:])
    np.testing.assert_array_equal(got["true_params"][:, 8:],
                                  np.broadcast_to(got["true_params"][0, 8:],
                                                  (4, 4)))
    np.testing.assert_allclose(got["rot_iou"], 1.0)
    np.testing.assert_allclose(got["angle_sym"], 0.0, atol=1e-3)
    with pytest.raises(ValueError, match="--iso true"):
        _eval(tmp_path, model="keras_iso")
    with pytest.raises(ValueError, match="12-parameter"):
        _eval(tmp_path, model="keras_iso", iso=True, refine="lm")


def test_eval_width4_pads_the_true_blocks(tmp_path):
    res, got = _eval(tmp_path, model="generic_sq")
    np.testing.assert_array_equal(got["pred_params"][:, :8],
                                  got["true_params"][:, :8])
    np.testing.assert_allclose(
        np.linalg.norm(got["pred_params"][:, 8:], axis=-1), 1.0, rtol=1e-5)
    assert np.isfinite(res["angle_sym_mean"])


@pytest.fixture(scope="module")
def width_batch():
    labels = random_params(70, 3).astype(np.float32)
    return _images(71, 3, 64)[..., None], labels


@pytest.mark.parametrize("name,loss", [("generic_sq", "quaternion_sym"),
                                       ("keras_iso", "param_mse"),
                                       ("keras_rot_fixed", "explicit")])
def test_eval_step_width_branch_matches_jax(width_batch, name, loss):
    imgs, labels = width_batch
    kw = dict(batch_size=3, image_size=64, render_size=8,
              acc_render_size=16, loss=loss, model=name, use_pallas=False)
    jcfg = jconfig.TrainConfig(**kw, donate=False)
    jmodel = flax_build_model(name)
    jstate = jloop.create_train_state(jmodel, jax.random.PRNGKey(9), jcfg)
    jl, ja, jang, jpred = jloop.make_eval_step(jmodel, jcfg)(
        jstate, jnp.asarray(imgs), jnp.asarray(labels))
    port = carry({"params": jstate.params,
                  "batch_stats": jstate.batch_stats}, build_model(name, 64))
    tcfg = TrainConfig(**kw, device="cpu")
    tl, ta, tang, tpred = tloop.make_eval_step(
        create_train_state(port, tcfg), tcfg)(torch.from_numpy(imgs),
                                              torch.from_numpy(labels))
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), atol=1e-5)
    for got, want in ((tl, jl), (ta, ja), (tang, jang)):
        assert float(got) == pytest.approx(float(want), rel=1e-4, abs=1e-6)
    if name == "keras_iso":
        assert float(tang) == 0.0 and float(ta) < 0
    if name == "generic_sq":
        assert float(ta) == -float(tang)


# ---- one train step of each Keras path ------------------------------------

def step_vs_jax(name: str, imgs, labels, seed: int, init=None, **kw):
    """One float32 train step of ``name`` with ``kw`` from flax's init on
    the batch, the port's, against the JAX package's loss, gradients
    (global-norm clipped as the step clips them) and BatchNorm statistics
    of the same step computed in float64. ``init(variables, port)``, when
    given, changes both starts after the init is carried across (each
    package by its own code) and returns the flax variables."""
    kw = dict(batch_size=imgs.shape[0], image_size=imgs.shape[1],
              use_pallas=False, model=name, **kw)
    jcfg = jconfig.TrainConfig(**kw, donate=False)
    jmodel = flax_build_model(name)
    jstate = jloop.create_train_state(jmodel, jax.random.PRNGKey(seed), jcfg)
    ji, jl = jnp.asarray(imgs, jnp.float64), jnp.asarray(labels, jnp.float64)
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    port = carry(variables, build_model(name, imgs.shape[1]))
    if init is not None:
        variables = init(variables, port)
    stats = f64(variables["batch_stats"])

    def loss_fn(params):
        out, mutated = jmodel.apply(
            {"params": params, "batch_stats": stats}, ji,
            train=True, mutable=["batch_stats"])
        return jloop._compute_loss(jcfg, flax_params_vector(out), ji,
                                   jl), mutated

    (jloss, mutated), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(f64(variables["params"]))
    want = _flat_stats({"params": grads})
    if jcfg.grad_clip:
        norm = np.sqrt(sum(float(np.sum(np.square(g)))
                           for g in want.values()))
        want = {k: g * min(1.0, jcfg.grad_clip / norm)
                for k, g in want.items()}
    tcfg = TrainConfig(**kw, device="cpu")
    state = create_train_state(port, tcfg)
    loss = tloop.make_train_step(state, tcfg)(torch.from_numpy(imgs),
                                              torch.from_numpy(labels))
    assert float(loss) == pytest.approx(float(jloss), rel=STEP_LOSS_RTOL)
    scale = max(float(np.abs(g).max()) for g in want.values())
    for n, p in port.named_parameters():
        w = to_torch_layout(want[_flax_name(n, p.ndim)])
        # a conv bias before a train-mode BatchNorm has a zero gradient:
        # its float32 rounding noise is held against the model's largest
        atol = max(STEP_GRAD_SCALE * float(np.abs(w).max()), 1e-4 * scale)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=atol,
                                   err_msg=n)
    bufs = dict(port.named_buffers())
    for key, w in _flat_stats({"batch_stats": mutated["batch_stats"]}).items():
        path = key.split("/")
        got = bufs[".".join(path[1:-1]) + ".running_" + path[-1]]
        np.testing.assert_allclose(got.numpy(), w, rtol=STEP_STATS_RTOL,
                                   atol=1e-8, err_msg=key)
    return float(loss)


KERAS_PATHS = [
    # runs/queue_r17.sh:117-124 (the render size cut to 8 here)
    ("keras_rot_fixed", dict(loss="explicit", render_size=8,
                             learning_rate=1e-4, grad_clip=1.0)),
    # runs/queue.sh:42-50, iso data
    ("keras_iso", dict(loss="param_mse", learning_rate=1e-3, iso=True)),
    ("generic_sq", dict(loss="quaternion_sym")),
    ("keras_rot", dict(loss="keras_chamfer")),
]


@pytest.mark.parametrize("name,kw", KERAS_PATHS,
                         ids=[k[0] for k in KERAS_PATHS])
def test_train_step_matches_jax(name, kw):
    gen = torch.Generator().manual_seed(12)
    imgs, labels = tsyn.make_batch(gen, 4, 64, iso=kw.get("iso", False))
    loss = step_vs_jax(name, imgs.numpy(), labels.numpy(), 13, **kw)
    assert np.isfinite(loss) and loss > 0


REMAT_LOSSES = {"generic_sq": "quaternion_sym", "keras_iso": "param_mse",
                "keras_rot_fixed": "supervised", "resnet_sq6d": "supervised"}


@pytest.mark.parametrize("name", sorted(REMAT_LOSSES))
def test_remat_leaves_the_step_as_it_is(name):
    """``remat`` on every model, as the JAX package's ``jax.checkpoint``
    wraps any: one step with and without it from the same weights on the
    same batch gives the same loss, gradients and BatchNorm statistics
    (the statistics move once), to the bit on the CPU."""
    import copy

    imgs, labels = tsyn.make_batch(torch.Generator().manual_seed(18), 2, 64)
    torch.manual_seed(0)
    start = build_model(name, 64)
    runs = []
    for remat in (False, True):
        model = copy.deepcopy(start)
        cfg = TrainConfig(batch_size=2, image_size=64, loss=REMAT_LOSSES[name],
                          remat=remat, device="cpu")
        loss = tloop.make_train_step(create_train_state(model, cfg), cfg)(
            imgs, labels)
        runs.append((loss, {n: p.grad for n, p in model.named_parameters()},
                     dict(model.named_buffers())))
    (l0, g0, b0), (l1, g1, b1) = runs
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    for n in b0:
        assert torch.equal(b0[n], b1[n]), n
