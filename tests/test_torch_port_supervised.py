"""The supervised slice of the port on the CPU: the explicit loss, the
quaternion and gauge-aware losses, the parameter MSE and the analytic
volume and inertia against the JAX package, and every loss branch of the
trainer that the port runs against ``sqtpu.training.loop._compute_loss``.

Inputs are made with numpy from a seed and handed to both packages, in
fp64. Values are held to rtol 1e-10 and gradients (torch autograd against
``jax.grad``) to rtol 1e-8 with atol 1e-12 of the gradient's scale: the
same arithmetic on both sides, only libm rounding and summation order
differ (the explicit loss sums (N+1)³ terms, the inertia takes lgamma from
another library).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu.ops import geometry as jgeom
from sqtpu.ops import losses as jlosses
from sqtpu.training import loop as jloop
from sqtpu.utils import config as jconfig
from sqtpu_torch.ops import geometry as tgeom
from sqtpu_torch.ops import losses as tlosses
from sqtpu_torch.training import loop as tloop
from sqtpu_torch.utils.config import TrainConfig

from test_torch_port_ops import _few_torch_threads, random_params  # noqa: F401

RTOL, GRAD_RTOL = 1e-10, 1e-8


def _close(got, want, rtol=RTOL, scale_atol=0.0):
    want = np.asarray(want)
    atol = scale_atol * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol)


def _value_and_grads(tfn, jfn, *arrays):
    """Both packages' value of fn(*arrays) and the gradient of a weighted
    sum of it with respect to every argument (the weights keep a
    per-sample output from hiding a sign)."""
    def weights(shape, mod):
        n = int(np.prod(shape))
        w = mod.arange(1, n + 1, dtype=mod.float64).reshape(shape)
        return w / n if n > 1 else 1.0

    def jsum(*xs):
        out = jfn(*xs)
        return jnp.sum(out * weights(out.shape, jnp))

    jv = np.asarray(jfn(*(jnp.asarray(a) for a in arrays)))
    jg = jax.grad(jsum, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = tfn(*ts)
    torch.sum(out * weights(tuple(out.shape), torch)).backward()
    return (out.detach().numpy(), [t.grad.numpy() for t in ts]), \
        (jv, [np.asarray(g) for g in jg])


def _check(tfn, jfn, *arrays):
    (tv, tg), (jv, jg) = _value_and_grads(tfn, jfn, *arrays)
    assert tv.shape == jv.shape
    _close(tv, jv)
    for got, want in zip(tg, jg):
        _close(got, want, GRAD_RTOL, 1e-12)
    return tv


def _pred_near(p: np.ndarray, seed: int, scale: float = 0.02) -> np.ndarray:
    return p + scale * np.random.default_rng(seed).normal(size=p.shape)


# ---- the explicit loss -------------------------------------------------

def test_occupancy_explicit_matches_jax():
    p = random_params(40, 3)
    p[0, 0] = 1.5  # outside the clamp box
    got = tlosses.occupancy_explicit(torch.from_numpy(p), 8, 20.0)
    assert got.shape == (3, 9, 9, 9)
    _close(got.numpy(), jlosses.occupancy_explicit(jnp.asarray(p), 8, 20.0))


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("sharp", [5.0, 10.0, 20.0])
@pytest.mark.parametrize("reduce", [True, False])
def test_explicit_loss_matches_jax(n, sharp, reduce):
    p = random_params(41 + n, 3)
    pred = _pred_near(p, 42 + n)
    v = _check(lambda t, q: tlosses.explicit_loss(t, q, n, reduce, sharp),
               lambda t, q: jlosses.explicit_loss(t, q, n, reduce, sharp),
               p, pred)
    assert np.all(v > 0)


# ---- quaternion, gauge and parameter losses ------------------------------

def _quats(seed: int, b: int) -> np.ndarray:
    q = np.random.default_rng(seed).normal(size=(b, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", ["quaternion_loss", "quaternion_loss_sym"])
@pytest.mark.parametrize("reduce", [True, False])
def test_quaternion_losses_match_jax(name, reduce):
    q_true = _quats(43, 5)
    q_pred = _quats(44, 5)
    q_pred[0] = -q_true[0] + 1e-3  # near the antipode
    _check(lambda a, b: getattr(tlosses, name)(a, b, reduce),
           lambda a, b: getattr(jlosses, name)(a, b, reduce), q_pred, q_true)


@pytest.mark.parametrize("reduce", [True, False])
def test_param_gauge_loss_matches_jax(reduce):
    labels = random_params(45, 5)
    pred = _pred_near(labels, 46, 0.05)
    # one prediction is the a1 <-> a2, Rz(90°) decomposition of its label
    pred[1] = np.asarray(jlosses.param_gauge_orbit(jnp.asarray(
        labels[1])))[4] + 1e-3
    _check(lambda a, b: tlosses.param_gauge_loss(a, b, reduce),
           lambda a, b: jlosses.param_gauge_loss(a, b, reduce), pred, labels)


@pytest.mark.parametrize("reduce", [True, False])
def test_rotation_moment_loss_matches_jax(reduce):
    labels = random_params(47, 5)
    q_pred = _quats(48, 5)
    _check(lambda a, b: tlosses.rotation_moment_loss(a, b, reduce),
           lambda a, b: jlosses.rotation_moment_loss(a, b, reduce),
           q_pred, labels)


@pytest.mark.parametrize("col_weight", [None, [1, 1, 1, 3, 3, 1, 1, 1]])
@pytest.mark.parametrize("reduce", [True, False])
def test_param_mse_matches_jax(col_weight, reduce):
    true = random_params(49, 4)[:, :8]
    pred = _pred_near(true, 50, 0.05)
    cw = None if col_weight is None else np.asarray(col_weight, np.float64)
    _check(lambda a, b: tlosses.param_mse(
               a, b, reduce, None if cw is None else torch.from_numpy(cw)),
           lambda a, b: jlosses.param_mse(
               a, b, reduce, None if cw is None else jnp.asarray(cw)),
           pred, true)


@pytest.mark.parametrize("fn", ["volume", "inertia"])
def test_volume_and_inertia_match_jax(fn):
    p = random_params(51, 6)
    _check(getattr(tgeom, fn), getattr(jgeom, fn), p)


def test_sphere_volume_and_inertia():
    p = torch.tensor([[0.3, 0.3, 0.3, 1.0, 1.0, 0.5, 0.5, 0.5, 0, 0, 0, 1]],
                     dtype=torch.float64)
    vol = float(tgeom.volume(p))
    assert vol == pytest.approx(4 / 3 * np.pi * 0.3 ** 3, rel=1e-12)
    np.testing.assert_allclose(tgeom.inertia(p).numpy(),
                               8 * np.pi * 0.3 ** 5 / 15, rtol=1e-12)


# ---- every ported loss branch of the trainer ----------------------------

# the c4c recipe's weights (runs/queue_r12.sh:44-53), at a size where the
# implicit branches stay cheap: 64² images, render size 16
BRANCH_CFG = dict(batch_size=4, image_size=64, render_size=16,
                  explicit_sharp=20.0, gauge_weight=2.0, elong_weight=1.5,
                  use_pallas=False)
BRANCHES = [
    ("explicit", {}), ("explicit_sym", {}), ("explicit_gauge", {}),
    ("param_mse", {}), ("supervised", {}), ("supervised_sym", {}),
    ("supervised_geo", {"geo_weight": 0.7}), ("supervised_gauge", {}),
    ("quaternion", {}), ("quaternion_sym", {}), ("implicit_sym", {}),
    ("implicit_gauge", {}),
    ("explicit_sym", {"shape_weight": 3.0, "elong_weight": 0.0}),
]


@pytest.fixture(scope="module")
def branch_batch():
    labels = random_params(52, 4)
    labels[0, :3] = [0.1, 0.28, 0.12]  # an elongated shape
    pred = _pred_near(labels, 53, 0.03)
    imgs = np.random.default_rng(54).uniform(0.05, 0.9, (4, 64, 64, 1))
    return pred, imgs, labels


@pytest.mark.parametrize("loss,extra", BRANCHES,
                         ids=[b[0] + ("_w" if b[1] else "") for b in BRANCHES])
def test_loss_branch_matches_jax(branch_batch, loss, extra):
    pred, imgs, labels = branch_batch
    kw = {**BRANCH_CFG, **extra, "loss": loss}
    jcfg = jconfig.TrainConfig(**kw)
    tcfg = TrainConfig(device="cpu", **kw)
    assert dataclasses.asdict(jcfg) == {
        k: v for k, v in dataclasses.asdict(tcfg).items() if k != "device"}
    ji, jl = jnp.asarray(imgs), jnp.asarray(labels)
    ti, tl = torch.from_numpy(imgs), torch.from_numpy(labels)
    (tv, (tg,)), (jv, (jg,)) = _value_and_grads(
        lambda p: tloop._compute_loss(tcfg, p, ti, tl),
        lambda p: jloop._compute_loss(jcfg, p, ji, jl), pred)
    _close(tv, jv)
    _close(tg, jg, GRAD_RTOL, 1e-12)
    assert np.abs(jg).max() > 0


def test_elong_weights_match_jax(branch_batch):
    _, _, labels = branch_batch
    for w in (0.0, 1.5):
        want = jloop._elong_weights(jconfig.TrainConfig(elong_weight=w),
                                    jnp.asarray(labels))
        got = tloop._elong_weights(TrainConfig(elong_weight=w),
                                   torch.from_numpy(labels))
        if w == 0.0:
            assert got is None and want is None
        else:
            _close(got.numpy(), want)
            assert float(got.mean()) == pytest.approx(1.0)


def test_unported_loss_raises_in_the_branch():
    """Every loss of the JAX package runs since Slice F (``keras_chamfer``:
    ``test_torch_port_keras.py``); a name it does not know raises its
    ValueError."""
    with pytest.raises(ValueError, match="unknown loss"):
        tloop._compute_loss(TrainConfig(loss="no_such_loss"),
                            torch.zeros(2, 12), torch.zeros(2, 8, 8, 1),
                            torch.zeros(2, 12))
    with pytest.raises(ValueError, match="unknown loss"):
        jloop._compute_loss(jconfig.TrainConfig(loss="no_such_loss"),
                            jnp.zeros((2, 12)), jnp.zeros((2, 8, 8, 1)),
                            jnp.zeros((2, 12)))
