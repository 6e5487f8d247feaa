"""Slice F1 of the port on the CPU, against the JAX package: the 13-block
encoder, the neck, the Block and 6D rotation heads, the rotation-only and
2019 Keras nets and ResNetSQ with the 6D head (the 2019 losses, the
data, the evaluation protocols and the train steps:
``test_torch_port_keras_train.py``).

Modules: flax's ``init`` makes the weights (float32), which are carried to
the port by ``state_dict_from_flax``; both sides then compute in float64
on the same numpy-made input. Outputs, batch statistics and parameter
gradients are held to rtol 1e-8 with an atol of 1e-10 of the largest
value (for gradients, the module's largest): the same arithmetic, only
summation order and libm differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu.models import build_model as flax_build_model
from sqtpu.models import encoders as jenc
from sqtpu.models import heads as jheads
from sqtpu.models import params_vector as flax_params_vector
from sqtpu_torch.models import (
    MODEL_REGISTRY, OUTPUT_DIMS, BlockHead, ConvEncoder, MLPNeck,
    Rotation6DHead, build_model, params_vector,
)
from sqtpu_torch.models.encoders import same_pads
from sqtpu_torch.utils.checkpoint import _flax_name, state_dict_from_flax

from test_torch_port_ops import _few_torch_threads  # noqa: F401
from test_torch_port_weights import _flat_stats, _images

RTOL, SCALE_ATOL = 1e-8, 1e-10


def carry(variables: dict, port: torch.nn.Module) -> torch.nn.Module:
    """flax variables -> the port module's weights, in place."""
    port.load_state_dict(state_dict_from_flax(_flat_stats(variables),
                                              port.state_dict()))
    return port


def to_torch_layout(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    return arr.T if arr.ndim == 2 else arr


def close(got, want, rtol=RTOL, scale_atol=SCALE_ATOL, err_msg=""):
    want = np.asarray(want)
    atol = scale_atol * float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol,
                               err_msg=err_msg)


def f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def hold_module(jmod, jcall, port, pcall, x, train: bool, seed: int):
    """``jmod``'s init carried to ``port``; the output of the weighted sum
    of the output, its gradient in every parameter, and (train mode) the
    BatchNorm statistics after the call, in float64 on both sides."""
    jx = jnp.asarray(x, jnp.float32)
    variables = jmod.init(jax.random.PRNGKey(seed), *jcall.init_args(jx))
    carry(variables, port)
    port = port.double().train(train)
    params = f64(variables["params"])
    stats = f64(variables.get("batch_stats", {}))

    def jfn(p):
        v = {"params": p, **({"batch_stats": stats} if stats else {})}
        out, mutated = jcall(jmod, v, jnp.asarray(x, jnp.float64), train)
        out = flax_params_vector(out)
        w = jnp.arange(1, out.size + 1, dtype=jnp.float64).reshape(
            out.shape) / out.size
        return jnp.sum(out * w), (out, mutated)

    (_, (jout, mutated)), jgrads = jax.jit(jax.value_and_grad(
        jfn, has_aux=True))(params)
    tout = pcall(port, torch.tensor(x, dtype=torch.float64))
    w = torch.arange(1, tout.numel() + 1, dtype=torch.float64).reshape(
        tout.shape) / tout.numel()
    torch.sum(tout * w).backward()
    close(tout.detach().numpy(), jout, err_msg="output")
    flat = _flat_stats({"params": jgrads})
    # a conv bias before a train-mode BatchNorm has a zero gradient: held
    # against the largest gradient of the module
    scale = max(float(np.abs(g).max()) for g in flat.values())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), to_torch_layout(flat[_flax_name(name, p.ndim)]),
            rtol=RTOL, atol=SCALE_ATOL * scale, err_msg=name)
    if train and stats:
        for key, want in _flat_stats(
                {"batch_stats": mutated["batch_stats"]}).items():
            buf = dict(port.named_buffers())[
                ".".join(key.split("/")[1:-1]) + ".running_"
                + key.split("/")[-1]]
            close(buf.numpy(), want, err_msg=key)
    return tout.detach().numpy()


class _Call:
    """How a flax module is called: with ``train`` or without, after
    ``init`` on ``init_args``."""

    def __init__(self, takes_train: bool):
        self.takes_train = takes_train

    def init_args(self, x):
        return (x, False) if self.takes_train else (x,)

    def __call__(self, mod, v, x, train):
        if self.takes_train:
            return mod.apply(v, x, train, mutable=["batch_stats"])
        return mod.apply(v, x), {}


def _nchw(port_fn):
    return lambda m, x: port_fn(m, x.permute(0, 3, 1, 2))


# ---- the modules -------------------------------------------------------

@pytest.mark.parametrize("activation", ["relu", "leaky_relu"])
@pytest.mark.parametrize("size", [64, 50])
@pytest.mark.parametrize("train", [False, True])
def test_conv_encoder_matches_flax(activation, size, train):
    """Even and odd sizes: 'SAME' pads (0, 1) and (1, 1) on the strided
    3x3s, (2, 3) and (3, 3) on the stem."""
    x = np.random.default_rng(size).uniform(0, 1, (2, size, size, 1))
    out = hold_module(
        jenc.ConvEncoder(activation=activation), _Call(True),
        ConvEncoder(activation),
        _nchw(lambda m, x: m(x).permute(0, 2, 3, 1)), x, train, 1)
    assert out.shape == (2, 2, 2, 256)


def test_same_pads_are_xlas():
    assert same_pads(256, 7, 2) == (2, 3) and same_pads(128, 3, 2) == (0, 1)
    assert same_pads(25, 3, 2) == (1, 1) and same_pads(64, 3, 1) == (1, 1)


def test_mlp_neck_matches_flax():
    x = np.random.default_rng(3).normal(size=(3, 2, 2, 256))
    hold_module(jenc.MLPNeck(), _Call(False), MLPNeck(2 * 2 * 256),
                _nchw(lambda m, x: m(x)), x, False, 2)


@pytest.mark.parametrize("head", ["block", "rot6d"])
def test_heads_match_flax(head):
    x = np.random.default_rng(4).normal(size=(5, 256))
    jmod, port = ((jheads.BlockHead(), BlockHead(256)) if head == "block"
                  else (jheads.Rotation6DHead(), Rotation6DHead(256)))
    out = hold_module(jmod, _Call(False), port, lambda m, x: m(x), x,
                      False, 3)
    if head == "rot6d":
        np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0,
                                   rtol=1e-12)


def test_rotation6d_is_the_identity_at_zero_logits():
    """Zero logits -> the identity quaternion; value and gradient finite,
    and both as the JAX package's."""
    x = np.zeros((2, 256))
    head = Rotation6DHead(256)
    out = hold_module(jheads.Rotation6DHead(), _Call(False), head,
                      lambda m, x: m(x), x, False, 5)
    np.testing.assert_array_equal(out, [[0, 0, 0, 1.0]] * 2)
    assert all(torch.isfinite(p.grad).all() for p in head.parameters())


NETS = ["resnet_sq6d", "generic_sq", "keras_iso", "keras_rot",
        "keras_rot_fixed"]


@pytest.mark.parametrize("name", NETS)
@pytest.mark.parametrize("train", [False, True])
def test_model_matches_flax(name, train):
    x = _images(6, 2, 64)[..., None].astype(np.float64)
    out = hold_module(
        flax_build_model(name), _Call(True), build_model(name, 64),
        lambda m, x: params_vector(m(x)),
        x, train, 7)
    assert out.shape == (2, OUTPUT_DIMS[name])


def test_registry_is_the_jax_packages():
    from sqtpu.models import MODEL_REGISTRY as JAX_REGISTRY
    from sqtpu.models import OUTPUT_DIMS as JAX_DIMS

    assert set(MODEL_REGISTRY) == set(JAX_REGISTRY)
    assert OUTPUT_DIMS == JAX_DIMS


def test_keras_rot_fixed_starts_neutral():
    """flax's kernel init variance_scaling(0.01): the port's own draw has
    std sqrt(0.01 / fan_in) within 3%, and the bias is (0, ..., 0, 1), so
    the first prediction sits at 0.5 and the identity."""
    torch.manual_seed(0)
    model = build_model("keras_rot_fixed", 64)
    w = model.out.weight.detach()
    assert float(w.std()) == pytest.approx(np.sqrt(0.01 / w.shape[1]),
                                           rel=0.03)
    np.testing.assert_array_equal(model.out.bias.detach().numpy(),
                                  [0.0] * 11 + [1.0])
    with torch.no_grad():
        pred = model.eval()(torch.from_numpy(_images(8, 2, 64)))
    assert float((pred[:, :8] - 0.5).abs().max()) < 0.05
    assert float((pred[:, 8:] - torch.tensor([0, 0, 0, 1.0])).abs().max()) \
        < 0.05
